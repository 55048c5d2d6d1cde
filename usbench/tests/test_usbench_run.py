"""A whole run, skipping only the look for a chip: the result line's keys,
a correct run of the program, and runs with the timed path broken, or the
control in its place, that the check must find not correct."""
import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import qups_tpu_torch as q
from usbench import harness, spec
from usbench.reference import das_at, elements, pixel_positions, plane_waves
from usbench.tests.conftest import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2 ** 31 + 12345


def _run(cell, trace=False, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter())[0]


@pytest.mark.parametrize("entry,frames", [("das_rf", 0), ("das_rf", 3), ("das_iq", 3),
                                          ("sim_das", 0)])
def test_the_program_runs_correct_with_the_result_keys(entry, frames):
    out = _run(tiny_cell(entry, frames, cell_name="picmus-speckle-sim"
                         if entry == "sim_das" else "picmus-rf-ensemble"))
    assert list(out) == KEYS + ["checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frames_per_s", "image_ms_p95", "setup_s"}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    c = out["checks"]["image_err"]
    assert c["value"] < c["limit"]
    json.dumps(out)


def test_a_traced_run_adds_the_window_and_breakdown():
    out = _run(tiny_cell("das_rf", 2), trace=True)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(out["metrics"]) <= {m["name"] for m in spec.benchmark()["per_layer"]}


def test_same_seed_same_inputs():
    from usbench import traffic

    cell = tiny_cell("das_rf", 2)
    a = traffic.make_inputs(cell.config, cell.traffic, SEED, "cpu")
    b = traffic.make_inputs(cell.config, cell.traffic, SEED, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


def _broken(monkeypatch, change):
    """UltrasoundSystem.DAS with ``change(img, chd, call)`` applied to its image."""
    real = q.UltrasoundSystem.DAS
    calls = []

    def das(self, chd, *a, **k):
        calls.append(1)
        return change(real(self, chd, *a, **k), chd, len(calls))

    monkeypatch.setattr(q.UltrasoundSystem, "DAS", das)


def test_an_altered_answer_is_not_correct(monkeypatch):
    # one request's image altered where it is produced (past the warm-up)
    _broken(monkeypatch, lambda img, chd, k: img * 1.01 if k == 4 else img)
    out = _run(tiny_cell("das_rf", 0))
    assert not out["correct"] and out["failed"] == 1


def test_an_image_of_the_wrong_shape_fails_its_request(monkeypatch):
    # one request's image with a frame missing: its sampled pixels cannot be
    # taken, the request fails and holds no slot of the sample
    _broken(monkeypatch, lambda img, chd, k: img[..., :1] if k == 4 else img)
    out = _run(tiny_cell("das_rf", 3))
    assert not out["correct"] and out["failed"] == 1
    assert out["checks"]["image_err"]["value"] < out["checks"]["image_err"]["limit"]


def test_an_altered_simulation_is_not_correct(monkeypatch):
    # every simulated acquisition's echoes altered where they are produced:
    # the check draws its requests from the seed, so every one is altered
    real = q.UltrasoundSystem.greens

    def greens(self, *a, **k):
        chd = real(self, *a, **k)
        return chd.replace(data=chd.data * 1.01)

    monkeypatch.setattr(q.UltrasoundSystem, "greens", greens)
    out = _run(tiny_cell("sim_das", 0, cell_name="picmus-speckle-sim"))
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("entry", ["das_rf", "das_iq"])
def test_half_the_ensemble_left_out_is_not_correct(monkeypatch, entry):
    # the frames of the second half imaged from the first half's traces
    def half(img, chd, k):
        F = img.shape[-1]
        return torch.cat([img[..., :F // 2], img[..., :F - F // 2]], -1)

    _broken(monkeypatch, half)
    out = _run(tiny_cell(entry, 4))
    assert not out["correct"] and out["failed"] == out["attempted"]


@pytest.mark.parametrize("cell_name,entry,frames", [
    ("headline-rf-cubic", "das_rf", 0), ("picmus-rf-ensemble", "das_rf", 3),
    ("picmus-iq-ensemble", "das_iq", 3)])
def test_the_control_in_the_programs_place_is_not_correct(monkeypatch, cell_name, entry,
                                                          frames):
    # the plain reference with its taps rounded to bfloat16, the traffic's
    # control, stands in for UltrasoundSystem.DAS at each cell's limit
    cell = tiny_cell(entry, frames, cell_name=cell_name)
    cfg = cell.config
    nz, nx = cfg["scan"]["z"][2], cfg["scan"]["x"][2]
    pix = pixel_positions(cfg, np.arange(nz * nx))

    def control(self, chd, fmod=0.0, **kw):
        x = chd.data
        T, N = x.shape[:2]

        def taps(m):
            xm = x[:, :, m].reshape(T, N, -1)
            if xm.is_complex():
                return torch.complex(xm.real.to(torch.bfloat16).double(),
                                     xm.imag.to(torch.bfloat16).double())
            return xm.to(torch.bfloat16).double()

        img = das_at(taps, pix, elements(cfg), plane_waves(cfg), T=T, t0=float(chd.t0),
                     c0=cfg["c0"], fs=cfg["fs"], fmod=fmod)
        img = img.to(torch.complex64 if img.is_complex() else torch.float32)
        return img.reshape((nz, nx, 1, 1, 1) + tuple(x.shape[3:]))

    monkeypatch.setattr(q.UltrasoundSystem, "DAS", control)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["image_err"]["value"] > out["checks"]["image_err"]["limit"]
    assert math.isfinite(out["checks"]["image_err"]["value"])


def test_the_simulations_control_is_not_correct():
    # the program on its own bfloat16 GEMM operands (the simulation's
    # control) at the cell's limit
    from usbench import traffic
    from usbench.control import control_reading
    from usbench.reference import geometry

    cell = tiny_cell("sim_das", 0, cell_name="picmus-speckle-sim")
    inputs = traffic.make_inputs(cell.config, cell.traffic, SEED, "cpu")
    idx = geometry.sample_pixels(cell.config, 60, np.random.default_rng(SEED))
    assert control_reading(cell, inputs, idx, "cpu", 2) > cell.limits["image_err"]["limit"]


def test_the_simulation_hands_das_complex_traces_of_its_own_length():
    # what the speckle cell's roofline counts: each request's DAS call as
    # the entry saw it, complex, on the simulated window, not the config's T
    cell = tiny_cell("sim_das", 0, cell_name="picmus-speckle-sim")
    run = harness.measure(cell, SEED, 0.2, False, "cpu", time.perf_counter())[0]
    das = [c for r in run.requests for c in r.calls.das]
    assert das and all(c["cplx"] and not c["rotate"] for c in das)
    assert {c["T"] for c in das} != {cell.config["T"]}
    g = run.requests[0].calls.greens[0]
    assert (g["S"], g["N"], g["M"]) == (32, 8, 8)


def test_the_checked_requests_are_a_sample_drawn_from_the_seed():
    from usbench.traffic import Reservoir

    def sample(seed, n=1000, k=16):
        r = Reservoir(k, seed)
        for i in range(n):
            r.slot(i)
        return sorted(r.index)

    a = sample(SEED)
    assert a == sample(SEED) and a != sample(SEED + 1)
    assert len(a) == 16 and max(a) > 500  # not the first k
    hits = np.zeros(100)
    for s in range(300):
        for i in sample(s, n=100, k=10):
            hits[i] += 1
    assert hits.min() > 0 and hits.max() < 3 * hits.mean()  # each request may be drawn


def test_no_card_no_result():
    # this process's torch has no CUDA: the command exits non-zero, prints nothing
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "-m", "usbench.run", "--workload", "headline-rf-cubic",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_a_small_cell_on_the_card(cuda_device):
    cell = tiny_cell("das_iq", 3)
    out = harness.run_cell(cell, SEED, 0.5, True, cuda_device, time.perf_counter())[0]
    assert out["correct"], out["checks"]
    assert {"system.host_ms", "kernel.das_roofline", "channel_data.dsp_ms"} <= set(
        out["metrics"])
    from usbench.control import control_reading
    from usbench import traffic
    from usbench.reference import geometry

    inputs = traffic.make_inputs(cell.config, cell.traffic, SEED, cuda_device)
    idx = geometry.sample_pixels(cell.config, 60, np.random.default_rng(SEED))
    assert control_reading(cell, inputs, idx, cuda_device) > cell.limits["image_err"]["limit"]
