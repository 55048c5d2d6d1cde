"""The end-to-end metrics are taken over all requests and all the window,
the frozen counts equal the kernel table's formulas, and the trace reader
reads device records, spans and idle gaps as it says."""
from types import SimpleNamespace

import numpy as np
import pytest

from usbench import spec, traffic
from usbench.counts import das, greens
from usbench.harness import Request, Run
from usbench.trace import TraceView


def _run(latencies, frames, ok=None, window_s=10.0):
    ok = ok or [True] * len(latencies)
    reqs, t = [], 0.0
    for lat, f, k in zip(latencies, frames, ok):
        reqs.append(Request(t, t + lat, f, k))
        t += lat
    return Run(spec.cell("headline-rf-cubic"), reqs, window_s, 3.0)


def test_p95_is_over_every_request():
    rng = np.random.default_rng(0)
    lat = list(rng.uniform(0.05, 0.1, 300)) + [2.0] * 20  # a slow tail of 20
    run = _run(lat, [1] * len(lat))
    got = spec.reader("image_ms_p95")(run)
    assert got == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert got > 1000.0  # the tail is in it, not a median of chunks


def test_rate_is_every_frame_over_the_whole_window():
    run = _run([0.1] * 50, [16] * 50, ok=[True] * 49 + [False], window_s=5.2)
    assert spec.reader("frames_per_s")(run) == pytest.approx(49 * 16 / 5.2)
    assert spec.reader("setup_s")(run) == 3.0


def test_counts_equal_the_kernel_table_at_the_headline():
    # PERF.md section 6: K1, 14 flop a real cubic term over 1024^2 x 256 x 256
    # terms, 14.359 ms; K1(b), 108 flop a term of the 4-frame IQ headline,
    # 110.772 ms (float32 peak 67 TFLOP/s)
    assert das.flops(1024 ** 2, 256, 256, 1, False, False) == 14 * 1024 ** 2 * 256 ** 2
    assert das.flops(1024 ** 2, 256, 256, 4, True, True) == 108 * 1024 ** 2 * 256 ** 2
    assert das.bound_s(1024 ** 2, 256, 256, 1, 4096, False, False) * 1e3 == pytest.approx(
        14.359, abs=5e-4)
    assert das.bound_s(1024 ** 2, 256, 256, 4, 1024, True, True) * 1e3 == pytest.approx(
        110.772, abs=5e-4)


def test_greens_counts_equal_the_kernel_table():
    # PERF.md section 6, K3(a): 8 F S N M / 67 TFLOP/s, 200.521 ms at 10^5
    # scatterers, 128 x 128 elements and 1025 bins
    assert greens.bound_s(1025, 10 ** 5, 128, 128) * 1e3 == pytest.approx(200.521, abs=5e-4)
    cfg = spec.load_json(spec.HERE / "configs" / "picmus-pw75.json")
    from usbench.reference import geometry

    corners = np.array([[-18e-3, 0, 10e-3], [18e-3, 0, 50e-3]], np.float32)
    td = cfg["transducer"]
    F = greens.band_bins(corners, geometry.elements(cfg), fc=td["fc"],
                         bw=(td["bw"][1] - td["bw"][0]) / td["fc"], fs=cfg["fs"], c0=cfg["c0"])
    assert 1 <= F <= 1025  # within the L = 2048 spectrum


def _ev(name, s, t, dev="CPU", thread=1, user=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=t),
                           device_type=SimpleNamespace(name=dev), thread=thread,
                           is_user_annotation=user)


def test_trace_view_reads_device_records_spans_and_gaps():
    ev = [
        _ev("usbench.window", 0, 100),
        _ev("usbench.request", 0, 50), _ev("usbench.entry", 0, 40),
        _ev("aten::copy_", 5, 15), _ev("cudaMemcpyAsync", 16, 19),
        _ev("cudaStreamSynchronize", 30, 45, thread=2),  # partly past the entry
        _ev("usbench.request", 50, 100), _ev("usbench.dsp", 50, 60),
        _ev("usbench.dsp", 52, 58, dev="CUDA", user=True),
        _ev("void layout_kernel<1>(float const*)", 20, 22, dev="CUDA"),
        _ev("void das_kernel<0, 1>(QArgs)", 22, 40, dev="CUDA"),
        _ev("Memcpy DtoH (Device -> Pageable)", 40, 42, dev="CUDA"),
        _ev("void fft_kernel", 53, 57, dev="CUDA"),
        _ev("void das_frames_kernel<1>(QArgs)", 60, 95, dev="CUDA"),
        _ev("void late", 99, 120, dev="CUDA"),  # clipped to the window
    ]
    tv = TraceView(ev)
    assert tv.window_us == 100
    assert tv.busy_us == 2 + 18 + 2 + 4 + 35 + 1
    assert tv.device_us(lambda n: "layout_kernel" in n) == 2
    assert tv.range_device_us("usbench.dsp") == 4
    assert tv.range_device_us("usbench.nothing") is None
    assert tv.host_us("usbench.entry") == 40 - 3 - 10  # the waits taken out
    assert tv.host_us("usbench.nothing") is None
    gaps = tv.gaps()
    assert gaps[0] == (0, 20) and (95, 99) in gaps
    bd = tv.breakdown()
    assert bd["device_ops"][0][0].startswith("void das_frames_kernel")
    labels = dict(bd["idle_gaps"])
    assert labels["usbench.entry > aten::copy_"] == pytest.approx(20e-6)
    run = SimpleNamespace(trace=tv, requests=[1, 2])
    assert spec.reader("device.idle_pct")(run) == pytest.approx(100 - 62)
    assert spec.reader("system.copy_ms")(run) == pytest.approx(1e-3)
    assert spec.reader("channel_data.dsp_ms")(run) == pytest.approx(2e-3)
    assert spec.reader("das_cuda.layout_ms")(run) == pytest.approx(1e-3)
    assert spec.reader("system.host_ms")(run) == pytest.approx(13.5e-3)


def test_a_range_without_its_device_span_reads_nothing():
    # the host side of usbench.dsp alone: no device-side span, no number
    tv = TraceView([_ev("usbench.window", 0, 100), _ev("usbench.dsp", 10, 20),
                    _ev("void fft_kernel", 12, 18, dev="CUDA")])
    assert tv.range_device_us("usbench.dsp") is None
    run = SimpleNamespace(trace=tv, requests=[1])
    assert spec.reader("channel_data.dsp_ms")(run) is None


def _das_request(cfg, T, F, cplx, fmod):
    import torch

    calls = traffic.Calls()
    shape = (T, cfg["transducer"]["numel"], cfg["sequence"]["angles_deg"][2]) + \
        ((F,) if F else ())
    calls.das_call(cfg, torch.empty(shape, dtype=torch.complex64 if cplx else torch.float32,
                                    device="meta"), fmod)
    return Request(0, 1, max(F, 1), True, calls)


def test_roofline_is_least_time_over_kernel_time():
    ev = [_ev("usbench.window", 0, 2e6),
          _ev("void das_kernel<0, 1>(QArgs)", 0, 75_000, dev="CUDA"),
          _ev("void das_keep_kernel<1>(QArgs)", 75_000, 90_000, dev="CUDA")]
    cell = spec.cell("headline-rf-cubic")
    run = Run(cell, [_das_request(cell.config, 4096, 0, False, 0.0)], 1.0, 1.0,
              TraceView(ev))
    got = spec.reader("kernel.das_roofline")(run)
    assert got == pytest.approx(100 * 14.359293646 / 75.0)
    run.trace = TraceView(ev[:1])
    assert spec.reader("kernel.das_roofline")(run) is None  # nothing to read: no number


def test_the_speckle_cells_bound_counts_the_complex_traces_it_was_handed():
    # sim_das hands DAS complex traces of the simulation's own length: the
    # bound counts 21 flop a term (7 + the complex cubic 12 and sum 2) and
    # 8 bytes a sample, whatever the configuration's T
    cell = spec.cell("picmus-speckle-sim")
    cfg = cell.config
    ev = [_ev("usbench.window", 0, 2e6), _ev("void das_kernel<1, 2>(QArgs)", 0, 5000,
                                             dev="CUDA")]
    run = Run(cell, [_das_request(cfg, 1000, 0, True, 0.0)], 1.0, 1.0, TraceView(ev))
    terms = 512 ** 2 * 128 * 75
    want = max(21 * terms / 67e12, (1000 * 128 * 75 * 8 + 512 ** 2 * 8) / 3.35e12)
    assert spec.reader("kernel.das_roofline")(run) == pytest.approx(100 * want / 5e-3)
    real = Run(cell, [_das_request(cfg, 1000, 0, False, 0.0)], 1.0, 1.0, TraceView(ev))
    assert spec.reader("kernel.das_roofline")(real) == pytest.approx(
        100 * 14 * terms / 67e12 / 5e-3)
