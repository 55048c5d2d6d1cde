"""One run of one cell: set-up, the measured window, the check, the result.

Closed loop, one request in flight, requests back to back: request i
images input i mod the inputs' number; its time runs from the entry call
to the image on the host. The window opens after the warm-up and stops
taking new requests once ``seconds`` have passed; it closes when the last
request ends. In the window the benchmark copies only the checked pixels of
a sample of the requests drawn from the seed (``traffic.Reservoir``) into a
buffer made in set-up, and keeps no image: a kept image would hold host
memory the program's next allocations then fault in afresh. ``setup_s`` runs from the process's start
(``t_start``) to the window's opening. With ``trace`` the window runs under
``torch.profiler`` (host and device), read in memory once it has closed.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, spec, traffic
from .reference import geometry
from .trace import TraceView, WINDOW

WARM_REQUESTS = 2


@dataclass
class Request:
    t_submit: float
    t_done: float
    frames: int
    ok: bool
    calls: traffic.Calls = field(default_factory=traffic.Calls)

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    cell: spec.Cell
    requests: list
    window_s: float
    setup_s: float
    trace: TraceView = None
    errors: list = field(default_factory=list)

    @property
    def frames_ok(self) -> int:
        return sum(r.frames for r in self.requests if r.ok)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float):
    """Set up, run the window and close it. Returns (run, inputs, checked
    pixel indices, the sampled requests' checked values by request, memory
    peak)."""
    cfg, trf = cell.config, cell.traffic
    inputs = traffic.make_inputs(cfg, trf, seed, device, cell.base)
    idx = geometry.sample_pixels(cfg, trf["check_pixels"], np.random.default_rng(seed))
    us = traffic.build_system(cfg)
    request = traffic.request_fn(cfg, trf, us, device, base=cell.base)
    for k in range(WARM_REQUESTS):
        img = request(inputs[k % len(inputs)], traffic.Calls())
    _sync(device)
    nframes = traffic.frames(trf)
    keep = traffic.Reservoir(trf["check_requests"], seed)
    checked = np.empty((keep.k, len(idx), nframes), img.numpy().dtype)
    checked.fill(0)  # its pages faulted in now, not in the window
    img = None
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    requests, errors = [], []
    gc.collect()
    gc.freeze()  # a collection in the window walks none of the set-up's objects
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    with torch.profiler.record_function(WINDOW):
        i = 0
        while i == 0 or time.perf_counter() - w0 < seconds:
            calls, j = traffic.Calls(), None
            t = time.perf_counter()
            try:
                with torch.profiler.record_function("usbench.request"):
                    img = request(inputs[i % len(inputs)], calls)
                t_done = time.perf_counter()
                j = keep.slot(i)
                if j is not None:
                    np.take(img.numpy().reshape(-1, nframes), idx, axis=0, out=checked[j])
                ok = True
            except Exception as exc:  # a failed request is counted, the loop goes on
                t_done = time.perf_counter()
                errors.append(f"request {i}: {exc!r}")
                ok = False
                if j is not None:
                    keep.index[j] = None
            img = None
            requests.append(Request(t, t_done, nframes, ok, calls))
            i += 1
        window_s = requests[-1].t_done - w0
    gc.unfreeze()
    view = None
    if prof is not None:
        _sync(device)
        prof.stop()
        view = TraceView(prof.events())
        del prof
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    values = {i: checked[j] for j, i in enumerate(keep.index) if i is not None}
    del request, us
    return Run(cell, requests, window_s, setup_s, view, errors), inputs, idx, values, peak


def judge(cell: spec.Cell, inputs, idx: np.ndarray, values: dict, device):
    """(checks, requests that failed): the sampled requests' values against
    the reference on each one's input."""
    refs, worst, failed = {}, 0.0, 0
    limit = float(cell.limits["image_err"]["limit"])
    for i in sorted(values):
        r = i % len(inputs)
        if r not in refs:
            refs[r] = check.reference(cell, inputs[r], idx, device)
        err = check.image_err(values[i], refs[r])
        worst = max(worst, err)
        failed += int(not err <= limit)
    checks = {"image_err": {"value": worst, "limit": limit}}
    return checks, failed


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float):
    """One run of ``cell``: (the result line's object, ``checks`` last; the
    errors the failed requests raised)."""
    run, inputs, idx, values, peak = measure(cell, seed, seconds, trace, device, t_start)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = judge(cell, inputs, idx, values, device)
    failed += sum(not r.ok for r in run.requests)
    checks["requests_failed"] = {"value": failed, "limit": 0}
    del inputs
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"], cell.base)(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = torch.device(device)
    out = {
        "correct": bool(run.requests) and failed == 0 and not run.errors,
        "attempted": len(run.requests),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_us * 1e-6
        out["device"]["window_s"] = run.trace.window_us * 1e-6
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out, run.errors
