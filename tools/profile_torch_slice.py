#!/usr/bin/env python3
"""Where the time goes in the PyTorch + CUDA port's slice, on one CUDA card.

    python3 tools/profile_torch_slice.py [--out chiprun_out/profile_torch_slice.txt]

Traces, with ``torch.profiler`` (CUDA activity):

1. the headline DAS, 1024^2 pixels x 256 tx x 256 rx, T = 4096, plane
   waves, cubic (``qups_tpu_torch.bench.das_problem``): 3 calls of ``das_cuda.das_sum``
   after a warm-up; device time per op, device busy time and host wall time
   per call;
2. K1's and K2's device time alone per sampler at that size (2 calls
   each; K2 on the plane-wave geometric tables), and the layout kernel's
   that runs before each;
3. the main path at the size of ``chip_smoke.py``: L11-5v, FSA over 128
   elements, 256 x 256 pixels, 5 targets,
   ``us.DAS(us.greens(scat, device="cuda"))``, 3 runs after a warm-up;
4. the plane-wave demo path (``examples/demo_imaging.py``'s system and
   phantom: L11-5v, 5 plane waves, 256 x 256 pixels, 20 targets):
   ``us.greens`` (K3, then focusTx), ``us.DAS`` (K1), ``us.bfDAS`` (K2) and
   ``us.bfAdjoint`` (K4), 3 runs after a warm-up, then each call alone;
5. the simulator path of ``chip_smoke.py`` phase 10 (the main system, 10^4
   speckle scatterers): ``greens(impl='pallas')`` (K5), ``greens(precision=
   'bf16')`` (K3(b)), ``simus`` (K3(c)), ``calc_scat_all`` (K3),
   ``calc_scat_multi`` with 5 plane waves (K5) and ``calc_hp`` with a
   focused transmit, 2 runs after a warm-up, then each call alone, and
   ``greens(impl='pallas')`` by the ranges of ``greens_tiled`` (its plan on
   the device, K5, the finish kernel);
6. ``bf_adjoint_cuda`` (K4 and its spectra) at the headline's pixels and
   arrays (1024^2 x 256 x 256, 32 bins) for 8, 64, 128 and 256 pulses,
   bf16 and f32, timed with CUDA events: how K4's time splits between the
   per-bin phasors and the column tiles of the products.

Prints a summary and writes the profiler tables to ``--out``. Imports torch,
numpy and the port, never JAX.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dev_us(evt, self_only=True):
    """Device microseconds of a profiler event (names differ across torch
    versions)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for n in names:
        if hasattr(evt, n):
            return float(getattr(evt, n))
    return 0.0


RANGES = ("qups.greens_tiled.plan", "qups.greens_tiled.splat", "qups.greens_tiled.finish")


def _on_device(torch, evt):
    """True for the device-side records (kernels, copies, memsets); the
    host-side ops that launched them, and the device side of a named range
    (the port's spans, ``qups.*``), carry the same device time again."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and "Activity Buffer" not in evt.key and not evt.key.startswith("qups."))


def profile(torch, fn, reps):
    """Run ``fn`` once to warm up, then ``reps`` times under the profiler.
    Returns (all key averages, the device-side ones, host wall s per run,
    device busy us per run). Busy time is the sum of the device records: one stream, so
    they do not overlap."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / reps
    ka = [e for e in prof.key_averages() if _on_device(torch, e)]
    busy = sum(_dev_us(e) for e in ka) / reps
    return prof.key_averages(), ka, wall, busy


def top(ka, reps, k=12):
    """(name, device ms per run, calls per run) of the ops with the most
    self device time."""
    rows = sorted(((e.key[:110], _dev_us(e) / reps / 1e3, e.count / reps)
                   for e in ka if _dev_us(e) > 0), key=lambda r: -r[1])
    return rows[:k]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_torch_slice.txt"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_slice: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from qups_tpu_torch import bench  # the headline's das_problem
    import qups_tpu_torch as qt
    from qups_tpu_torch.ops import das_cuda, fdbf_cuda, greens_cuda, greens_freq_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    for mod in (das_cuda, greens_freq_cuda, fdbf_cuda, greens_cuda):
        mod.build()
    greens_cuda.build_finish()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    report = open(args.out, "w")

    def say(line):
        print(line)
        report.write(line + "\n")

    n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
    x, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
    xg = torch.as_tensor(x).cuda()
    cinv = np.float32(1 / 1540.0)

    def das(method):
        return lambda: das_cuda.das_sum(xg, pi, pr, pv, nv, t0, cinv, fs=fs,
                                        tx_model="plane", method=method)

    full, ka, wall, busy = profile(torch, das("cubic"), 3)
    say(f"[1] headline DAS cubic: host wall {wall * 1e3:.3f} ms/call, device busy "
        f"{busy / 1e3:.3f} ms/call ({100 * busy / 1e6 / wall:.1f} % of wall)")
    if busy == 0:
        say("    the profiler recorded no device time on this machine")
    for name, ms, calls in top(ka, 3):
        say(f"    {ms:10.3f} ms/call {100 * ms * 1e3 / max(busy, 1e-9):6.1f} %  "
            f"x{calls:g}  {name}")
    report.write(full.table(sort_by="self_cuda_time_total", row_limit=25) + "\n")

    from qups_tpu_torch.ops.das import delay_tables

    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    say("[2] K1 and K2 device time alone, headline size, per sampler, and the layout "
        "kernel before each:")
    for method in ("nearest", "linear", "cubic", "lanczos3"):
        row = []
        for name, fn in (("K1", das(method)), ("K2", lambda: das_cuda.das_lut_sum(
                xg, tau_rx, tau_tx, t0, fs=fs, method=method))):
            _, ka, _, _ = profile(torch, fn, 2)
            k = sum(_dev_us(e) for e in ka if "das_kernel" in e.key) / 2
            lay = sum(_dev_us(e) for e in ka if "layout_kernel" in e.key) / 2
            row.append(f"{name} {k / 1e3:10.3f} ms (layout {lay / 1e3:.3f} ms)")
        say(f"    {method:8s} " + "   ".join(row))
    del xg, tau_rx, tau_tx

    xdc = qt.TransducerArray.L11_5v()
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=128),
        scan=qt.ScanCartesian(x=np.linspace(-15e-3, 15e-3, 256),
                              z=np.linspace(5e-3, 45e-3, 256)))
    targets = np.array([[-10e-3, 0.0, 10e-3], [5e-3, 0.0, 17e-3], [0.0, 0.0, 25e-3],
                        [-6e-3, 0.0, 33e-3], [9e-3, 0.0, 40e-3]]).T
    scat = qt.Scatterers(pos=targets, c0=1540.0)
    full, ka, wall, busy = profile(torch, lambda: us.DAS(us.greens(scat, device="cuda")), 3)
    say(f"[3] sim->image (L11-5v FSA, 256^2 px, 5 targets): host wall "
        f"{wall * 1e3:.3f} ms/run, device busy {busy / 1e3:.3f} ms/run "
        f"({100 * busy / 1e6 / wall:.1f} % of wall)")
    for name, ms, calls in top(ka, 3):
        say(f"    {ms:10.3f} ms/run {100 * ms * 1e3 / max(busy, 1e-9):6.1f} %  "
            f"x{calls:g}  {name}")
    report.write(full.table(sort_by="self_cuda_time_total", row_limit=30) + "\n")
    report.write(full.table(sort_by="self_cpu_time_total", row_limit=20) + "\n")

    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc,
        seq=qt.SequenceRadial(type="PW", angles=np.arange(-10, 11, 5), c0=1540.0),
        scan=qt.ScanCartesian(x=np.linspace(-12e-3, 12e-3, 256),
                              z=np.linspace(15e-3, 35e-3, 256)), fs=4 * xdc.fc)
    Zs, Xs = np.meshgrid(np.linspace(18e-3, 32e-3, 4), np.linspace(-8e-3, 8e-3, 5),
                         indexing="ij")
    pos = np.stack([Xs.ravel(), np.zeros(Xs.size), Zs.ravel()])
    scat = qt.Scatterers(pos=pos, amp=np.ones(pos.shape[1]), c0=1540.0)
    chd = us.greens(scat, device="cuda")

    def demo():
        c = us.greens(scat, device="cuda")
        return us.DAS(c), us.bfDAS(c), us.bfAdjoint(c)

    full, ka, wall, busy = profile(torch, demo, 3)
    say(f"[4] plane-wave demo (L11-5v, 5 PW, 256^2 px, 20 targets; greens, DAS, "
        f"bfDAS, bfAdjoint): host wall {wall * 1e3:.3f} ms/run, device busy "
        f"{busy / 1e3:.3f} ms/run ({100 * busy / 1e6 / wall:.1f} % of wall)")
    for name, ms, calls in top(ka, 3, k=16):
        say(f"    {ms:10.3f} ms/run {100 * ms * 1e3 / max(busy, 1e-9):6.1f} %  "
            f"x{calls:g}  {name}")
    report.write(full.table(sort_by="self_cuda_time_total", row_limit=30) + "\n")
    for name, fn in (("greens+focusTx", lambda: us.greens(scat, device="cuda")),
                     ("DAS", lambda: us.DAS(chd)), ("bfDAS", lambda: us.bfDAS(chd)),
                     ("bfAdjoint", lambda: us.bfAdjoint(chd))):
        _, ka, wall, busy = profile(torch, fn, 3)
        say(f"    alone: {name:15s} host wall {wall * 1e3:9.3f} ms, device busy "
            f"{busy / 1e3:9.3f} ms ({100 * busy / 1e6 / wall:.1f} %); top: "
            + "; ".join(f"{n[:40]} {ms:.3f} ms" for n, ms, _ in top(ka, 3, k=3)))

    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=128),
        scan=qt.ScanCartesian(x=np.linspace(-15e-3, 15e-3, 256),
                              z=np.linspace(5e-3, 45e-3, 256)))
    rng = np.random.default_rng(10)
    S = 10_000
    speck = qt.Scatterers(pos=np.stack([rng.uniform(-15e-3, 15e-3, S), np.zeros(S),
                                        rng.uniform(5e-3, 45e-3, S)]),
                          amp=rng.standard_normal(S), c0=1540.0)
    pw = us.replace(seq=qt.SequenceRadial(type="PW", angles=np.arange(-10, 11, 5), c0=1540.0))
    fc = us.replace(seq=qt.Sequence(type="FC", focus=np.array([[0.0], [0.0], [25e-3]]),
                                    c0=1540.0))
    sims = (("greens pallas", lambda: us.greens(speck, impl="pallas", device="cuda")),
            ("greens bf16", lambda: us.greens(speck, precision="bf16", device="cuda")),
            ("simus", lambda: us.simus(speck, device="cuda")),
            ("calc_scat_all", lambda: us.calc_scat_all(speck, device="cuda")),
            ("calc_scat_multi", lambda: pw.calc_scat_multi(speck, impl="pallas",
                                                           device="cuda")),
            ("calc_hp", lambda: fc.calc_hp(device="cuda")))
    full, ka, wall, busy = profile(torch, lambda: [fn() for _, fn in sims], 2)
    say(f"[5] simulator path (L11-5v FSA, 10^4 scatterers; {', '.join(n for n, _ in sims)}): "
        f"host wall {wall * 1e3:.3f} ms/run, device busy {busy / 1e3:.3f} ms/run "
        f"({100 * busy / 1e6 / wall:.1f} % of wall)")
    for name, ms, calls in top(ka, 2, k=16):
        say(f"    {ms:10.3f} ms/run {100 * ms * 1e3 / max(busy, 1e-9):6.1f} %  "
            f"x{calls:g}  {name}")
    report.write(full.table(sort_by="self_cuda_time_total", row_limit=30) + "\n")
    for name, fn in sims:
        full, ka, wall, busy = profile(torch, fn, 2)
        say(f"    alone: {name:15s} host wall {wall * 1e3:9.3f} ms, device busy "
            f"{busy / 1e3:9.3f} ms ({100 * busy / 1e6 / wall:.1f} %); top: "
            + "; ".join(f"{n[:40]} {ms:.3f} ms" for n, ms, _ in top(ka, 2, k=3)))
        for e in full:  # greens_tiled's ranges: host time and device span
            if e.key in RANGES and e.device_type == torch.autograd.DeviceType.CPU:
                dev = sum(_dev_us(d, False) for d in full if d.key == e.key
                          and d.device_type == torch.autograd.DeviceType.CUDA)
                say(f"        range {e.key:24s} host {e.cpu_time_total / 2e3:9.3f} ms, "
                    f"device span {max(dev, _dev_us(e, False)) / 2e3:9.3f} ms per call "
                    "(from its first kernel's start to its last's end)")

    # K4 across V at the headline's pixels and arrays: the kernel's device
    # time t(V) splits into the per-bin phasor tiles (V-independent) and the
    # column tiles of the products (proportional to the tiles of 2 VT)
    from qups_tpu_torch.ops.fdbf import geom_delays
    taur = geom_delays(pi, pr, np.float32(1 / 1540.0), "cuda")
    sel = np.arange(1024 - 16, 1024 + 16)
    def event_ms(fn, reps=2):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    say("[6] bf_adjoint_cuda at 1024^2 px x 256 x 256 x 32 bins, by pulses V "
        "(CUDA events, mean of 2 calls after a warm-up):")
    for V in (8, 64, 128, 256):
        th = np.radians(np.linspace(-20, 20, V))
        del_tx = -(pr[:, 0:1] * np.sin(th)[None, :]) / 1540.0
        g = torch.Generator(device="cuda").manual_seed(8)
        xv = torch.randn((T, N, V), generator=g, device="cuda")
        row = []
        for precision in ("bf16", "f32"):
            t = event_ms(lambda: fdbf_cuda.bf_adjoint_cuda(
                xv, taur, taur, del_tx, np.ones((M, V)), t0[0], np.zeros(V), sel, fs=fs,
                precision=precision))
            row.append(f"{precision} {t:9.3f} ms")
        say(f"    V {V:3d}: " + ", ".join(row))
        del xv
    report.close()
    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(f"card: {card.strip()}; tables in {args.out}")


if __name__ == "__main__":
    main()
