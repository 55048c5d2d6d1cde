#!/usr/bin/env python3
"""Sweeps of the DAS kernels K1 and K2 of the PyTorch + CUDA port at the
headline size (1024^2 pixels x 256 tx x 256 rx, T = 4096, plane waves,
``bench.das_problem``), on one CUDA card, timed with CUDA events.

    python3 tools/sweep_das_torch.py samplers  # every sampler and trace type
    python3 tools/sweep_das_torch.py tiles     # ... by the pixels' order
    python3 tools/sweep_das_torch.py keep      # keep modes and weights

``samplers`` times the kernels (``csrc/das.cu``) for every sampler, real
and complex traces, each with its trace layout (the traces transposed for
nearest, stencil entries for the others), and the layout kernel alone;
it first prints the registers ptxas gave each kernel variant it built.

``keep`` times das_keep_kernel (``csrc/das_keep.cu``: K1(c), K1(d),
K2(c)) beside the summed K1 for nearest and cubic: keep_rx, keep_tx, the
summed call with fused aperture growth, acceptance angle and
parallelogram, the summed call with a dense (I, N) weight, and K2
keep_rx; it first prints the registers and stack frames of its variants.

``tiles`` times them with the headline's pixels listed in tiles of
lateral x depth pixels instead of rows (a block takes 256 consecutive
pixels), to see how the span of delays within a block moves them.

Prints each number with the card's name and power limit, and writes the
lines to ``--out``. Imports torch, numpy and the port, never JAX.
"""
import argparse
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("nearest", "linear", "cubic", "lanczos3")


def event_ms(torch, fn, reps):
    """Mean ms of ``fn`` over ``reps`` runs after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def samplers(torch, prob, say):
    from qups_tpu_torch.ops import das_cuda
    from qups_tpu_torch.ops.das import delay_tables

    x, pi, pr, pv, nv, t0, fs, cinv = prob
    xs = {"real": x, "complex": torch.complex(x, x.roll(1, 0))}
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    _, log = das_cuda.build()
    regs, fn = {}, None  # (kernel, sampler, trace type) -> registers
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        fn = m.group(1) if m else fn
        m = re.search(r"Used (\d+) registers", line)
        k = fn and re.search(r"das_kernelILi(\d)ELi(\d)E(f|6float2)E", fn)
        if m and k:
            regs[("K2" if k.group(1) == "3" else "K1", METHODS[int(k.group(2))],
                  "real" if k.group(3) == "f" else "complex")] = m.group(1)
    if regs:
        say("registers (ptxas) of das_kernel, the one-frame kernel timed here: " + ", ".join(
            f"{a} {b} {c}: {r}" for (a, b, c), r in sorted(regs.items())))
    say("samplers: K1 and K2 at the headline, per trace type and sampler (ms, CUDA "
        "events, mean of 2 after a warm-up, lanczos3 of 1; K1 and K2 include the layout "
        "kernel, which is also timed alone):")
    for kind, xk in xs.items():
        for method in METHODS:
            reps = 1 if method == "lanczos3" else 2
            lay = event_ms(torch, lambda: das_cuda.trace_layout(xk, method), 2)
            k1 = event_ms(torch, lambda: das_cuda.das_sum(
                xk, pi, pr, pv, nv, t0, cinv, fs=fs, tx_model="plane", method=method), reps)
            k2 = event_ms(torch, lambda: das_cuda.das_lut_sum(
                xk, tau_rx, tau_tx, t0, fs=fs, method=method), reps)
            say(f"    {kind:7s} {method:8s} K1 {k1:10.3f}   K2 {k2:10.3f}   "
                f"layout kernel {lay:8.3f}")


def keep(torch, prob, say):
    from qups_tpu_torch.ops import das_cuda
    from qups_tpu_torch.ops.das import delay_tables

    x, pi, pr, pv, nv, t0, fs, cinv = prob
    _, log = das_cuda.build_keep()
    das_cuda.build()
    fn, got = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        fn = m.group(1) if m else fn
        k = fn and re.search(r"das_keep_kernelILi(\d)ELi(\d)E(f|6float2)Lb0ELi(\d)E", fn)
        key = k and (k.group(1), METHODS[int(k.group(2))], k.group(3), k.group(4))
        m = re.search(r"Used (\d+) registers", line)
        if m and k:
            got.setdefault(key, [0, 0])[0] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and k:
            got.setdefault(key, [0, 0])[1] = int(m.group(1))
    say("registers / stack bytes (ptxas) of das_keep_kernel, no rotation, by frames a "
        "launch: " + ", ".join(
            f"{'K2' if s == '3' else 'K1 src ' + s} {mth} {'real' if t == 'f' else 'complex'}"
            f" F{nf}: {r} / {st}" for (s, mth, t, nf), (r, st) in sorted(got.items())))
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    n2 = pi.shape[0]
    lo, hi = float(pr[:, 0].min()) - 1e-4, float(pr[:, 0].max()) + 1e-4
    fused = (das_cuda.Fused("aperture_growth", f=1.5),
             das_cuda.Fused("acceptance_angle", theta=45.0),
             das_cuda.Fused("tx_parallelogram", xlo=lo, xhi=hi))
    dense = torch.rand((n2, 1, 1, pr.shape[0], 1), device="cuda")
    say("keep: the headline, real traces (ms, CUDA events, mean of 2 after a warm-up; "
        "the layout kernel included):")
    for method in ("nearest", "cubic"):
        k1 = lambda **kw: das_cuda.das_sum(  # noqa: E731
            x, pi, pr, pv, nv, t0, cinv, fs=fs, tx_model="plane", method=method, **kw)
        cases = {"K1 summed": lambda: k1(), "keep_rx": lambda: k1(keep_rx=True),
                 "keep_tx": lambda: k1(keep_tx=True), "fused x3": lambda: k1(apod=fused),
                 "dense (I, N)": lambda: k1(apod=(dense,)),
                 "K2 keep_rx": lambda: das_cuda.das_lut_sum(
                     x, tau_rx, tau_tx, t0, fs=fs, method=method, keep_rx=True)}
        say(f"    {method:8s} " + "   ".join(f"{name} {event_ms(torch, f, 2):9.3f}"
                                           for name, f in cases.items()))


def tile_order(n, tx, tz):
    """A permutation of the z-major n x n grid (rows iso-depth) that lists
    it in tiles of tx lateral x tz depth pixels."""
    g = np.arange(n * n).reshape(n // tz, tz, n // tx, tx)  # (zt, z, xt, x)
    return g.transpose(0, 2, 1, 3).reshape(-1)


def tiles(torch, prob, say):
    from qups_tpu_torch.ops import das_cuda
    from qups_tpu_torch.ops.das import delay_tables

    x, pi, pr, pv, nv, t0, fs, cinv = prob
    n = int(round(np.sqrt(pi.shape[0])))
    das_cuda.build()
    say("tiles: K1 and K2 at the headline with the pixels listed in tiles of "
        "lateral x depth pixels (ms, CUDA events, mean of 2 after a warm-up; a block "
        "is 256 consecutive pixels; outputs bit-identical to the row order):")
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    for method in ("nearest", "cubic"):
        base1 = das_cuda.das_sum(x, pi, pr, pv, nv, t0, cinv, fs=fs, tx_model="plane",
                                 method=method).reshape(-1)
        base2 = das_cuda.das_lut_sum(x, tau_rx, tau_tx, t0, fs=fs, method=method).reshape(-1)
        for tx, tz in ((n, 1), (256, 1), (64, 4), (32, 8), (16, 16), (8, 32)):
            perm = tile_order(n, tx, tz)
            pg = torch.as_tensor(perm, device="cuda")
            pip, trp, ttp = pi[perm], tau_rx[pg].contiguous(), tau_tx[pg].contiguous()
            k1 = event_ms(torch, lambda: das_cuda.das_sum(
                x, pip, pr, pv, nv, t0, cinv, fs=fs, tx_model="plane", method=method), 2)
            k2 = event_ms(torch, lambda: das_cuda.das_lut_sum(
                x, trp, ttp, t0, fs=fs, method=method), 2)
            g1 = das_cuda.das_sum(x, pip, pr, pv, nv, t0, cinv, fs=fs, tx_model="plane",
                                  method=method).reshape(-1)
            g2 = das_cuda.das_lut_sum(x, trp, ttp, t0, fs=fs, method=method).reshape(-1)
            same = bool(torch.equal(g1, base1[pg])) and bool(torch.equal(g2, base2[pg]))
            say(f"    {method:8s} tiles {tx:4d} x {tz:2d}: K1 {k1:10.3f}   K2 {k2:10.3f}   "
                f"bit-identical: {same}")
            del trp, ttp


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("samplers", "tiles", "keep"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sweep_das_torch: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import bench  # numpy-only at import

    out = args.out or os.path.join(ROOT, "chiprun_out", f"sweep_das_torch_{args.what}.txt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip()
    with open(out, "w") as rep:
        def say(line):
            print(line, flush=True)
            rep.write(line + "\n")

        say(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
        n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
        x, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
        prob = (torch.as_tensor(x).cuda(), pi, pr, pv, nv, t0, fs, np.float32(1 / 1540.0))
        del x
        {"samplers": samplers, "tiles": tiles, "keep": keep}[args.what](torch, prob, say)
        say(f"card: {card}")


if __name__ == "__main__":
    main()
