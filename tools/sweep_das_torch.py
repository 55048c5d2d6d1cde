#!/usr/bin/env python3
"""Sweeps of the DAS kernels K1 and K2 of the PyTorch + CUDA port at the
headline size (1024^2 pixels x 256 tx x 256 rx, T = 4096, plane waves,
``bench.das_problem``), on one CUDA card, timed with CUDA events.

    python3 tools/sweep_das_torch.py samplers  # every sampler and trace type
    python3 tools/sweep_das_torch.py tiles     # ... by the pixels' order

``samplers`` times the kernels (``csrc/das.cu``) for every sampler, real
and complex traces, each with its trace layout (the traces transposed for
nearest, stencil entries for the others), and the layout kernel alone.

``tiles`` times them with the headline's pixels listed in tiles of
lateral x depth pixels instead of rows (a block takes 256 consecutive
pixels), to see how the span of delays within a block moves them.

Prints each number with the card's name and power limit, and writes the
lines to ``--out``. Imports torch, numpy and the port, never JAX.
"""
import argparse
import os
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
    das_cuda.build()
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
    ap.add_argument("what", choices=("samplers", "tiles"))
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
        {"samplers": samplers, "tiles": tiles}[args.what](torch, prob, say)
        say(f"card: {card}")


if __name__ == "__main__":
    main()
