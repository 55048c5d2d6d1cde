#!/usr/bin/env python3
"""K4 in bf16 at three of chip_smoke.py's shapes, timed with CUDA events,
for the ``qups_tpu_torch`` package under ROOT (default: this checkout), so
that two commits compare on one card:

* ``volume``: phase 19's volumetric path, a 32 x 32 matrix array, FSA over
  its 1024 elements, 64^3 voxels, ``us.greens`` traces, 64 bins
  (N = M = V = 1024): keep '', keep_rx and keep_tx, and where the package
  has it, the phasor table kernel's share (both tables of every bin);
* ``headline``: phase 8's K4, 1024^2 pixels x 256 x 256 x 256 pulses x 64
  bins, keep '';
* ``demo``: the plane-wave demo's ``bfAdjoint`` arguments (phase 7), keep
  '': the call (spectra, operands and launch), and the launch alone on
  operands built once (``demo launch``).

Each time is the mean of ``--reps`` calls after one warm-up call. Run
from the repository root on a machine with a CUDA card:

    python3 tools/k4b_torch.py [--root DIR] [--what volume headline demo]

To compare with another commit, unpack it (``git archive``) under a
directory .gitignore lists and run this script with ``--root`` there and
here in turns (parent, change, change, parent). The last line is one JSON
object: {"root", "card", "ms": {case: ms}, "table_ms", "peak_gib": {case}}.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--what", nargs="+", default=["volume", "headline", "demo"])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # the package under test
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # its helpers import qups_tpu_torch when called

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: K4 runs only on the card")
    import qups_tpu_torch as qt
    from qups_tpu_torch.ops import fdbf_cuda

    assert os.path.dirname(os.path.dirname(qt.__file__)) == root, qt.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; package: {root}")
    res = {"root": root, "card": card, "ms": {}, "table_ms": None, "peak_gib": {}}

    def timed(name, fn):
        torch.cuda.reset_peak_memory_stats()
        ms = cs._ms(fn, reps=args.reps)
        res["ms"][name] = ms
        res["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2**30
        print(f"{name}: {ms:.3f} ms (mean of {args.reps} after a warm-up), peak "
              f"{res['peak_gib'][name]:.2f} GiB", flush=True)

    if "volume" in args.what:
        us, _, scat = cs._volume_system(qt)
        chd = us.greens(scat)
        a = cs._adjoint_args(us, chd, 64)
        for keep in ("", "rx", "tx"):
            kw = dict(fs=chd.fs, keep_rx=keep == "rx", keep_tx=keep == "tx", precision="bf16")
            timed(f"volume keep={keep!r}", lambda: fdbf_cuda.bf_adjoint_cuda(*a, **kw))
        if hasattr(fdbf_cuda, "phasor_table"):  # the wide route's tables, every bin
            from qups_tpu_torch.ops.fdbf import adjoint_spectra

            fk = adjoint_spectra(*a[:1], *a[3:], fs=chd.fs)[1]
            taur, taut = a[1], a[2]
            Mp, Np = fdbf_cuda.wide_layout(taut.shape[1], taur.shape[1], 1024, "")[:2]
            buf = torch.empty(taur.shape[0] * 2 * max(Mp, Np), dtype=torch.bfloat16,
                              device="cuda")

            def tables():
                for k in range(fk.shape[0]):
                    fdbf_cuda.phasor_table(fk[k:k + 1], taut, -1.0, Mp, buf)
                    fdbf_cuda.phasor_table(fk[k:k + 1], taur, 1.0, Np, buf)

            res["table_ms"] = cs._ms(tables, reps=args.reps)
            print(f"phasor tables, Wtx and Wrx of {fk.shape[0]} bins: "
                  f"{res['table_ms']:.3f} ms", flush=True)
            del buf
        del chd, a
    if "headline" in args.what:
        from qups_tpu_torch import bench
        from qups_tpu_torch.ops.fdbf import geom_delays

        n, T, N, M, V = 1024, 4096, 256, 256, 256
        _, pi, pr, _, _, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
        th = np.radians(np.linspace(-20, 20, V))
        del_tx = -(pr[:, 0:1] * np.sin(th)[None, :]) / 1540.0
        g = torch.Generator(device="cuda").manual_seed(8)
        x = torch.randn((T, N, V), generator=g, device="cuda")
        taur = geom_delays(pi, pr, np.float32(1 / 1540.0), "cuda")
        h = (x, taur, taur, del_tx, np.ones((M, V)), t0[0], np.zeros(V),
             np.arange(1024 - 32, 1024 + 32))
        timed("headline", lambda: fdbf_cuda.bf_adjoint_cuda(*h, fs=31.25e6, precision="bf16"))
        del x, taur, h
    if "demo" in args.what:
        us, _, scat = cs._demo_system(qt)
        chd = us.greens(scat)
        d = cs._adjoint_args(us, chd, 64)
        timed("demo", lambda: fdbf_cuda.bf_adjoint_cuda(*d, fs=chd.fs, precision="bf16"))
        from qups_tpu_torch.ops.fdbf import adjoint_spectra

        _, fk, Xk, Sk = adjoint_spectra(d[0], *d[3:], fs=chd.fs)
        ops = fdbf_cuda.adjoint_operands(fk, Xk, Sk, keep="", precision="bf16")
        timed("demo launch", lambda: fdbf_cuda.adjoint_launch(ops, d[1], d[2]))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
