#!/usr/bin/env python3
"""K1(b) and K2(b) (das_frames_kernel) at chip_smoke.py phase 14's shapes,
timed with CUDA events, for the ``qups_tpu_torch`` package under ROOT
(default: this checkout), so that two commits compare on one card:

* ``iq``: the headline in IQ, 1024^2 pixels x 256 tx x 256 rx x 4 frames,
  T' 1024 complex64 at 7.8125 MHz (``chip_smoke.iq_headline``), K1 on the
  plane-wave geometry and K2 on its delay tables, every sampler: 4 frames
  in one call and 4 one-frame calls, each with fmod = 5 MHz and without;
* ``summed``: the summed headline (phase 4 / 8), 1024^2 x 256 x 256, T
  4096, real, cubic, K1 and K2 (das_kernel);
* ``keep``: phase 16's keep kernel at the same headline: keep_rx, keep_tx,
  the fused apodization (aperture growth, acceptance angle,
  parallelogram), K2 keep_rx;
* ``sweep``: das_frames_kernel as shipped against alternatives, K1 at the
  IQ headline for every sampler x {real (the IQ traces' real part),
  complex} x {fmod, none}, 4 frames in one call (``--configs``, a JSON
  list of objects: ``fb`` frames a launch for every sampler and type,
  ``unroll`` and ``minb`` the rotating variants' unroll and least blocks
  an SM, ``reduce: "double"`` the short rotation's reduction in one
  double-precision FMA (k and its quadrant from a double add), each from
  a copy of ``csrc/das.cu`` so edited, built under ``_build/k1b_sweep/``;
  ``copies: false`` the package's own kernels with one-frame launches on
  the 4 frames' layout at frame offsets instead of one-frame calls on
  copies of each frame; ``cases`` a substring that names the cases to
  time). The shipped package is timed before and after the
  configurations, and each configuration's rotation is held against
  float64 over |phase| <= PHASE_MAX and <= 2^30.

It prints the registers and stack frame of each das_frames_kernel
variant the package builds and the card's name and power limit. Each time
is the mean of ``--reps`` calls after one warm-up call (lanczos3 one).
Run from the repository root on a machine with a CUDA card:

    python3 tools/k1b_torch.py [--root DIR] [--what iq summed keep sweep]

To compare with another commit, unpack it (``git archive``) under a
directory .gitignore lists and run this script with ``--root`` there and
here in turns (parent, change, change, parent); ``sweep`` needs this
checkout's kernel plan. The last line is one JSON object: {"root",
"card", "ms": {case: ms}, "sweep": {config: {case: ms}}, "variants"}.
"""
import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("nearest", "linear", "cubic", "lanczos3")
FMOD = 5e6
# the sweep's default configurations: the reduction in double precision,
# and complex cubic float32 frames one a launch on the 4 frames' layout
SWEEP = [{"reduce": "double", "cases": "fmod"},
         {"copies": False, "cases": "cubic complex"}]
# a configuration's keys that edit a copy of csrc/das.cu: the constant each sets
CONSTANTS = {"fb": "FRAMES_A_LAUNCH", "unroll": "FRAMES_UNROLL", "minb": "FRAMES_MIN_BLOCKS"}
# the short rotation's reduction in one double-precision FMA
DOUBLE_REDUCTION = """  const double xd = x;
  const double t = fma(xd, 0.63661977236758134308, 0x1.8p52);
  const double k = t - 0x1.8p52;
  const unsigned q = (unsigned)__double2loint(t);
  const float r = (float)fma(-k, 1.5707963267948966192, xd);
"""


def _helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # its helpers import qups_tpu_torch when called
    return cs


def _variants(cs, log, what):
    """Print das_frames_kernel's variants in an nvcc log; return them."""
    rows = cs.frames_variants(log)
    if not log:
        print(f"{what}: built by an earlier process, no ptxas log")
    for src, method, rot, nf, q, regs, stack, spill in rows:
        print(f"{what}: das_frames_kernel source {src} {METHODS[method]:8s} rotation {rot} "
              f"frames {nf} entry {q}: {regs} registers, stack frame {stack} bytes, "
              f"spill stores {spill} bytes")
    return rows


def _plan_source(src: str, cfg: dict) -> str:
    """das.cu with the edits ``cfg`` names: the constants CONSTANTS names
    (``fb``: every sampler and type fb frames a launch), and with
    ``reduce: "double"`` the short rotation's reduction in double
    precision."""
    subs = []
    for key, name in CONSTANTS.items():
        if key in cfg:
            subs.append((r"constexpr int %s = \d+;" % name, "constexpr int %s = %d;" % (
                name, cfg[key])))
    if "fb" in cfg:
        subs.append((r"return method == CUBIC && q == F32 && cplx \? 1 : FRAMES_A_LAUNCH;",
                     "return FRAMES_A_LAUNCH;"))
    if cfg.get("reduce") == "double":
        subs.append((r"  const float t = fmaf\(x, [^\n]*\n(?:[^\n]*\n){3}  r = fmaf\([^\n]*\n",
                     lambda m: DOUBLE_REDUCTION))
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        assert n == 1, pat
    return src


def _name(cfg: dict) -> str:
    return ", ".join(f"{k} {int(v) if isinstance(v, bool) else v}" for k, v in cfg.items())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--what", nargs="+", default=["iq", "summed", "keep"])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--configs", type=json.loads, default=SWEEP,
                    help="the sweep's configurations, a JSON list of objects with any of "
                         + ", ".join(CONSTANTS) + ", reduce, copies, cases")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # the package under test
    cs = _helpers()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: K1(b) and K2(b) run only on the card")
    import qups_tpu_torch as qt
    from qups_tpu_torch.ops import _nvcc, das_cuda
    from qups_tpu_torch.ops.das import delay_tables

    assert os.path.dirname(os.path.dirname(qt.__file__)) == root, qt.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; package: {root}", flush=True)
    res = {"root": root, "card": card, "ms": {}, "sweep": {}, "variants": {}}
    builds = [("das", das_cuda.build), ("das_iq", lambda: das_cuda.build(iq=True))]
    if "keep" in args.what:
        builds.append(("das_keep", das_cuda.build_keep))
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per source, at once
        logs = dict(zip([b[0] for b in builds], ex.map(lambda b: b[1]()[1], builds)))
    for lib in ("das", "das_iq"):
        res["variants"][lib] = _variants(cs, logs[lib], lib)

    def timed(name, fn, reps):
        ms = cs._ms(fn, reps=reps)
        res["ms"][name] = ms
        print(f"{name}: {ms:.3f} ms (mean of {reps} after a warm-up)", flush=True)
        return ms

    def reps(method):
        return 1 if method == "lanczos3" else args.reps

    cinv = np.float32(1 / 1540.0)
    if "iq" in args.what or "sweep" in args.what:
        iq, (pi, pr, pv, nv), _ = cs.iq_headline(torch, qt)
        x = iq.data
        fsq = iq.fs
        pig = torch.as_tensor(pi).cuda()
        ones = [x[..., f].contiguous() for f in range(x.shape[3])]
        k1 = lambda xx, **k: das_cuda.das_sum(  # noqa: E731
            xx, pig, pr, pv, nv, iq.t0, cinv, fs=fsq, tx_model="plane", **k)
    if "iq" in args.what:
        tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
        k2 = lambda xx, **k: das_cuda.das_lut_sum(  # noqa: E731
            xx, tau_rx, tau_tx, iq.t0, fs=fsq, **k)
        for kn, kern in (("K1(b)", k1), ("K2(b)", k2)):
            for method in METHODS:
                for fmod in (FMOD, 0.0):
                    tag = f"{kn} {method} {'fmod' if fmod else 'none'}"
                    timed(f"{tag} 4 frames", lambda: kern(x, method=method, fmod=fmod),
                          reps(method))
                    timed(f"{tag} 4 one-frame calls",
                          lambda: [kern(o, method=method, fmod=fmod) for o in ones],
                          reps(method))
        del tau_rx, tau_tx
    if "sweep" in args.what:
        xr = x.real.contiguous()
        cases = [(f"{method} {ty} {'fmod' if fmod else 'none'}", method, xx, fmod)
                 for method in METHODS for ty, xx in (("real", xr), ("complex", x))
                 for fmod in (FMOD, 0.0)]
        base = os.path.join(root, "qups_tpu_torch", "_build", "k1b_sweep")
        csrc = os.path.join(root, "qups_tpu_torch", "csrc")
        das_src = open(os.path.join(csrc, "das.cu")).read()
        edits = [c for c in args.configs if set(c) & (set(CONSTANTS) | {"reduce"})]
        jobs = []
        for cfg in edits:  # a copy of csrc/ a configuration, das.cu edited
            d = Path(base) / re.sub(r"[^a-z0-9]+", "_", _name(cfg))
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, d)
            src = _plan_source(das_src, cfg)
            (d / "das.cu").write_text(src)
            jobs += [(d / "das.cu", b""), (d / "das_iq.cu", src.encode())]
        with ThreadPoolExecutor(max(1, len(jobs))) as ex:  # one nvcc per source, at once
            done = list(ex.map(lambda j: _nvcc._build(
                j[0], j[1], [_nvcc.nvcc(), *_nvcc.flags(j[0].stem)]), jobs))
        g = torch.Generator(device="cuda").manual_seed(12)
        unit = torch.rand(1 << 22, generator=g, device="cuda") * 2 - 1
        shipped = (das_cuda.frames_per_launch, das_cuda._launch_frames, dict(_nvcc._loaded))

        def launch_frames_on_one_layout(x, method, fmod, launch, fb_max=das_cuda.FB,
                                        precision="f32", scale=None, out=None):
            return shipped[1](x, method, fmod, launch, fb_max, precision, scale)

        def sweep(key, cfg):
            names = [c for c in cases if cfg.get("cases", "") in c[0]]
            res["sweep"][key] = {name: cs._ms(lambda: k1(xx, method=m, fmod=f), reps(m))
                                 for name, m, xx, f in names}
            for pm in (das_cuda.PHASE_MAX, 2.0 ** 30):  # the configuration's short rotation
                ph = unit * pm
                sc = das_cuda.sincos_probe(ph).double()
                res["sweep"][key][f"rotation max abs error, |phase| <= {pm:.0f}"] = float(
                    torch.maximum((sc[:, 0] - torch.sin(ph.double())).abs(),
                                  (sc[:, 1] - torch.cos(ph.double())).abs()).max())
            print(f"sweep [{key}]: {res['sweep'][key]}", flush=True)

        sweep("shipped", {})
        for cfg in args.configs:
            key = _name(cfg)
            if cfg in edits:
                i = edits.index(cfg)
                libs = {"das": done[2 * i], "das_iq": done[2 * i + 1]}
                for lib in ("das", "das_iq"):
                    _variants(cs, libs[lib][1], f"sweep [{key}] {lib}")
                _nvcc._loaded.update(libs)
            if "fb" in cfg:
                das_cuda.frames_per_launch = lambda *a, _fb=cfg["fb"], **k: _fb
            if cfg.get("copies", True) is False:
                das_cuda._launch_frames = launch_frames_on_one_layout
            sweep(key, cfg)
            das_cuda.frames_per_launch, das_cuda._launch_frames = shipped[:2]
            _nvcc._loaded.clear()
            _nvcc._loaded.update(shipped[2])
        sweep("shipped, again", {})
        del xr
    if "iq" in args.what or "sweep" in args.what:
        del x, ones, iq
    if "summed" in args.what or "keep" in args.what:
        from qups_tpu_torch import bench

        n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
        x0, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
        xg = torch.as_tensor(x0).cuda()
        del x0
        pig = torch.as_tensor(pi).cuda()
        tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
        kw = dict(fs=fs, method="cubic")
        k1 = lambda **k: das_cuda.das_sum(  # noqa: E731
            xg, pig, pr, pv, nv, t0, cinv, tx_model="plane", **kw, **k)
        k2 = lambda **k: das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kw, **k)  # noqa: E731
        if "summed" in args.what:
            timed("summed K1 cubic", k1, args.reps)
            timed("summed K2 cubic", k2, args.reps)
        if "keep" in args.what:
            b = pr[:, 0].min() - 1e-4, pr[:, 0].max() + 1e-4
            fused = (qt.Fused("aperture_growth", f=1.5),
                     qt.Fused("acceptance_angle", theta=45.0),
                     qt.Fused("tx_parallelogram", xlo=float(b[0]), xhi=float(b[1])))
            timed("keep_rx K1(c)", lambda: k1(keep_rx=True), args.reps)
            timed("keep_tx K1(c)", lambda: k1(keep_tx=True), args.reps)
            timed("fused apodization K1(d)", lambda: k1(apod=fused), args.reps)
            timed("keep_rx K2(c)", lambda: k2(keep_rx=True), args.reps)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
