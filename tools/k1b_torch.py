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
* ``keep``: the keep kernel (das_keep_kernel: K1(c), K1(d), K2(c)) at the
  same headline, nearest and cubic (``--methods``): keep_rx, keep_tx, the
  fused apodization (aperture growth, acceptance angle, parallelogram), K2
  keep_rx; keep_rx in i8x4 and with ``QUPS_DAS_ACC16`` (the reduced-
  precision keep units, cubic); keep_rx and keep_tx on one frame of the IQ
  headline with fmod 5 MHz (cubic); and a sha256 of each unrotated
  float32 keep_rx image, so that two packages' bits compare;
* ``keepsweep``: das_keep_kernel as shipped against alternatives
  (``--keep-configs``, a JSON list of objects: ``nck``, ``rxminb``,
  ``nckw``, ``rxminbw``, ``minb``, ``minbw``, ``unroll``, ``unrollw`` the
  constants KEEP_NCK, KEEP_RX_MIN_BLOCKS, KEEP_NCK_WIDE,
  KEEP_RX_MIN_BLOCKS_WIDE, KEEP_MIN_BLOCKS, KEEP_MIN_BLOCKS_WIDE,
  KEEP_UNROLL and KEEP_UNROLL_WIDE of a copy of
  ``csrc/das.cu``; ``rxsums: "registers"`` or ``"shared"`` keep_rx's sums
  there for every sum type; ``prefetch: false`` keep_tx's read of out
  after the transmit's terms; ``cases`` substrings, joined by ``|``, that
  name the cases to time: the keep cases at cubic and, with 4 frames of
  the IQ headline and fmod, keep_tx and the fused call), each copy's keep
  kernel for plane waves and tables and the cubic sampler alone, built
  under ``_build/k1b_sweep/``;
* ``lp``: the reduced trace precisions (K1(e), K2(e)): chip_smoke.py
  phase 18's calls at the headline (K1 bf16pair every sampler, bf16
  cubic, i8x4 cubic and lanczos3; K2 bf16pair every sampler, i8x4 cubic
  and lanczos3; the float32 calls beside them), the layout kernel alone
  in each entry form the package has (``das_cuda.FORMS``; else the rounded
  taps), keep_rx and keep_tx in i8x4, keep_rx in bf16pair and with
  ``QUPS_DAS_ACC16``, the IQ headline (4 frames, fmod 5 MHz, cubic) and
  the PICMUS IQ call (phase 23's system: 128 elements, 75 plane waves, 4
  frames, 512^2 px, seeded complex traces of T 1536 at 20.832 MHz, fmod
  5.208 MHz, cubic) in float32, bf16pair and i8x4;
* ``lpsweep``: K1(e)/K2(e)'s entry forms as shipped against alternatives
  (``--lp-configs``, a JSON list of objects: ``form`` {"<method>
  <real|complex> <precision>": form} the entry forms to launch instead of
  ``das_cuda.entry_form``'s, from a copy of ``csrc/das.cu`` whose
  ``reads`` builds every form; ``horner: true`` the rounded taps' cubic
  as Horner on tap differences instead of the weights of u and a 4-tap
  dot; ``i2f: true`` int8 taps widened by a sign extension and an
  ``I2F`` instead of ``__byte_perm`` into a float's mantissa and one
  subtraction; ``cases`` substrings, joined by ``|``; the keep calls
  are not swept), the narrow units of each copy built under
  ``_build/k1b_sweep/``;
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
  each frame's plane of the layout; ``cases`` a substring that names the cases to
  time). The shipped package is timed before and after the
  configurations, and each configuration's rotation is held against
  float64 over |phase| <= PHASE_MAX and <= 2^30;
* ``framesweep``: K1(b)'s frames a launch against the layout it reads,
  fb in {1, 2, 4} x {"all": one layout of all the call's frames, each
  launch at its frames' offset; "blocks": a layout in blocks of the
  launch's frames}, beside the frames the package's rule picks from the
  pixels' tap stride (``frames_per_launch``), at three pixel pitches:
  PICMUS RF (``_picmus_grid``, 512^2 px over x +-18 mm, 70.5 um, 128 el, 75
  PW, T 1664 at 20.832 MHz, 16 seeded frames: 1.91 tap bases between
  neighbouring pixels), the same at half the pitch (x +-9 mm: 0.95) and
  the IQ headline's (x +-12 mm over 1024 px at 7.8125 MHz: 0.24; its first
  256 of 1024 rows, T' 1024, 256 x 256, 4 seeded frames); for real cubic
  traces in float32, as 'f32c' (bf16pair) and 'h16' (i8x4), and nearest,
  linear and lanczos3 on real and complex traces, no fmod; and keep_rx
  (the keep kernel, one frame a launch) on the PICMUS RF ensemble on both
  layouts.

It prints the registers and stack frame of each das_frames_kernel
variant the package builds and the card's name and power limit. Each time
is the mean of ``--reps`` calls after one warm-up call (lanczos3 one).
Run from the repository root on a machine with a CUDA card:

    python3 tools/k1b_torch.py [--root DIR] [--what iq summed keep sweep keepsweep lp lpsweep
                                            framesweep]

To compare with another commit, unpack it (``git archive``) under a
directory .gitignore lists and run this script with ``--root`` there and
here in turns (parent, change, change, parent); ``sweep`` needs this
checkout's kernel plan, ``keepsweep`` its keep kernel. The last line is
one JSON object: {"root", "card", "ms": {case: ms}, "bits": {case:
sha256}, "sweep": {config: {case: ms}}, "keep_sweep": {config: {case:
ms}}, "lp_sweep": {config: {case: ms}}, "frame_sweep": {case: {config:
ms, "rule": fb}}, "variants"}.
"""
import argparse
import hashlib
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
# the keep sweep's default configurations
KEEP_SWEEP = [{"rxsums": "registers", "cases": "keep_rx"}, {"rxminbw": 2, "cases": "keep_rx"},
              {"nckw": 16, "cases": "IQ one frame keep_rx"},
              {"minb": 3, "minbw": 4, "cases": "keep_tx|fused"},
              {"minbw": 2, "cases": "IQ"}, {"unroll": 1, "unrollw": 2, "cases": "keep_tx|fused"},
              {"prefetch": False, "cases": "keep_tx"}]
KEEP_CONSTANTS = {"nck": "KEEP_NCK", "rxminb": "KEEP_RX_MIN_BLOCKS", "nckw": "KEEP_NCK_WIDE",
                  "rxminbw": "KEEP_RX_MIN_BLOCKS_WIDE", "minb": "KEEP_MIN_BLOCKS",
                  "minbw": "KEEP_MIN_BLOCKS_WIDE", "unroll": "KEEP_UNROLL",
                  "unrollw": "KEEP_UNROLL_WIDE"}
# a sweep copy's keep kernel for plane waves and tables, cubic, alone: a
# few variants a unit, so that the copies build in a minute
SWEEP_ONLY = [
    (r"      if constexpr \(Q != I8\) return run_keep<SRC, (NEAREST|LINEAR), V, ROT, Q>"
     r"\(k, smem, s\);\n", ""),
    (r"    case LANCZOS3: return run_keep<SRC, LANCZOS3, V, ROT, Q>\(k, smem, s\);\n", ""),
    (r"    case (DIVERGING|VIRTUAL): return keep_by_method<\w+, V, ROT, Q>\(method, k, smem, "
     r"s\);\n", ""),
]
# where keep_rx keeps its sums: "registers" for every type, "shared" (a
# column a thread of shared memory) for every type
RX_SUMS = {
    "registers": [(r"SHARED = WIDE && !W;", "SHARED = false;")],
    "shared": [(r"SHARED = WIDE && !W;", "SHARED = !W;"),
               (r"k\.keep == KEEP_RX && wide && !has_weights\(k\)",
                "k.keep == KEEP_RX && !has_weights(k)")],
}
# keep_tx's read of out where it adds, after the transmit's terms
NO_PREFETCH = [
    (r"          if \(n0 > 0\) prev = kept_load<Q>\(k, out, i \+ m \* k\.om\);\n", ""),
    (r"n0 == 0 \? acc : prev \+ acc", "n0 == 0 ? acc : kept_load<Q>(k, out, i + m * k.om) + acc"),
]
# the lp sweep's default configurations: the summed calls' forms not
# shipped (the rounded taps for real cubic traces, float32 coefficients for
# real cubic int8 taps, int8 taps for complex cubic ones, float32
# coefficients for complex cubic bf16 traces) and the narrow samplers'
# alternatives
LP_SWEEP = [{"form": {"cubic real bf16pair": "bf16", "cubic real i8x4": "i8"},
             "cases": "real cubic"},
            {"form": {"cubic real i8x4": "f32c"}, "cases": "real cubic i8x4"},
            {"form": {"cubic complex i8x4": "i8"}, "cases": "IQ cubic i8x4"},
            {"form": {"cubic complex bf16pair": "f32c"}, "cases": "IQ cubic bf16pair"},
            {"horner": True, "cases": "IQ cubic bf16pair"},
            {"i2f": True, "cases": "lanczos3 i8x4"}]
# a copy's reads(): every form of each entry type
READS_ALL = [(r"(constexpr bool reads\(int q, int method, bool cplx, bool keep\) \{\s*return ).*?;",
              lambda m: m.group(1) + "q == I8 ? method >= CUBIC : q == H16 ? method == CUBIC "
              ": true;")]
# the rounded taps' cubic as Horner on tap differences (2 c3, 2 c2, 2 c1,
# then three FMAs in u and u / 2)
HORNER = [(r"(template <int METHOD, typename V, int Q>\n__device__ __forceinline__ V lp_sample)",
           lambda m: """template <int M_>
__device__ __forceinline__ float tap_sample(float u, float4 w, float4 p) {
  if constexpr (M_ == CUBIC) {
    const float a = (p.w - p.x) + 3.f * (p.y - p.z);
    const float b = (p.x + p.z) - 2.f * p.y - a;
    return fmaf(0.5f * u, fmaf(u, fmaf(u, a, b), p.z - p.x), p.y);
  } else {
    return dot4(w, p);
  }
}

""" + m.group(1)),
          (r"const float4 w = METHOD == CUBIC \? cubic_w\(u\) : lanczos_w\(u\);",
           "const float4 w = METHOD == CUBIC ? float4{} : lanczos_w(u);"),
          (r"dot4\(w, (bf_taps|i8_taps)\(", r"tap_sample<METHOD>(u, w, \1(")]
# int8 taps widened by a sign extension and a conversion (I2F)
I2F = [(r"(__device__ __forceinline__ float4 i8_taps\(unsigned w\) \{\n).*?\n\}",
        lambda m: m.group(1) + """  return make_float4((float)((int)(w << 24) >> 24), (float)((int)(w << 16) >> 24),
                     (float)((int)(w << 8) >> 24), (float)((int)w >> 24));
}""")]
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


def _lp_source(src: str, cfg: dict) -> str:
    """das.cu with the edits of an lp sweep configuration: ``reads`` that
    builds every form (``form``), Horner on tap differences (``horner``),
    the sign extension and I2F widening of int8 taps (``i2f``)."""
    subs = READS_ALL + (HORNER if cfg.get("horner") else []) + (I2F if cfg.get("i2f") else [])
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src, flags=re.S)
        assert n >= 1, pat
    return src


def _picmus_iq(torch, qt):
    """chip_smoke.py phase 23's system (PICMUS PW75: an L11-4v's 128
    elements, 75 plane waves over +-16 degrees, 512^2 px over x +-18 mm, z
    10-50 mm) and seeded complex traces for it, (1536, 128, 75, 4)
    complex64 at 4 fc = 20.832 MHz, t0 0: (traces, (pi, pr, pv, nv),
    tx model, fs, fmod)."""
    import numpy as np

    fc, c0 = 5.208e6, 1540.0
    xdc = qt.TransducerArray(numel=128, pitch=0.3e-3, fc=fc)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.SequenceRadial(type="PW", angles=np.linspace(-16, 16, 75), c0=c0),
        scan=qt.ScanCartesian(x=np.linspace(-18e-3, 18e-3, 512),
                              z=np.linspace(10e-3, 50e-3, 512)), fs=4 * fc)
    pv, nv, model = us._tx_geometry()
    g = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn((1536, 128, 75, 4, 2), generator=g, device="cuda")
    return (torch.view_as_complex(x), (us._pixels(), us.rx.positions().T, pv, nv), model,
            4 * fc, fc)


def _picmus_grid(half_width=18e-3):
    """PICMUS PW75's geometry (an L11-4v's 128 elements at 0.3 mm, 75
    plane waves over +-16 degrees) and 512^2 px over x +-``half_width``, z
    10-50 mm, x fastest: (pi, pr, pv, nv) float32."""
    import numpy as np

    N, M = 128, 75
    Z, X = np.meshgrid(np.linspace(10e-3, 50e-3, 512),
                       np.linspace(-half_width, half_width, 512), indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1).astype(np.float32)
    xe = (np.arange(N) - (N - 1) / 2) * 0.3e-3
    pr = np.stack([xe, np.zeros(N), np.zeros(N)], -1).astype(np.float32)
    th = np.radians(np.linspace(-16.0, 16.0, M))
    nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)], -1).astype(np.float32)
    return pi, pr, np.zeros((M, 3), np.float32), nv


def _frame_sweep(args, cs, torch, das_cuda, cinv, res):
    """``--what framesweep`` (see the head of this file): res["frame_sweep"]
    {case: {"<fb> <layout>": ms, "rule": the package's fb}}."""
    import numpy as np
    from qups_tpu_torch import bench

    shipped = (das_cuda.frames_per_launch, das_cuda._launch_frames)
    g = torch.Generator(device="cuda").manual_seed(29)

    def traces(shape):
        x = torch.randn(shape + (2,), generator=g, device="cuda")
        return x[..., 0].contiguous(), torch.view_as_complex(x)

    picmus = traces((1664, 128, 75, 16))
    pitches = [("PICMUS RF", *_picmus_grid(), picmus, 20.832e6),
               ("PICMUS half pitch", *_picmus_grid(9e-3), picmus, 20.832e6)]
    pr, pv, nv = bench.plane_array(256, 256)
    pitches.append(("IQ headline", bench.pixels(1024)[:256 * 1024], pr, pv, nv,
                    traces((1024, 256, 256, 4)), 7.8125e6))
    kinds = [("cubic", "f32", False), ("cubic", "bf16pair", False), ("cubic", "i8x4", False)]
    kinds += [(m, "f32", c) for m in ("nearest", "linear", "lanczos3") for c in (False, True)]

    def plan(fb, layout):
        das_cuda.frames_per_launch = lambda *a, **k: fb
        das_cuda._launch_frames = lambda *a, **k: shipped[1](
            *a, **k, block=a[0].shape[3] if layout == "all" else None)

    for name, pi, pr, pv, nv, (xr, xc), fs in pitches:
        F = xr.shape[3]
        sigma = das_cuda.tap_stride(pi, cinv, fs)
        print(f"frame sweep {name}: {pi.shape[0]} px, tap stride {sigma:.3f}, {F} frames",
              flush=True)
        t0 = np.zeros(xr.shape[2], np.float32)
        for method, precision, cplx in kinds:
            case = f"{name} {method} {'complex' if cplx else 'real'} {precision}"
            call = lambda: das_cuda.das_sum(  # noqa: E731
                xc if cplx else xr, pi, pr, pv, nv, t0, cinv, fs=fs, tx_model="plane",
                method=method, precision=precision)
            row = {"rule": shipped[0](method, precision, cplx, sigma)}
            for fb in (1, 2, 4):
                for layout in ("all", "blocks") if fb < F else ("blocks",):
                    plan(fb, layout)
                    row[f"{fb} {layout}"] = cs._ms(call, 1 if method == "lanczos3" else args.reps)
                    das_cuda.frames_per_launch, das_cuda._launch_frames = shipped
            res["frame_sweep"][case] = row
            print(f"frame sweep [{case}]: {row}", flush=True)
        if name == "PICMUS RF":  # the keep kernel: one frame a launch
            case = f"{name} keep_rx cubic real f32"
            row = {"rule": das_cuda.KEEP_FRAMES}
            for layout in ("all", "blocks"):
                plan(das_cuda.KEEP_FRAMES, layout)
                row[f"1 {layout}"] = cs._ms(lambda: das_cuda.das_sum(
                    xr, pi, pr, pv, nv, t0, cinv, fs=fs, tx_model="plane", method="cubic",
                    keep_rx=True), args.reps)
                das_cuda.frames_per_launch, das_cuda._launch_frames = shipped
            res["frame_sweep"][case] = row
            print(f"frame sweep [{case}]: {row}", flush=True)


def _keep_source(src: str, cfg: dict) -> str:
    """das.cu with the keep kernel's edits ``cfg`` names (KEEP_CONSTANTS,
    ``shared``, ``prefetch``)."""
    subs = [(r"constexpr int %s = \d+;" % name, "constexpr int %s = %d;" % (name, cfg[key]))
            for key, name in KEEP_CONSTANTS.items() if key in cfg]
    subs += SWEEP_ONLY + RX_SUMS.get(cfg.get("rxsums"), [])
    subs += NO_PREFETCH if cfg.get("prefetch") is False else []
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        assert n >= 1, pat
    return src


def _keep_variants(cs, log, what):
    """Print das_keep_kernel's variants (registers, stack, spills) in an
    nvcc log, grouped by keep mode, weights, rotation and frames."""
    fns = {f: v for f, v in cs.ptxas_functions(log).items() if "das_keep_kernel" in f}
    rows = cs.keep_variants(log)
    groups = {}
    for r in rows:
        groups.setdefault((r[4], r[5], r[3], r[2]), []).append(r)
    for (keep, w, rot, cplx), v in sorted(groups.items()):
        print(f"{what}: das_keep_kernel {cs.KEEP_NAMES[keep]}{' weighted' if w else ''} "
              f"rotation {rot} {'complex' if cplx else 'real'}: {len(v)} variants, "
              f"{min(r[7] for r in v)}-{max(r[7] for r in v)} registers, stack "
              f"{max(r[8] for r in v)} bytes, spill stores {max(r[9] for r in v)} bytes")
    if fns and not rows:  # another package's kernel: its own template arguments
        regs = [v[0] for v in fns.values()]
        print(f"{what}: {len(fns)} das_keep_kernel variants, {min(regs)}-{max(regs)} "
              f"registers, stack {max(v[1] for v in fns.values())} bytes, spill stores "
              f"{max(v[2] for v in fns.values())} bytes")
    return rows


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
    ap.add_argument("--keep-configs", type=json.loads, default=KEEP_SWEEP,
                    help="the keep sweep's configurations, a JSON list of objects with any of "
                         + ", ".join(KEEP_CONSTANTS) + ", rxsums, prefetch, cases")
    ap.add_argument("--lp-configs", type=json.loads, default=LP_SWEEP,
                    help="the lp sweep's configurations, a JSON list of objects with any of "
                         "form, horner, i2f, cases")
    ap.add_argument("--methods", nargs="+", default=None,
                    help="the samplers of iq (default all) and keep (default nearest cubic)")
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
    res = {"root": root, "card": card, "ms": {}, "bits": {}, "sweep": {}, "keep_sweep": {},
           "lp_sweep": {}, "frame_sweep": {}, "variants": {}}
    builds = [("das", das_cuda.build), ("das_iq", lambda: das_cuda.build(iq=True))]
    keeping = "keep" in args.what or "keepsweep" in args.what
    if keeping:
        builds += [("das_keep", das_cuda.build_keep),
                   ("das_keep_iq", lambda: das_cuda.build_keep(iq=True)),
                   ("das_keep_i8", lambda: das_cuda.build_keep_q(2)),
                   ("das_keep_acc16", lambda: das_cuda.build_keep_q(3))]
    lp = "lp" in args.what or "lpsweep" in args.what
    if "framesweep" in args.what:
        builds += [("das_keep", das_cuda.build_keep), ("das_q1", lambda: das_cuda.build_q(1)),
                   ("das_q2", lambda: das_cuda.build_q(2))]
    if lp:
        builds += [("das_keep", das_cuda.build_keep), ("das_keep_acc16",
                                                        lambda: das_cuda.build_keep_q(3))]
        for q in (1, 2):
            builds += [(f"das_q{q}", lambda q=q: das_cuda.build_q(q)),
                       (f"das_q{q}_iq", lambda q=q: das_cuda.build_q(q, True)),
                       (f"das_keep_q{q}", lambda q=q: das_cuda.build_keep_q(q))]
    builds = list(dict(builds).items())
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per source, at once
        logs = dict(zip([b[0] for b in builds], ex.map(lambda b: b[1]()[1], builds)))
    if lp:
        for lib in ("das_q1", "das_q1_iq", "das_q2", "das_q2_iq", "das_keep_q1", "das_keep_q2"):
            f = cs.ptxas_functions(logs[lib])
            if f:
                regs = [v[0] for v in f.values()]
                print(f"{lib}: {len(f)} kernel variants, {min(regs)}-{max(regs)} registers, "
                      f"stack {max(v[1] for v in f.values())} bytes, spill stores "
                      f"{max(v[2] for v in f.values())} bytes", flush=True)
    for lib in ("das", "das_iq"):
        res["variants"][lib] = _variants(cs, logs[lib], lib)
    if keeping:
        for lib in ("das_keep", "das_keep_iq", "das_keep_i8", "das_keep_acc16"):
            res["variants"][lib] = _keep_variants(cs, logs[lib], lib)

    def timed(name, fn, reps):
        ms = cs._ms(fn, reps=reps)
        res["ms"][name] = ms
        print(f"{name}: {ms:.3f} ms (mean of {reps} after a warm-up)", flush=True)
        return ms

    def reps(method):
        return 1 if method == "lanczos3" else args.reps

    methods = tuple(args.methods or METHODS)

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
            for method in methods:
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

        def launch_frames_on_one_layout(x, method, fmod, launch, fb_max, precision="f32",
                                        scale=None, out=None, form=None):
            return shipped[1](x, method, fmod, launch, fb_max, precision, scale, form=form,
                              block=das_cuda._frames(x).shape[3])

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
    if "summed" in args.what or keeping:
        from qups_tpu_torch import bench

        n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
        x0, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
        xg = torch.as_tensor(x0).cuda()
        del x0
        pig = torch.as_tensor(pi).cuda()
        tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
        k1 = lambda method="cubic", **k: das_cuda.das_sum(  # noqa: E731
            xg, pig, pr, pv, nv, t0, cinv, tx_model="plane", fs=fs, method=method, **k)
        k2 = lambda method="cubic", **k: das_cuda.das_lut_sum(  # noqa: E731
            xg, tau_rx, tau_tx, t0, fs=fs, method=method, **k)
        if "summed" in args.what:
            timed("summed K1 cubic", k1, args.reps)
            timed("summed K2 cubic", k2, args.reps)
    if keeping:
        b = pr[:, 0].min() - 1e-4, pr[:, 0].max() + 1e-4
        fused = (qt.Fused("aperture_growth", f=1.5),
                 qt.Fused("acceptance_angle", theta=45.0),
                 qt.Fused("tx_parallelogram", xlo=float(b[0]), xhi=float(b[1])))

        def acc16(fn):
            os.environ["QUPS_DAS_ACC16"] = "1"
            try:
                return fn()
            finally:
                del os.environ["QUPS_DAS_ACC16"]

        iq, (qpi, qpr, qpv, qnv), _ = cs.iq_headline(torch, qt)
        x4 = iq.data
        x1 = x4[..., 0].contiguous()
        qpig = torch.as_tensor(qpi).cuda()
        kq = lambda xx, **k: das_cuda.das_sum(  # noqa: E731
            xx, qpig, qpr, qpv, qnv, iq.t0, cinv, tx_model="plane", fs=iq.fs,
            method="cubic", fmod=FMOD, **k)
        cases = {}
        for method in tuple(args.methods or ("nearest", "cubic")):
            cases.update({
                f"keep_rx K1(c) {method}": lambda m=method: k1(m, keep_rx=True),
                f"keep_tx K1(c) {method}": lambda m=method: k1(m, keep_tx=True),
                f"fused apodization K1(d) {method}": lambda m=method: k1(m, apod=fused),
                f"keep_rx K2(c) {method}": lambda m=method: k2(m, keep_rx=True)})
        cases.update({
            "keep_rx i8x4 K1(e) cubic": lambda: k1(keep_rx=True, precision="i8x4"),
            "keep_rx f32 QUPS_DAS_ACC16 K1(e) cubic": lambda: acc16(lambda: k1(keep_rx=True)),
            "IQ one frame keep_rx fmod cubic": lambda: kq(x1, keep_rx=True),
            "IQ one frame keep_tx fmod cubic": lambda: kq(x1, keep_tx=True)})
        four = {"IQ 4 frames keep_tx fmod cubic": lambda: kq(x4, keep_tx=True),
                "IQ 4 frames fused fmod cubic": lambda: kq(x4, apod=fused)}
    if "keep" in args.what:
        for name, fn in cases.items():
            timed(name, fn, args.reps)
        for name in cases:  # the unrotated float32 keep_rx images' bits
            if name.startswith("keep_rx K") and "i8x4" not in name:
                out = cases[name]().contiguous()
                res["bits"][name] = hashlib.sha256(
                    out.view(torch.int32).cpu().numpy().tobytes()).hexdigest()
                print(f"{name}: sha256 {res['bits'][name]}", flush=True)
                del out
    if "keepsweep" in args.what:
        base = os.path.join(root, "qups_tpu_torch", "_build", "k1b_sweep")
        csrc = os.path.join(root, "qups_tpu_torch", "csrc")
        das_src = open(os.path.join(csrc, "das.cu")).read()
        sweep_cases = {k: v for k, v in {**cases, **four}.items()
                       if "nearest" not in k and "i8x4" not in k and "ACC16" not in k}
        edits = [c for c in args.keep_configs
                 if set(c) & (set(KEEP_CONSTANTS) | {"rxsums", "prefetch"})]
        jobs = []
        for cfg in edits:  # a copy of csrc/ a configuration, das.cu edited
            d = Path(base) / ("keep_" + re.sub(r"[^a-z0-9]+", "_", _name(cfg)))
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, d)
            src = _keep_source(das_src, cfg)
            (d / "das.cu").write_text(src)
            jobs += [(d / "das_keep.cu", src.encode()), (d / "das_keep_iq.cu", src.encode())]
        with ThreadPoolExecutor(max(1, len(jobs))) as ex:  # one nvcc per source, at once
            done = list(ex.map(lambda j: _nvcc._build(
                j[0], j[1], [_nvcc.nvcc(), *_nvcc.flags(j[0].stem)]), jobs))
        shipped = dict(_nvcc._loaded)

        def keep_sweep(key, cfg):
            names = [c for c in sweep_cases
                     if any(p in c for p in cfg.get("cases", "").split("|"))]
            res["keep_sweep"][key] = {c: cs._ms(sweep_cases[c], args.reps) for c in names}
            print(f"keep sweep [{key}]: {res['keep_sweep'][key]}", flush=True)

        keep_sweep("shipped", {})
        for cfg in args.keep_configs:
            key = _name(cfg)
            if cfg in edits:
                i = edits.index(cfg)
                libs = {"das_keep": done[2 * i], "das_keep_iq": done[2 * i + 1]}
                for lib in libs:
                    _keep_variants(cs, libs[lib][1], f"keep sweep [{key}] {lib}")
                _nvcc._loaded.update(libs)
            keep_sweep(key, cfg)
            _nvcc._loaded.clear()
            _nvcc._loaded.update(shipped)
        keep_sweep("shipped, again", {})
    if "framesweep" in args.what:
        _frame_sweep(args, cs, torch, das_cuda, cinv, res)
    if lp:
        lp_cases = _lp_cases(args, cs, torch, qt, das_cuda, delay_tables, cinv)
    if "lp" in args.what:
        for name, (fn, n) in lp_cases.items():
            timed(name, fn, n)
    if "lpsweep" in args.what:
        base = os.path.join(root, "qups_tpu_torch", "_build", "k1b_sweep")
        csrc = os.path.join(root, "qups_tpu_torch", "csrc")
        das_src = open(os.path.join(csrc, "das.cu")).read()
        libs = ("das_bf16", "das_bf16_iq", "das_i8", "das_i8_iq")
        copies, jobs = {}, []
        for cfg in args.lp_configs:  # a copy of csrc/ a distinct edit
            key = (bool(cfg.get("horner")), bool(cfg.get("i2f")))
            if key not in copies:
                d = Path(base) / ("lp_" + ("_".join(k for k, v in zip(("horner", "i2f"), key)
                                                    if v) or "forms"))
                shutil.rmtree(d, ignore_errors=True)
                shutil.copytree(csrc, d)
                src = _lp_source(das_src, cfg)
                (d / "das.cu").write_text(src)
                copies[key] = len(jobs)
                jobs += [(d / f"{lib}.cu", src.encode()) for lib in libs]
        with ThreadPoolExecutor(max(1, len(jobs))) as ex:  # one nvcc per source, at once
            done = list(ex.map(lambda j: _nvcc._build(
                j[0], j[1], [_nvcc.nvcc(), *_nvcc.flags(j[0].stem)]), jobs))
        shipped = (das_cuda.entry_form, dict(_nvcc._loaded))

        def lp_sweep(key, cfg):
            names = [c for c in lp_cases if not c.startswith("keep")  # the shipped keep units
                     and any(p in c for p in cfg.get("cases", "").split("|"))]
            res["lp_sweep"][key] = {c: cs._ms(lp_cases[c][0], lp_cases[c][1]) for c in names}
            print(f"lp sweep [{key}]: {res['lp_sweep'][key]}", flush=True)

        lp_sweep("shipped", {"cases": "|".join(sorted({c.get("cases", "")
                                                       for c in args.lp_configs}))})
        for cfg in args.lp_configs:
            key = _name(cfg)
            i = copies[(bool(cfg.get("horner")), bool(cfg.get("i2f")))]
            for j, lib in enumerate(libs):
                _nvcc._loaded[lib] = done[i + j]
                _variants(cs, done[i + j][1], f"lp sweep [{key}] {lib}")
            forms = cfg.get("form", {})
            das_cuda.entry_form = lambda m, p, c, keep=False, _f=forms: shipped[0](
                m, p, c, keep) if keep else _f.get(f"{m} {'complex' if c else 'real'} {p}",
                                                   shipped[0](m, p, c))
            lp_sweep(key, cfg)
            das_cuda.entry_form = shipped[0]
            _nvcc._loaded.clear()
            _nvcc._loaded.update(shipped[1])
        lp_sweep("shipped, again", {"cases": "|".join(sorted({c.get("cases", "")
                                                              for c in args.lp_configs}))})
    print(json.dumps(res))


def _lp_cases(args, cs, torch, qt, das_cuda, delay_tables, cinv):
    """{name: (call, reps)} of ``--what lp`` and ``lpsweep``: the headline's
    K1(e)/K2(e) and float32 calls, the layout kernel in each form, the
    keep calls, and the IQ headline and the PICMUS IQ call at each
    precision (see the head of this file)."""
    from qups_tpu_torch import bench

    n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
    x0, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
    xg = torch.as_tensor(x0).cuda()
    del x0
    pig = torch.as_tensor(pi).cuda()
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    reps = lambda m: 1 if m == "lanczos3" else args.reps  # noqa: E731
    k1 = lambda m, xx=xg, **k: das_cuda.das_sum(  # noqa: E731
        xx, pig, pr, pv, nv, t0, cinv, tx_model="plane", fs=fs, method=m, **k)
    k2 = lambda m, xx=xg, **k: das_cuda.das_lut_sum(  # noqa: E731
        xx, tau_rx, tau_tx, t0, fs=fs, method=m, **k)
    takes = {"f32": METHODS, "bf16pair": METHODS, "bf16": ("cubic",),
             "i8x4": ("cubic", "lanczos3")}
    cases = {}
    for kn, kern in (("K1", k1), ("K2", k2)):
        for p, ms in takes.items():
            for m in ms:
                if not (kn == "K2" and p == "bf16"):
                    cases[f"{kn} real {m} {p}"] = (lambda k=kern, m=m, p=p: k(m, precision=p),
                                                    reps(m))
    forms = getattr(das_cuda, "FORMS", None)
    s8 = das_cuda.i8_scale(xg)
    for p, form in (("f32", None), ("bf16pair", "bf16"), ("i8x4", "i8"), ("bf16pair", "f32c"),
                    ("i8x4", "f32c"), ("i8x4", "h16")):
        if form in ("f32c", "h16") and forms is None:
            continue  # the parent's package: the rounded taps alone
        kw = dict(precision=p, scale=s8 if p == "i8x4" else None)
        if form in ("f32c", "h16"):
            kw["form"] = form
        cases[f"layout kernel alone real cubic {p} {form or 'f32'}"] = (
            lambda kw=kw: das_cuda.trace_layout(xg, "cubic", **kw), args.reps)

    def acc16(fn):
        os.environ["QUPS_DAS_ACC16"] = "1"
        try:
            return fn()
        finally:
            del os.environ["QUPS_DAS_ACC16"]

    cases.update({
        "keep_rx real cubic i8x4": (lambda: k1("cubic", keep_rx=True, precision="i8x4"), 2),
        "keep_tx real cubic i8x4": (lambda: k1("cubic", keep_tx=True, precision="i8x4"), 2),
        "keep_rx real cubic bf16pair": (lambda: k1("cubic", keep_rx=True, precision="bf16pair"),
                                        2),
        "keep_rx real cubic f32 QUPS_DAS_ACC16": (lambda: acc16(lambda: k1("cubic",
                                                                           keep_rx=True)), 2),
        "keep_rx real cubic f32": (lambda: k1("cubic", keep_rx=True), 2)})
    iq, (qpi, qpr, qpv, qnv), _ = cs.iq_headline(torch, qt)
    qpig = torch.as_tensor(qpi).cuda()
    xp, (ppi, ppr, ppv, pnv), model, pfs, pfc = _picmus_iq(torch, qt)
    ppig = torch.as_tensor(ppi, dtype=torch.float32).cuda()
    for p in ("f32", "bf16pair", "i8x4"):
        for m in ("cubic", "lanczos3"):
            if m == "lanczos3" and p != "i8x4":
                continue
            cases[f"IQ {m} {p} 4 frames fmod"] = (lambda m=m, p=p: das_cuda.das_sum(
                iq.data, qpig, qpr, qpv, qnv, iq.t0, cinv, tx_model="plane", fs=iq.fs,
                method=m, fmod=FMOD, precision=p), reps(m))
        cases[f"PICMUS IQ cubic {p} 4 frames fmod"] = (lambda p=p: das_cuda.das_sum(
            xp, ppig, ppr, ppv, pnv, 0.0, cinv, tx_model=model, fs=pfs, method="cubic",
            fmod=pfc, precision=p), args.reps)
    return cases


if __name__ == "__main__":
    main()
