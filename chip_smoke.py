#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``qups_tpu_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds kernels K1 and K2 (``qups_tpu_torch/csrc/das.cu``, delay-and-sum
from geometry and from delay tables, with the layout kernel that writes the
traces into the layout they read; ``das_iq.cu``, the same body, their
remodulating variants K1(b) and K2(b); ``das_keep.cu`` and
``das_keep_iq.cu``, the same body's keep kernel: keep modes and
apodization weights, K1(c), K1(d) and K2(c), with a variant per keep mode
and weighting, keep_rx's sums in registers, and the short rotation), K3
(``qups_tpu_torch/csrc/greens_freq.cu``, the frequency-domain simulator's
per-bin GEMM, with its bf16 and directivity variants), K4
(``qups_tpu_torch/csrc/fdbf.cu``, the frequency-domain adjoint beamformer),
K5 (``qups_tpu_torch/csrc/greens_splat.cu``, the time-domain splat
simulator) and the splat's finish kernel (``csrc/greens_finish.cu``) with
nvcc, one process per source, all at once (with the reduced-precision
units of K1 and K2, one per entry type and rotation: ``das_bf16.cu``,
``das_i8.cu``, ``das_keep_bf16.cu``, ``das_keep_i8.cu``,
``das_keep_acc16.cu`` and their ``_iq`` twins, K1(e) and K2(e)), and
the eikonal solver (``csrc/msfm.cpp``, host C++, with the host compiler),
and runs:

0. the environment: card name and power limit, torch and CUDA versions,
   nvcc version, kernel build times, ptxas registers, spills, stack frames
   and shared memory (K1(b)/K2(b)'s rotating variants by rotation: the
   short rotation's with no stack frame and, in the SASS, no local memory;
   das_keep_kernel's variants by keep mode, weights, rotation and frames:
   their registers, no spills, and the short rotation's with no stack
   frame and no local memory),
   the FFMA count in the SASS (``cuobjdump -sass``) of
   the nearest variants of K1 and K2 (0 without remodulation: their delays
   are never contracted), and the
   tensor-core instructions (HMMA / HGMMA) in the bf16 variants of K3 and
   K4;
1. K1 against its plain PyTorch version on the card, for every transmit
   model x sampler, real and complex traces, with delays that fall off both
   ends of the traces; the layout kernel against its plain version, bit for
   bit;
2. K3 against its plain version at the shapes the main path gives it, and
   on a 4096-scatterer cloud; at the main path's shapes its bound and a
   cuBLAS yardstick;
3. the main path at a realistic size, unmodified: an L11-5v FSA system (128
   elements, 256 x 256 pixels), ``us.DAS(us.greens(scat))`` with no
   ``device=`` (the simulators default to the card), which runs K3 and then
   K1 on the complex traces, with the
   point-spread-function check (each target's peak within 1.1 mm) and the
   comparison with the same path through the plain versions; ``fmod``, a
   frame dim and ``method='cubic2x'`` through K1 against the plain path;
   apodized and aperture-coherence imaging: DAS with fused aperture growth
   and acceptance angle and with the dense ``ap_aperture_growth`` (K1(d)),
   ``keep_rx``, ``keep_tx`` and ``coherence_image`` with cohfac and slsc
   (K1(c)), launches counted, each with the PSF check and against
   ``kernel='plain'``; the reduced trace precisions (K1(e)): DAS in
   bf16pair and i8x4 and ``coherence_image`` in bf16pair, counted, each
   with the PSF check, against its plain version at the same precision and
   within 2e-2 of ``kernel='plain'`` (float32); complex128 traces cast;
4. the headline size, 1024^2 pixels x 256 tx x 256 rx, T = 4096, every
   sampler (lanczos3 one repetition), timed with CUDA events, and the
   layout kernel alone beside its plain version and its bound;
5. K2 against its plain version for the four samplers, real and complex
   traces, on geometric tables with a random perturbation of up to +-2
   samples, with delays off both ends of the traces; the layout kernel
   again;
6. K4 against its plain version for keep '', 'rx' and 'tx', precision
   'f32' and 'bf16', with 5 plane waves and with 128 FSA transmits, on the
   bins of a -40 dB band; and the phase error of its phasors (the special
   function unit's sincos) against the accurate sincosf;
7. the plane-wave imaging demo (``examples/demo_imaging.py``'s system and
   phantom) unmodified: ``us.greens(scat, device="cuda")`` (K3, then
   focusTx), ``us.DAS`` (K1), ``us.bfDAS`` and ``us.DAS`` with a sound-speed
   map (K2), ``us.bfAdjoint`` bf16 and f32 (K4), each with the PSF check and
   the comparison with ``kernel='plain'``, and its fourth image,
   ``us.coherence_image(chd)`` (K1(c)); ``bfDAS`` with ``fmod`` and with a
   frame dim (K2(b)), ``bfDAS(keep_rx=True)`` and the c0-map DAS with a
   dense weight (K2(c)) against the plain path; ``bfDAS`` in i8x4 (K2(e),
   one scale per call) and the ``coherence_image`` in bf16pair (K1(e)),
   counted, as phase 3's; complex128 traces cast (no option of any kernel
   raises ``NotImplementedError`` any more: K4(b), phase 19, was the last);
8. K2 (every sampler) and K4 at the headline size, each beside its plain
   version, K4 also beside its bound and a cuBLAS yardstick of its products;
9. K5 against its plain version at the main path's shapes (L11-5v, 10^4
   speckle scatterers), on the device plan: the deposit grid (and a second
   launch, bit for bit) and the traces of ``greens_tiled`` for the linear
   and cubic bases x the system's complex kernel and its real part, and a
   sub-element case; the finish kernel against its plain version on each
   grid; the device plan against the numpy plan (the JAX package's): the
   same P0, Gtime and scatterers, row offsets within 1, and the traces
   against the plain splat and finish run on the numpy plan; the visits K5
   makes beside those the tile windows of the numpy plan would make;
10. the simulator path unmodified on the same system and phantom: ``greens``
   with ``impl='pallas'`` (K5) and with ``precision='bf16'`` (K3(b)),
   ``simus`` with the soft and the hard baffle (K3(c)), ``calc_scat_all``
   (K3) and ``calc_scat_multi`` with the plane-wave demo sequence, fused and
   with ``bsize=1`` (K5), and ``calc_hp`` with a focused sequence; launch
   counts zeroed just before and read just after; each call against
   ``kernel='plain'``; the PSF check through ``us.DAS`` on the 5-target
   phantom; K3(c)'s time against its plain version; the K3(b)
   control (K3(a)'s traces against the bf16 plain version fail TOL_K3B);
11. K3(b) and K3(c) at 10^5 scatterers x 128 x 128 elements (bf16 over the
   full band, 1025 bins; the directivity over the bins simus selects, ~850),
   each beside its plain version and a cuBLAS yardstick, both timed on 32
   bins and scaled to the band, and its bound, with the K3(b) control on
   the 32 bins; K3(a) on K3(b)'s band beside its bound;
12. K1(b) and K2(b) against their plain versions: every sampler x (the
   three transmit models | perturbed tables) x (real traces with fmod,
   complex with and without) x frames 1, 3, 6 (a ragged block of the 4 a
   launch takes) and dims (2, 3), delays off both ends, one launch per block
   of the plan's frames; the layout kernel with frames bit for bit; the
   short rotation (``das_sincos_probe``) within 2^-21 of float64 over
   |phase| <= PHASE_MAX; fmod 4 GHz (phases past PHASE_MAX) through the
   sincosf variants against the plain version;
13. the IQ ensemble path on the demo's system, unmodified, no ``device=``:
   4 frames of a 5-target phantom (0.3 mm deeper each frame) through
   ``greens`` (K3), ``join``, ``hilbert``, ``downmix``, ``resample``, then
   ``DAS`` (K1(b)), ``bfDAS`` and the c0-map ``DAS`` (K2(b)), ``cubic2x``
   and ``bfAdjoint`` (K4), all with ``fmod = fc``; launch counts zeroed just
   before and read just after; each frame's PSF; each call against
   ``kernel='plain'``;
14. the headline in IQ: 4096 x 256 x 256 x 4 frames at 31.25 MHz (frame 0
   ``bench.das_problem``'s, three seeded draws) through ``hilbert``,
   ``downmix(5 MHz)``, ``resample(fs / 4)`` (timed), then K1(b) and K2(b)
   for every sampler: 4 frames in one call and 4 one-frame calls, each with
   and without fmod, with CUDA events, each against the plain version on
   every 64th pixel, beside its bound; the rotation's cost (fmod - none)
   per sampler and the frames a launch and layout of the plan;
15. K1(c), K1(d) and K2(c) against their plain versions at phase 12's
   shapes: every keep mode x each fused kind, two mixed and two dense
   weights x (the three transmit models | perturbed tables) x real / complex
   +- fmod x frames 1 and 3 in turn, nearest and cubic (keep_rx: every
   sampler); then the keep kernel's edges at N 100 (a sub-chunk of
   KEEP_NCK or KEEP_NCK_WIDE receivers past each chunk's end): each keep mode unweighted and
   weighted x frames 1, 3 x no rotation, the short rotation and sincosf
   (phases past PHASE_MAX), two launches bit for bit, the launches counted;
16. the headline, 1024^2 x 256 x 256, T 4096, cubic: keep_rx, keep_tx, the
   apodized summed call (K1(c), K1(d)), K2 keep_rx (K2(c)), and
   coherence_image's keep_rx call and its reduction (cohfac, slsc); keep_rx
   and keep_tx on one frame of phase 14's IQ headline with fmod; each
   against the plain version on every 64th pixel, beside its bound;
17. K1(e) and K2(e) against their plain versions at phase 12's shapes: the
   layout kernel's bf16 and int8 entries bit for bit; every precision
   (bf16pair, bf16 (K1), i8x4) x each sampler it takes x (the three
   transmit models | perturbed tables) x two of real / real + fmod /
   complex +- fmod x frames 1 | 3; keep modes x weights in bf16pair and
   i8x4; the bfloat16 kept sums of ``QUPS_DAS_ACC16``;
18. the headline at each reduced precision: K1(e) and K2(e) for every
   sampler each precision takes, the layout kernel alone in each entry
   width, the IQ headline in bf16pair cubic (phase 14's traces, 4 frames)
   and keep_rx in i8x4 and, on float32 traces, with the bfloat16 kept sums
   of ``QUPS_DAS_ACC16``, each beside the float32 time, the plain version
   on every 64th pixel and its bound;
19. K4(b): the phasor table kernel against its plain version, and K4
   against its plain version at the volumetric path's arrays (N = M = 1024,
   the volume's tables on every 64th voxel, 16 bins): V = 1024 in every
   keep mode and precision (bf16 on the wide route: phasor tables in device
   memory, 128-pixel blocks; f32 keep_rx by chunks of conj(Ahat)), keep_rx
   at V = 300 in f32 in one pass and by forced chunks, in bf16 with the
   wide route's budget cut to groups of bins and chunks of voxels (bit for
   bit against one chunk), every call twice, bit for bit; then the
   volumetric path unmodified, no ``device=``: a 32 x 32 matrix array
   (0.3 mm, 3 MHz), FSA over its 1024 elements, 64^3 voxels, 5 targets,
   ``us.greens`` (K3) and ``us.bfAdjoint(max_bins=64)`` keep '' and keep_rx
   (K4, V = N = M = 1024), launches counted (K4 and the phasor table
   kernel), the PSF in 3-D; K4 bf16 keep '', keep_rx and keep_tx at the
   volume timed with CUDA events beside the plain version on every 64th
   voxel, the bound and its share, and the bf16 ``torch.bmm`` yardstick of
   the products; the phasor tables' own time;
20. the eikonal path on the main system (phase 3's), no ``device=``:
   ``us.bfEikonal`` on the default grid (host fast marching, ``msfm``, then
   K2 through ``bfDASLUT``) in a homogeneous medium (the PSF, and each
   target's peak within a pixel of ``bfDAS``'s, correlation > 0.9) and
   under a 1300 m/s layer over the first 5 mm (the on-axis target at 28 mm
   within 1.1 mm, closer than ``bfDAS``'s); K2 launches counted; each call
   against ``kernel='plain'``; the host solve, the tables, their upload and
   K2 timed apart;
21. REFoCUS and Stolt migration, no ``device=``: the ``bench_refocus`` cell
   (T 4096, N = M = 256, a 256 x 256 Hadamard encoding, fs 31.25 MHz):
   ``us.refocus`` cold (operator built, then applied), cached, and with the
   default gamma (the spectral norm on the path), the re-encoded decode
   against the traces; the operator's steps with CUDA events (the norm from
   the Gram matrix by ``eigvalsh``, the solve, the apply) and the norm's
   alternatives (cuSOLVER's batched ``gesvda``, ``matrix_norm(ord=2)``)
   against the exact norm, and ``gesvda`` on a rank-1 bin; the decode as
   imaging on the main system: ``greens`` (K3) ->
   ``focusTx`` onto a 128 x 128 Hadamard encoding -> ``refocus(gamma=0)``
   -> ``DAS`` (K1, launches counted), the decoded FSA within 0.05 of the
   original's peak, the PSF; the ``bench_migration`` cell (4096 x 256 x
   16, s per frame); ``bfMigration`` on the demo system with the PSF; the
   card's ``bfMigration`` and ``refocus`` against the port's
   ``device="cpu"`` runs on the demo's shapes;
22. the full-wave simulator and the ray path integrals, no ``device=``: the
   ``bench_fdtd`` cell (225^2, 400 steps: ms a step, kernels a step and
   device busy time from torch.profiler, the record against the
   ``device="cpu"`` run); ``kspaceFirstOrder`` on the demo system's default
   grid (lambda / 4) through 20 density blobs, 'nearest', then ``DAS`` (K1,
   launches counted) with the PSF, the wall, ms a step and node-steps/s;
   ``kspace_sim_3d`` on 48^3 and ``kspace_sim_1d`` against their CPU runs
   with the free-field and reflection times; ``ray_paths_device`` on 256^2
   x 16384 rays between two facing 128-element lines against the host's
   float64 weights on every 64th ray and each ray's length; and
   ``global_average_c`` through phase 20's layered medium;
23. the Vantage import path, under the port's profiler: PICMUS's
   plane-wave acquisition (an L11-4v, 128 elements, 75 plane waves over
   +-16 degrees, fs = 4 fc = 20.832 MHz) of 5 point targets, 4 frames,
   simulated with ``us.greens`` (K3), written as a Vantage workspace
   (``RcvData`` int16 through a permuted ``ConnectorES``, ``Receive``,
   ``TX``, ``Trans``; ~128 MB) with scipy's ``savemat``, read back with
   ``interop.load_verasonics`` (the traces equal the samples written, bit
   for bit), then ``us.DAS`` on K1(b) (RF frames) and, after ``hilbert``
   and ``downmix`` on the card, with ``fmod`` (IQ), 512^2 px; launches
   counted; each frame's PSF; each image against the plain version on
   every 64th pixel; ``io.save_chd``/``load_chd``, ``save_checkpoint``/
   ``load_checkpoint(like=)`` and ``interop.save_mat``/``load_mat`` round
   trips bit for bit; a DAS under ``utils.trace`` and ``annotate('das')``
   whose Chrome trace holds ``das_frames_kernel`` under the annotation;
   host seconds by ``utils.Timer``, DAS ms by CUDA events. The phase
   imports neither h5py nor matplotlib;
24. several devices from one process (``qups_tpu_torch/parallel``): four
   shards of the card, ``make_mesh([cuda:0] * 4, axes=('rx', 'tx'),
   shape=(2, 2))``, and ``make_mesh()`` (every card; one here, whose result
   equals the single-device call bit for bit). The headline (1024^2 x 256
   x 256, T 4096, cubic) through ``das_sharded_pallas`` summed (K1),
   bf16pair (K1(e)), ``post='cohfac'`` and ``'slsc'`` (K1(c)) and
   ``us.coherence_image(mesh=)``; ``das_lut_sharded_pallas`` on its tables
   (K2); ``us.greens(mesh=, impl='freq')`` on 10^4 speckle scatterers (K3);
   ``bf_adjoint_sharded`` at phase 8's adjoint headline (K4, bit for bit or
   within its limit); ``kspaceFirstOrder(mesh=)`` on a 225^2 grid against
   the loop; ``refocus_sharded``, ``focus_tx_freq_sharded`` and
   ``migration_sharded`` on phase 21's cells; each against the
   single-device call, its launches counted (K1, K2, K3, K4 once per shard,
   the layout kernel with K1 and K2), each timed beside the single-device
   call (the sharding tax); then the cheat sheet as ``python -m
   qups_tpu_torch.examples.cheat_sheet``;
25. the port's benchmark entry points, in this process with their launches
   counted: ``qups_tpu_torch.bench.main()`` at full size (cubic float32
   with linear beside it, then bf16pair) and every sweep of
   ``qups_tpu_torch.benches`` (``QUPS_BENCH_BUDGET`` cut to
   ``BENCH_BUDGET``), each line printed; the headline's check equal to
   phase 4's sum|img| and its rate within ``BENCH_RATE`` of phase 4's; K1,
   K1(c), K1(e), K2, K3, K4 and K5 each launched on the bench path; then
   ``python -m qups_tpu_torch.bench`` at ``QUPS_BENCH_SIZE=small`` as a
   user runs it;
26. the counterparts of the JAX package's kernel-level entry points, once
   with their launches counted, then each beside the method call that
   launches the same kernel, timed in turns: ``das_tiled`` (K1),
   ``das_lut_plan`` and ``das_lut_tiled`` (K2) at the headline (1024^2 x
   256 x 256, T 4096, cubic) against ``das_sum`` / ``das_lut_sum``, bit for
   bit; ``prep_sharded`` / ``prep_lut_sharded`` on a 2 x 2 grid, their four
   shards launched and summed, against the single call and the mesh call
   on [cuda:0] x 4; ``bf_adjoint_tiled`` (K4) at phase 8's adjoint
   headline; ``freq_gemm_cuda`` (K3, K3(b)) and ``simus_spectrum_cuda``
   (K3(c)) at phase 11's 10^5 scatterers, bit for bit against the greens
   and simus GEMM passes; each against its plain version on every 64th
   pixel (K3: 32 bins); ``self_c0``.

Every check is an assert. The line before the last is the kernels' JSON
record (launches on the main path, errors, ms beside the plain version's,
the bound with what bounds it, the PyTorch yardstick where one call
computes the products, and phase 26's entry points that launch the kernel,
each with its time beside its method's); the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits with code 1 and prints no result.
"""
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TOL = 1e-4  # max|kernel - plain| < TOL * max|plain|: the float32 standard
BAND = 2e-2  # a reduced trace precision against float32, as the JAX package's tests hold it
TOL_BF16 = 2e-3  # K4 with bf16 dot operands against the plain version at bf16
# K3(b) against the plain version at bf16: both round the same operands. The
# limit sits between the sound reading and a control, K3(a)'s float32
# operands against the bf16 plain version, which phases 10 and 11 take and
# require to fail it, so a launch that skips the rounding cannot pass.
TOL_K3B = 2e-4


# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# a kernel's bound is the larger of its bytes over the memory rate and its
# operations over the rate of their type.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12    # float32 outside the tensor cores
BF16_FLOPS = 989e12  # bf16 on the tensor cores


def bound(flops, peak, nbytes):
    """(least ms, 'operations' or 'bytes'): the card's bound for ``flops``
    at ``peak`` and ``nbytes`` read or written once."""
    t_op, t_mem = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def _share(what, ms, b):
    print(f"{what}: {ms:.3f} ms against a bound of {b[0]:.3f} ms ({b[1]}), "
          f"{100 * b[0] / ms:.1f} % of it")


def _ms(fn, reps=3, warm=True):
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up
    (none with ``warm=False``, where the caller has just run ``fn``), timed
    with CUDA events."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Errors:
    """The worst relative error of one kernel against its plain version,
    with its absolute error and the check it came from."""

    def __init__(self):
        self.rel, self.abs, self.where = -1.0, 0.0, ""

    def add(self, got, ref, where):
        """Record one comparison; return (max abs error, relative error),
        the relative error being max|got - ref| / max|ref|."""
        assert got.shape == ref.shape and got.dtype == ref.dtype, \
            (where, got.shape, ref.shape, got.dtype, ref.dtype)
        a = float((got - ref).abs().max())
        r = a / float(ref.abs().max())
        if r > self.rel:
            self.rel, self.abs, self.where = r, a, where
        return a, r


def _line_geometry(n, N, M, model):
    """Pixels (n*n, 3) on x in +-15 mm, z in 5-45 mm, z-major; a linear
    array of N receivers; M transmits of the given model."""
    xs = np.linspace(-15e-3, 15e-3, n)
    zs = np.linspace(5e-3, 45e-3, n)
    Z, X = np.meshgrid(zs, xs, indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1).astype(np.float32)
    pr = np.stack([np.linspace(-19e-3, 19e-3, N), np.zeros(N), np.zeros(N)], -1)
    if model == "plane":
        th = np.radians(np.linspace(-9, 9, M))
        pv = np.zeros((M, 3))
        nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)], -1)
    else:  # diverging: sources behind the array; virtual: foci in front
        zf = -10e-3 if model == "diverging" else 20e-3
        pv = np.stack([np.linspace(-10e-3, 10e-3, M), np.zeros(M), np.full(M, zf)], -1)
        nv = np.tile([0.0, 0.0, 1.0], (M, 1))
    return pi, pr.astype(np.float32), pv.astype(np.float32), nv.astype(np.float32)


# das_frames_kernel's template arguments in a mangled name: source, sampler,
# sample type, rotation (0 none, 1 sincos_reduced, 2 sincosf), frames a
# launch, entry type
FRAMES_VARIANT = re.compile(
    r"das_frames_kernelILi(\d)ELi(\d)E(?:f|6float2)Li(\d)ELi(\d)ELi(\d)E")


def ptxas_functions(log):
    """{mangled kernel name: (registers, stack frame bytes, spill store
    bytes)} from nvcc's -Xptxas=-v log."""
    out, fn, stack, spill = {}, None, 0, 0
    for line in log.splitlines():
        if "Function properties for " in line:
            fn = line.split("Function properties for ")[1].strip()
        elif fn and "bytes stack frame" in line:
            stack = int(line.split("bytes stack frame")[0].split()[-1])
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif fn and "Used " in line and " registers" in line:
            out[fn] = (int(line.split("Used ")[1].split()[0]), stack, spill)
            fn = None
    return out


# das_keep_kernel's: source, sampler, sample type ('f' real, '6float2'
# complex), rotation, keep mode (4: the launch's), weights, entry type
KEEP_VARIANT = re.compile(
    r"das_keep_kernelILi(\d)ELi(\d)E(f|6float2)Li(\d)ELi(\d)ELb([01])ELi(\d)E")
KEEP_NAMES = {0: "summed", 1: "keep_rx", 2: "keep_tx", 3: "keep_both", 4: "any mode"}


def keep_variants(log):
    """das_keep_kernel's variants in a build log: [(source, sampler,
    complex, rotation, keep mode, weights, entry type, registers, stack,
    spills)]."""
    rows = []
    for fn, (regs, stack, spill) in ptxas_functions(log).items():
        m = KEEP_VARIANT.search(fn)
        if m:
            g = m.groups()
            rows.append((int(g[0]), int(g[1]), int(g[2] != "f")) + tuple(int(v) for v in g[3:])
                        + (regs, stack, spill))
    return sorted(rows)


# the entry type (csrc/das.cu Prec) in a mangled name of das_kernel,
# das_frames_kernel or das_keep_kernel: the last template argument
ENTRY_VARIANT = re.compile(
    r"das_kernelILi\dELi\dE(?:f|6float2)Li(\d)E|"
    r"das_frames_kernelILi\dELi\dE(?:f|6float2)Li\dELi\dELi(\d)E|"
    r"das_keep_kernelILi\dELi\dE(?:f|6float2)Li\dELi\dELb[01]ELi(\d)E")
ENTRY_NAMES = {0: "F32", 1: "BF16", 2: "I8", 3: "F32X", 4: "H16"}


def entry_variants(log):
    """{entry type: [(registers, stack, spills)]} of the DAS kernels'
    variants in a build log."""
    out = {}
    for fn, v in ptxas_functions(log).items():
        m = ENTRY_VARIANT.search(fn)
        if m:
            out.setdefault(int(next(g for g in m.groups() if g is not None)), []).append(v)
    return out


def frames_variants(log):
    """das_frames_kernel's variants in a build log: [(source, sampler,
    rotation, frames a launch, entry type, registers, stack, spills)]."""
    rows = []
    for fn, (regs, stack, spill) in ptxas_functions(log).items():
        m = FRAMES_VARIANT.search(fn)
        if m:
            rows.append(tuple(int(v) for v in m.groups()) + (regs, stack, spill))
    return sorted(rows)


def phase0(torch, ops):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    assert smi.returncode == 0, smi.stderr
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    nv = subprocess.run([ops._nvcc.nvcc(), "--version"], capture_output=True, text=True)
    assert nv.returncode == 0, nv.stderr
    print(f"nvcc: {[l for l in nv.stdout.splitlines() if 'release' in l][0].strip()}")
    builds = (("K1+K2", ops.das_cuda.build),
              ("K1(b)+K2(b) fmod", lambda: ops.das_cuda.build(iq=True)),
              ("K1(c)/(d)+K2(c) keep and weights", ops.das_cuda.build_keep),
              ("K1(c)/(d)+K2(c) keep and weights, fmod",
               lambda: ops.das_cuda.build_keep(iq=True)),
              ("K1(c)/(d)+K2(c) keep and weights, fmod past PHASE_MAX",
               lambda: ops.das_cuda.build_keep(iq=True, wide=True)),
              ("K3", ops.greens_freq_cuda.build), ("K4", ops.fdbf_cuda.build),
              ("K5", ops.greens_cuda.build), ("finish", ops.greens_cuda.build_finish),
              ("msfm (host C++)", lambda: ops._nvcc.load_host("msfm")))
    dc = ops.das_cuda
    for q, what in ((1, "bf16"), (2, "int8")):  # K1(e), K2(e): one unit per entry type
        builds += ((f"K1(e)+K2(e) {what}", lambda q=q: dc.build_q(q)),
                   (f"K1(e)+K2(e) {what}, fmod", lambda q=q: dc.build_q(q, True)))
    for q, what in ((1, "bf16"), (2, "int8"), (dc.F32X, "float32, bf16 kept sums")):
        builds += ((f"K1(e)+K2(e) keep, {what}", lambda q=q: dc.build_keep_q(q)),
                   (f"K1(e)+K2(e) keep, {what}, fmod", lambda q=q: dc.build_keep_q(q, True)),
                   (f"K1(e)+K2(e) keep, {what}, fmod past PHASE_MAX",
                    lambda q=q: dc.build_keep_q(q, True, True)))

    def timed(build):
        t = time.perf_counter()
        _, log = build()
        return time.perf_counter() - t, log

    t = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per source, at once
        done = list(ex.map(lambda b: timed(b[1]), builds))
    print(f"kernel builds, in parallel: {time.perf_counter() - t:.3f} s")
    print("builds, each: " + ", ".join(f"{name} {dt:.3f} s"
                                        for (name, _), (dt, _) in zip(builds, done)))
    for (name, _), (dt, log) in zip(builds, done):
        print(f"{name} build: {dt:.3f} s")
        regs = [int(w.split()[0]) for w in log.split("Used ")[1:]]
        spills = sum(int(w.split("bytes spill stores")[0].split(",")[-1])
                     for w in log.splitlines() if "spill stores" in w)
        smem = [int(w.split("bytes smem")[0].split(",")[-1])
                for w in log.splitlines() if "bytes smem" in w]
        stack = [int(w.split("bytes stack frame")[0].split()[-1])
                 for w in log.splitlines() if "bytes stack frame" in w]
        if regs:
            print(f"  ptxas: {len(regs)} kernel variants, {min(regs)}-{max(regs)} "
                  f"registers, {spills} bytes of spill stores, stack frames "
                  f"{min(stack)}-{max(stack)} bytes"
                  + (f", {min(smem)}-{max(smem)} bytes of shared memory" if smem else ""))
        if "fmod" in name and name.startswith("K1(") and "keep" not in name:
            # K1(b)/K2(b)'s rotating variants: the short rotation's hold no
            # stack frame (no sincosf, no spills)
            fv = frames_variants(log)
            for rot, what in ((1, "sincos_reduced"), (2, "sincosf, phases past PHASE_MAX")):
                v = [r for r in fv if r[2] == rot]
                assert v, (name, rot)
                print(f"  das_frames_kernel, {what}: {len(v)} variants, "
                      f"{min(r[5] for r in v)}-{max(r[5] for r in v)} registers, stack frames "
                      f"{min(r[6] for r in v)}-{max(r[6] for r in v)} bytes, frames a launch "
                      f"{sorted({r[3] for r in v})}")
                assert rot != 1 or all(r[6] == 0 for r in v), (name, v)
        if name.startswith("K1(e)"):
            # the narrow units' variants by entry type: real cubic traces
            # read float32 coefficients (the float32 units), so these hold
            # no real cubic variant; H16 (complex cubic int8 taps) spills
            # nothing
            ev = entry_variants(log)
            print("  entry types: " + "; ".join(
                f"{ENTRY_NAMES[q]} {len(v)} variants, {min(r[0] for r in v)}-"
                f"{max(r[0] for r in v)} registers, spill stores {max(r[2] for r in v)} bytes"
                for q, v in sorted(ev.items())))
            assert all(r[2] == 0 for r in ev.get(4, [])), (name, ev.get(4))
            if "int8" in name:
                assert ev.get(4), name
        if "keep" in name:
            # das_keep_kernel: registers by (keep mode, weights, rotation,
            # sample type); no spills, and the short rotation's variants no
            # stack frame
            kv = keep_variants(log)
            assert kv, name
            for key in sorted({(r[4], r[5], r[3], r[2]) for r in kv}):
                v = [r for r in kv if (r[4], r[5], r[3], r[2]) == key]
                print(f"  das_keep_kernel {KEEP_NAMES[key[0]]}{' weighted' if key[1] else ''} "
                      f"rotation {key[2]} {'complex' if key[3] else 'real'}: {len(v)} variants, "
                      f"{min(r[7] for r in v)}-{max(r[7] for r in v)} registers, stack frames "
                      f"{min(r[8] for r in v)}-{max(r[8] for r in v)} bytes, spill stores "
                      f"{max(r[9] for r in v)} bytes at most")
            assert all(r[9] == 0 for r in kv), (name, [r for r in kv if r[9]])
            assert all(r[8] == 0 for r in kv if r[3] == 1), (name, [r for r in kv if r[3] == 1
                                                                    and r[8]])
    cuobjdump = os.path.join(os.path.dirname(ops._nvcc.nvcc()), "cuobjdump")

    def sass_counts(lib, ops_):
        """{kernel variant: count of SASS instructions naming one of ops_}."""
        path = ops._nvcc.load(lib)[0]._name
        sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True)
        assert sass.returncode == 0, sass.stderr
        counts, fn = {}, None
        for line in sass.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = 0
            elif fn and any(f" {op}" in line for op in ops_):
                counts[fn] += 1
        return os.path.basename(path), counts

    # K1's and K2's delays are written with round-to-nearest intrinsics,
    # which nvcc never contracts: the nearest variants without remodulation,
    # whose only arithmetic is the delay path and the sums, must hold no
    # FFMA at all (the template arguments of das_kernel and
    # das_frames_kernel begin <source, sampler, ...>: 4 sources x 2 value
    # types, one frame (das_kernel) and 4 frames); the remodulating
    # variants (das_iq.cu: the short rotation's, one frame and the plan's
    # frames a launch, and the sincosf variants, the plan's alone) contract
    # their rotation
    n_iq = 4 * sum(2 if ops.das_cuda.frames_per_launch("nearest", cplx=c) == 1 else 3
                   for c in (False, True))
    for lib, n_near, zero in (("das", 16, True), ("das_iq", n_iq, False)):
        so, ffma = sass_counts(lib, ("FFMA",))
        das = {f: c for f, c in ffma.items() if re.search(r"das_(frames_)?kernelI", f)}
        nearest = {f: c for f, c in das.items()
                   if re.search(r"das_(frames_)?kernelILi\dELi0E", f)}
        other = {f: c for f, c in das.items() if f not in nearest}
        print(f"  {lib} SASS ({so}): {len(nearest)} nearest variants with "
              f"{min(nearest.values())}-{max(nearest.values())} FFMA each; {len(other)} "
              f"other variants with {min(other.values())}-{max(other.values())} FFMA each; "
              f"{len(ffma) - len(nearest) - len(other)} layout kernel variants")
        assert len(nearest) == n_near, nearest
        assert not zero or sum(nearest.values()) == 0, nearest
    # the short rotation's variants touch no local memory (sincosf's slow
    # path keeps its reduction there)
    for lib in ("das_iq", "das_bf16_iq", "das_i8_iq", "das_keep_iq", "das_keep_bf16_iq",
                "das_keep_i8_iq", "das_keep_acc16_iq"):
        so, local = sass_counts(lib, ("STL", "LDL"))
        short = {f: c for f, c in local.items()
                 if ((m := FRAMES_VARIANT.search(f)) and m.group(3) == "1")
                 or ((m := KEEP_VARIANT.search(f)) and m.group(4) == "1")}
        print(f"  {lib} SASS ({so}): {len(short)} variants of the short rotation with "
              f"{sum(short.values())} local loads and stores; the sincosf variants "
              f"{sum(c for f, c in local.items() if f not in short)}")
        assert short and sum(short.values()) == 0, short
    # the tensor-core instructions in the SASS of K3's and K4's variants: the
    # bf16 ones must have them (HMMA from mma.sync, HGMMA from wgmma)
    for name, lib, is_bf16 in (
            ("K3", "greens_freq", lambda f: "ELb1EEEv" in f),
            ("K4", "fdbf", lambda f: any(e in f for e in ("TcEngine", "TcChunked",
                                                          "wide_kernel", "wide_rx_kernel")))):
        path, counts = sass_counts(lib, ("HMMA", "HGMMA"))
        tc = {f: c for f, c in counts.items() if is_bf16(f)}
        other = {f: c for f, c in counts.items() if not is_bf16(f)}
        print(f"  {name} SASS ({path}): {len(tc)} bf16 variants with "
              f"{min(tc.values())}-{max(tc.values())} HMMA/HGMMA each; {len(other)} "
              f"float32 variants with {max(other.values())} at most")
        assert tc and min(tc.values()) > 0, (name, tc)
    return card


def _layout_parity(torch, das_cuda, lerrs, method, x, where):
    """Hold the layout kernel against its plain version, bit for bit."""
    got = das_cuda.trace_layout(x, method)
    ref = das_cuda.trace_layout_plain(x, method)
    lerrs.add(got, ref, where)
    assert torch.equal(got, ref), where


def _crossing_problem(torch, model, T, N, M, n, c0=1540.0):
    """_line_geometry with a t0 per transmit and an fs that put ti = 0 at
    10 % and ti = T-1 at 90 % of the delay range, so both trace ends are
    crossed. Returns (pi, pr, pv, nv, t0, fs, (share of ti < 0, share of
    ti > T-1))."""
    from qups_tpu_torch.ops.das import rx_distance, tx_distance

    pi, pr, pv, nv = _line_geometry(n, N, M, model)
    pig, prg, pvg, nvg = (torch.as_tensor(a).cuda() for a in (pi, pr, pv, nv))
    dr = rx_distance(pig, prg)
    dv = torch.stack([tx_distance(pig, pvg[m], nvg[m], model) for m in range(M)], 1)
    lo = float((dv.min(1).values + dr.min(1).values).min()) / c0
    hi = float((dv.max(1).values + dr.max(1).values).max()) / c0
    fs = (T - 1) / (0.8 * (hi - lo))
    t0 = (lo + 0.1 * (hi - lo) + np.linspace(0, 0.02 * (hi - lo), M)).astype(np.float32)
    t0g = torch.as_tensor(t0).cuda()
    ti = torch.stack([((dv[:, m, None] + dr) * np.float32(1 / c0) - t0g[m]) * fs
                      for m in range(M)])
    below, above = float((ti < 0).float().mean()), float((ti > T - 1).float().mean())
    assert below > 0 and above > 0, (model, below, above)
    return pi, pr, pv, nv, t0, fs, (below, above)


def _lut_problem(torch, T, N, M, n, seed, c0=1540.0):
    """The plane-wave problem of _crossing_problem as delay tables, plus a
    seeded perturbation of up to +-2 samples (not separable geometry).
    Returns (tau_rx, tau_tx, t0, fs, (share of ti < 0, share of ti > T-1))."""
    from qups_tpu_torch.ops.das import rx_distance, tx_distance

    pi, pr, pv, nv, t0, fs, _ = _crossing_problem(torch, "plane", T, N, M, n, c0)
    pi, pr, pv, nv = (torch.as_tensor(a).cuda() for a in (pi, pr, pv, nv))
    g = torch.Generator(device="cuda").manual_seed(seed)
    tau_rx = rx_distance(pi, pr) / c0
    tau_tx = torch.stack([tx_distance(pi, pv[m], nv[m], "plane") for m in range(M)], 1) / c0
    tau_rx = tau_rx + (torch.rand(tau_rx.shape, generator=g, device="cuda") * 4 - 2) / fs
    tau_tx = tau_tx + (torch.rand(tau_tx.shape, generator=g, device="cuda") * 4 - 2) / fs
    t0g = torch.as_tensor(t0).cuda()
    ti = torch.stack([((tau_tx[:, m, None] + tau_rx) - t0g[m]) * np.float32(fs)
                      for m in range(M)])
    below, above = float((ti < 0).float().mean()), float((ti > T - 1).float().mean())
    assert below > 0 and above > 0, (below, above)
    return tau_rx, tau_tx, t0, fs, (below, above)


def phase1(torch, das_cuda, errs, lerrs):
    """K1 vs plain for 3 transmit models x 4 samplers x real / complex; the
    layout kernel vs its plain version."""
    T, N, M, n, c0 = 2048, 128, 32, 256, 1540.0
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    xc = (x + 1j * rng.standard_normal((T, N, M))).astype(np.complex64)
    traces = {"real": torch.as_tensor(x).cuda(), "complex": torch.as_tensor(xc).cuda()}
    for model in ("plane", "diverging", "virtual"):
        pi, pr, pv, nv, t0, fs, (below, above) = _crossing_problem(torch, model, T, N, M, n)
        for kind, xg in traces.items():
            args = (xg, pi, pr, pv, nv, t0, np.float32(1 / c0))
            for method in ("nearest", "linear", "cubic", "lanczos3"):
                kw = dict(fs=fs, tx_model=model, method=method)
                got = das_cuda.das_sum(*args, **kw)
                torch.cuda.synchronize()
                ref = das_cuda.das_sum_plain(*args, **kw)
                a, r = errs.add(got, ref, f"phase1 {model} {method} {kind}")
                if model == "plane":
                    _layout_parity(torch, das_cuda, lerrs, method, xg,
                                   f"phase1 layout {method} {kind}")
                k_ms = _ms(lambda: das_cuda.das_sum(*args, **kw))
                p_ms = _ms(lambda: das_cuda.das_sum_plain(*args, **kw))
                print(f"phase1 {model:9s} {method:8s} {kind:7s} max_abs_err={a:.3e} "
                      f"rel={r:.3e} ti<0: {below:.3f} ti>T-1: {above:.3f} "
                      f"K1 {k_ms:.3f} ms plain {p_ms:.3f} ms  (T,N,M,I)={(T, N, M, n * n)}")
                assert r < TOL, (model, method, kind, r)


def _main_system(qt):
    """The main path's system: L11-5v, FSA over its 128 elements, 256 x 256
    pixels on x in +-15 mm, z in 5-45 mm; 5 point targets."""
    xdc = qt.TransducerArray.L11_5v()
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=128),
        scan=qt.ScanCartesian(x=np.linspace(-15e-3, 15e-3, 256),
                              z=np.linspace(5e-3, 45e-3, 256)))
    targets = np.array([[-10e-3, 0.0, 10e-3], [5e-3, 0.0, 17e-3], [0.0, 0.0, 25e-3],
                        [-6e-3, 0.0, 33e-3], [9e-3, 0.0, 40e-3]]).T  # (3, 5)
    return us, targets, qt.Scatterers(pos=targets, c0=1540.0)


def phase2(torch, qt, gfc, errs):
    """K3 vs plain at the main path's shapes, and on a 4096-scatterer cloud
    in the same geometry. Returns K3's and the plain GEMM's ms at the main
    path's shapes."""
    from qups_tpu_torch.ops.greens_freq import host_plan, prologue

    us, targets, scat = _main_system(qt)
    rng = np.random.default_rng(1)
    S = 4096
    cloud = np.stack([rng.uniform(-15e-3, 15e-3, S), np.zeros(S),
                      rng.uniform(5e-3, 45e-3, S)])
    out = None
    for what, sc in (("main path (5 targets)", scat),
                     ("cloud", qt.Scatterers(pos=cloud, amp=rng.uniform(0.5, 1.5, S),
                                             c0=1540.0))):
        ps, kern, pn, pv, kw = us._greens_problem(sc)
        plan = host_plan(kern, ps, pn, pv, T=kw["T"], s0=kw["s0"], t0k=kw["t0k"],
                         fs=kw["fs"], cinv=kw["cinv"], fsr=kw["fsr"], rtol=1e-6)
        ops = prologue(plan["phc"], ps, sc.amp, pn, pv, R0=kw["R0"], fsr=kw["fsr"],
                       device="cuda")
        g = dict(k0=plan["k0"], F=plan["k1"] - plan["k0"])
        got = gfc.freq_gemm(*ops, **g)
        torch.cuda.synchronize()
        ref = gfc.freq_gemm_plain(*ops, **g)
        a, r = errs.add(got, ref, f"phase2 {what}")
        k_ms = _ms(lambda: gfc.freq_gemm(*ops, **g))
        p_ms = _ms(lambda: gfc.freq_gemm_plain(*ops, **g))
        print(f"phase2 K3 {what}: (S, N, M, F) = {(ps.shape[0], pn.shape[0], pv.shape[0], g['F'])}, "
              f"L {plan['L']}, bins {plan['k0']}..{plan['k1']}; max_abs_err={a:.3e} "
              f"rel={r:.3e}; K3 {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        assert r < TOL, (what, r)
        if out is None:  # the main path's shapes: K3 against one cuBLAS CGEMM
            k = torch.arange(g["k0"], g["k0"] + g["F"], dtype=torch.float32, device="cuda")
            A = gfc._phasors(ops[0], ops[1], k, 0.0)
            B = gfc._phasors(ops[2], ops[3], k, 0.0)
            lib_ms = _ms(lambda: torch.bmm(A.transpose(1, 2), B))
            S_, N_, M_ = ps.shape[0], pn.shape[0], pv.shape[0]
            b = bound(8.0 * g["F"] * S_ * N_ * M_, F32_FLOPS,
                      8.0 * S_ * (N_ + M_) + 8.0 * g["F"] * N_ * M_)
            _share("phase2 K3 main path", k_ms, b)
            print(f"phase2 library yardstick, torch.bmm of the complex64 phasors (built "
                  f"outside the timing): {lib_ms:.3f} ms")
            out = (k_ms, p_ms, b, lib_ms)
    return out


def _sync_s(torch, fn):
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase3(torch, qt, ops, errs):
    """Sim -> image through the port's entry points, on the card. Returns the
    launches of each kernel in the main path's run."""
    das_cuda, gfc = ops.das_cuda, ops.greens_freq_cuda
    us, targets, scat = _main_system(qt)

    # no device= anywhere: the simulators default to the card
    das_cuda.LAUNCHES = das_cuda.LAYOUT_LAUNCHES = gfc.LAUNCHES = 0
    t = time.perf_counter()
    chd = us.greens(scat)
    b = us.DAS(chd)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t
    launches = {"das_k1": das_cuda.LAUNCHES, "das_layout": das_cuda.LAYOUT_LAUNCHES,
                "greens_freq_k3": gfc.LAUNCHES}
    print(f"phase3 main path us.DAS(us.greens(scat)), no device=: {t_path:.3f} s "
          f"(first call) -> traces {tuple(chd.data.shape)} {chd.data.dtype} on "
          f"{chd.data.device}, image {tuple(b.shape)} {b.dtype}; launches {launches}")
    assert all(v > 0 for v in launches.values()), launches
    assert chd.data.is_cuda and chd.data.is_complex()
    assert b.is_cuda and b.shape == tuple(us.scan.shape) + (1, 1)
    assert bool(torch.isfinite(b).all())

    img = b.abs().reshape(-1).cpu().numpy()
    P = us.scan.positions().reshape(3, -1)
    for k in range(targets.shape[1]):
        near = np.linalg.norm(P - targets[:, k:k + 1], axis=0) < 3e-3
        j = np.flatnonzero(near)[np.argmax(img[near])]
        d = float(np.linalg.norm(P[:, j] - targets[:, k]))
        print(f"phase3 target {k} at {targets[:, k] * 1e3} mm: peak at "
              f"{P[:, j] * 1e3} mm, {d * 1e3:.3f} mm off")
        assert d < 1.1e-3, (k, d)

    # the same path through the plain versions, on the card
    chd_p, t_sim_p = _sync_s(torch, lambda: us.greens(scat, device="cuda", kernel="plain"))
    ref, t_das_p = _sync_s(torch, lambda: us.DAS(chd_p, kernel="plain"))
    a, r = errs["greens_freq_k3"].add(chd.data, chd_p.data, "phase3 traces")
    print(f"phase3 traces, K3 vs plain: max_abs_err={a:.3e} rel={r:.3e}")
    assert r < TOL, r
    a, r = errs["das_k1"].add(b, ref, "phase3 image")
    print(f"phase3 image, K3 + K1 vs plain: max_abs_err={a:.3e} rel={r:.3e}")
    assert r < TOL, r
    _, t_sim = _sync_s(torch, lambda: us.greens(scat, device="cuda"))
    _, t_das = _sync_s(torch, lambda: us.DAS(chd))
    walls = [_sync_s(torch, lambda: us.DAS(us.greens(scat, device="cuda")))[1]
             for _ in range(3)]
    print(f"phase3 times (host clock, synchronised, warm): greens {t_sim:.4f} s vs "
          f"plain {t_sim_p:.4f} s; DAS {t_das:.4f} s vs plain {t_das_p:.4f} s; "
          f"sim->image wall, 3 runs: {', '.join(f'{w:.4f}' for w in walls)} s")

    rf = chd.replace(data=chd.data.real.contiguous())
    # what the kernel now carries (K1(b)) runs, against kernel='plain'
    runs = {"fmod (K1(b))": lambda **k: us.DAS(chd, fmod=us.xdc.fc, **k),
            "a frame dim (K1(b))": lambda **k: us.DAS(rf.replace(data=rf.data[..., None]), **k),
            "cubic2x (K1 linear, 2x traces)": lambda **k: us.DAS(chd, method="cubic2x", **k)}
    for what, fn in runs.items():
        before = das_cuda.LAUNCHES
        got = fn()
        torch.cuda.synchronize()
        assert das_cuda.LAUNCHES == before + 1, what
        a, r = errs["das_k1b" if "b)" in what else "das_k1"].add(
            got, fn(kernel="plain"), f"phase3 {what}")
        print(f"phase3 {what} runs on K1: {tuple(got.shape)} {got.dtype}; vs plain: "
              f"max_abs_err={a:.3e} rel={r:.3e}")
        assert r < TOL, (what, r)
    launches.update(_phase3_keep(torch, qt, das_cuda, us, targets, chd, b, errs))
    launches.update(_phase3_precision(torch, das_cuda, us, targets, chd, b, errs))
    # complex128 traces are cast to complex64 before K1: the same image
    before = das_cuda.LAUNCHES
    wide = us.DAS(chd.replace(data=chd.data.to(torch.complex128)))
    torch.cuda.synchronize()
    assert das_cuda.LAUNCHES == before + 1 and torch.equal(wide, b)
    print("phase3 complex128 traces run on K1 after the cast: the complex64 image, bit for bit")
    return launches


def _k1_plain(das_cuda, us, chd, precision, **kw):
    """The plain version of K1 at ``precision`` on ``us``'s geometry, shaped
    as ``us.DAS`` returns it (cubic)."""
    pv, nv, model = us._tx_geometry()
    img = das_cuda.das_sum_plain(chd.data, us._pixels(), us.rx.positions().T, pv, nv, chd.t0,
                                 np.reciprocal(np.float32(us.seq.c0)), fs=float(chd.fs),
                                 tx_model=model, method="cubic", precision=precision, **kw)
    return img.reshape(tuple(us.scan.shape) + tuple(img.shape[1:]))


def _cohfac_image(img, nd):
    """coherence_image's cohfac reduction of a keep_rx image (*scan, N, 1)."""
    from qups_tpu_torch.ops.coherence import cohfac

    return cohfac(img.select(nd + 1, 0), axis=nd).abs()


def _precision_checks(torch, us, targets, b, runs, errs, phase):
    """Each of ``runs`` ({name: (call, plain at its precision, errs key or
    None for a coherence image)}), already run into ``imgs``: the PSF, the
    limit TOL against the plain version at the same precision, and BAND
    against kernel='plain' (float32: the plain path ignores precision)."""
    for name, (fn, plain, kern, got) in runs.items():
        assert got.is_cuda and bool(torch.isfinite(got).all()), name
        ref, t_plain = _sync_s(torch, plain)
        f32, _ = _sync_s(torch, lambda: fn(kernel="plain"))
        _, t_k = _sync_s(torch, fn)
        assert got.shape == ref.shape == f32.shape, (name, got.shape, ref.shape, f32.shape)
        if kern is None:
            _coherence_psf(us, got, b, targets, name, phase)
            a = float((got - ref).abs().max())
            r = a / float(ref.abs().max())
        else:
            _psf(us, got, targets, name, phase)
            a, r = errs[kern].add(got, ref, f"{phase} {name}")
        band = float((got - f32).abs().max()) / float(f32.abs().max())
        print(f"{phase} {name:44s} {tuple(got.shape)} vs plain at its precision: "
              f"max_abs_err={a:.3e} rel={r:.3e}; vs kernel='plain' (float32): rel {band:.3e}; "
              f"wall (host clock, synchronised, warm) {t_k * 1e3:.3f} ms vs plain "
              f"{t_plain * 1e3:.3f} ms")
        assert r < TOL and band < BAND, (name, r, band)


def _phase3_precision(torch, das_cuda, us, targets, chd, b, errs):
    """Phase 3's reduced precisions (K1(e)) on the FSA path, no device=:
    DAS in bf16pair and i8x4, coherence_image in bf16pair; PREC_LAUNCHES
    zeroed just before and read just after; each with the PSF check,
    against its plain version at the same precision and against
    kernel='plain' within the precision's band. Returns the launches."""
    nd = len(us.scan.shape)
    calls = {
        "DAS bf16pair (K1(e))": (
            lambda **k: us.DAS(chd, precision="bf16pair", **k),
            lambda: _k1_plain(das_cuda, us, chd, "bf16pair"), "das_k1e"),
        "DAS i8x4 (K1(e))": (
            lambda **k: us.DAS(chd, precision="i8x4", **k),
            lambda: _k1_plain(das_cuda, us, chd, "i8x4"), "das_k1e"),
        "coherence_image bf16pair (K1(e) keep_rx)": (
            lambda **k: us.coherence_image(chd, precision="bf16pair", **k),
            lambda: _cohfac_image(_k1_plain(das_cuda, us, chd, "bf16pair", keep_rx=True), nd),
            None),
    }
    das_cuda.PREC_LAUNCHES = 0
    t = time.perf_counter()
    imgs = {name: fn() for name, (fn, _, _) in calls.items()}
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t
    launches = {"das_k1e": das_cuda.PREC_LAUNCHES}
    print(f"phase3 reduced precisions (3 calls, no device=): {t_path:.3f} s (first calls); "
          f"launches {launches}")
    assert launches == {"das_k1e": 3}, launches
    _precision_checks(torch, us, targets, b, {n: c + (imgs[n],) for n, c in calls.items()},
                      errs, "phase3")
    return launches


def _coherence_psf(us, cf, b, targets, what, phase):
    """The PSF check of a coherence image: on the coherence-weighted image
    max(cf, 0) |b|, b the summed DAS image (a coherence factor alone is
    near 1 wherever one target dominates the aperture)."""
    _psf(us, cf.real.clamp(min=0) * b.abs().reshape(cf.shape), targets, what, phase)


def _phase3_keep(torch, qt, das_cuda, us, targets, chd, b, errs):
    """Phase 3's apodized and aperture-coherence imaging on the FSA system:
    DAS with fused aperture growth and acceptance angle and with the dense
    ap_aperture_growth (K1(d)), keep_rx and keep_tx (K1(c)), and
    coherence_image with cohfac and slsc (K1(c), then the reduction), with
    no device=; launch counts zeroed just before and read just after; each
    with the PSF check and against kernel='plain'. Returns the launches."""
    fused = (qt.Fused("aperture_growth", f=1.5), qt.Fused("acceptance_angle", theta=45.0))
    runs = {  # name: (call, kernel, (keep, apod) launches, image for the PSF)
        "DAS Fused aperture_growth + acceptance_angle (K1(d))": (
            lambda **k: us.DAS(chd, apod=fused, **k), "das_k1d", (0, 1), lambda v: v),
        "DAS dense ap_aperture_growth (K1(d))": (
            lambda **k: us.DAS(chd, apod=us.ap_aperture_growth(f=1.5), **k), "das_k1d", (0, 1),
            lambda v: v),
        "DAS keep_rx (K1(c))": (lambda **k: us.DAS(chd, keep_rx=True, **k), "das_k1c", (1, 0),
                                lambda v: v.sum(3)),
        "DAS keep_tx (K1(c))": (lambda **k: us.DAS(chd, keep_tx=True, **k), "das_k1c", (1, 0),
                                lambda v: v.sum(4)),
        "coherence_image cohfac (K1(c))": (lambda **k: us.coherence_image(chd, **k), None,
                                           (1, 0), None),
        "coherence_image slsc (K1(c))": (lambda **k: us.coherence_image(chd, post="slsc", **k),
                                         None, (1, 0), None),
    }
    das_cuda.KEEP_LAUNCHES = das_cuda.APOD_LAUNCHES = das_cuda.LUT_KEEP_LAUNCHES = 0
    t = time.perf_counter()
    imgs = {}
    for name, (fn, _, (nk, na), _) in runs.items():
        before = das_cuda.KEEP_LAUNCHES, das_cuda.APOD_LAUNCHES
        imgs[name] = fn()
        assert (das_cuda.KEEP_LAUNCHES - before[0], das_cuda.APOD_LAUNCHES - before[1]) \
            == (nk, na), name
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t
    launches = {"das_k1c": das_cuda.KEEP_LAUNCHES, "das_k1d": das_cuda.APOD_LAUNCHES}
    print(f"phase3 apodized and coherence imaging (6 calls, no device=): {t_path:.3f} s "
          f"(first calls); launches {launches}")
    assert launches == {"das_k1c": 4, "das_k1d": 2} and das_cuda.LUT_KEEP_LAUNCHES == 0
    for name, (fn, kern, _, view) in runs.items():
        got = imgs[name]
        assert got.is_cuda and bool(torch.isfinite(got).all()), name
        ref, t_plain = _sync_s(torch, lambda: fn(kernel="plain"))
        _, t_k = _sync_s(torch, lambda: fn())
        if kern is not None:
            _psf(us, view(got), targets, name, "phase3")
            a, r = errs[kern].add(got, ref, f"phase3 {name}")
            tol = TOL
        else:
            assert got.shape == tuple(us.scan.shape), (name, got.shape)
            _coherence_psf(us, got, b, targets, name, "phase3")
            if "cohfac" in name:
                assert float(got.max()) <= 1 + 1e-6, float(got.max())
            # slsc scales each receiver's sample to unit magnitude, so a
            # sample at the rounding floor carries the rounding's phase
            tol = TOL if "cohfac" in name else 1e-3
            a = float((got - ref).abs().max())
            r = a / float(ref.abs().max())
        print(f"phase3 {name:52s} {tuple(got.shape)} vs plain: max_abs_err={a:.3e} "
              f"rel={r:.3e}; wall (host clock, synchronised, warm) {t_k * 1e3:.3f} ms vs "
              f"plain {t_plain * 1e3:.3f} ms")
        assert r < tol, (name, r)
    return launches


METHODS = ("nearest", "linear", "cubic", "lanczos3")


def _reps(method):
    return 1 if method == "lanczos3" else 3


def phase4(torch, das_cuda, errs):
    """The headline size: 1024^2 pixels x 256 tx x 256 rx, T = 4096, every
    sampler."""
    from qups_tpu_torch import bench  # das_problem and the baseline

    n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
    x, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
    xg = torch.as_tensor(x).cuda()
    sums = n * n * N * M
    cinv = np.float32(1 / 1540.0)
    sub = pi.reshape(n, n, 3)[::16].reshape(-1, 3)  # 64 pixel rows
    out = {}
    for method in METHODS:
        kw = dict(fs=fs, tx_model="plane", method=method)
        got = das_cuda.das_sum(xg, sub, pr, pv, nv, t0, cinv, **kw)
        ref = das_cuda.das_sum_plain(xg, sub, pr, pv, nv, t0, cinv, **kw)
        a, r = errs.add(got, ref, f"phase4 {method} 64-row subset")
        assert r < TOL, (method, r)
        ms = _ms(lambda: das_cuda.das_sum(xg, pi, pr, pv, nv, t0, cinv, **kw), _reps(method))
        rate = sums / (ms / 1e3)
        out[method] = ms
        print(f"phase4 {method:8s} 1024^2 x 256 x 256 T=4096: K1 {ms:.3f} ms (layout kernel "
              f"included), {rate:.4e} sums/s, {rate / bench.BASELINE_SUMS_PER_S:.3f}x the "
              f"RTX-3070 figure ({bench.BASELINE_SUMS_PER_S:.4e} sums/s); "
              f"64-row subset vs plain: max_abs_err={a:.3e} rel={r:.3e}")
    lay = {}
    for method in METHODS:  # the layout kernel alone, beside its plain version
        ms = _ms(lambda: das_cuda.trace_layout(xg, method))
        p_ms = _ms(lambda: das_cuda.trace_layout_plain(xg, method), 1)
        floats = {"nearest": T, "linear": 2 * T}.get(method, 4 * T)
        b = bound(0.0, F32_FLOPS, 4.0 * T * N * M + 4.0 * floats * N * M)
        lay[method] = (ms, p_ms, b)
        print(f"phase4 layout kernel alone, {method}: {ms:.3f} ms, plain {p_ms:.3f} ms")
        _share(f"phase4 layout kernel, {method}", ms, b)
    kw = dict(fs=fs, tx_model="plane", method="cubic")
    full = das_cuda.das_sum(xg, pi, pr, pv, nv, t0, cinv, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = das_cuda.das_sum_plain(xg, pi, pr, pv, nv, t0, cinv, **kw)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    a, r = errs.add(full, ref, "phase4 cubic full image")
    assert r < TOL, r
    check = float(torch.sum(torch.abs(full)))
    print(f"phase4 plain cubic, full size, one run: {plain_ms:.3f} ms; "
          f"K1 vs plain full image: max_abs_err={a:.3e} rel={r:.3e}; sum|img| {check!r}")
    return out, plain_ms, lay["cubic"], check


def phase5(torch, das_cuda, errs, lerrs):
    """K2 vs plain for 4 samplers x real / complex on perturbed tables; the
    layout kernel vs its plain version."""
    T, N, M, n = 2048, 128, 32, 256
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    xc = (x + 1j * rng.standard_normal((T, N, M))).astype(np.complex64)
    traces = {"real": torch.as_tensor(x).cuda(), "complex": torch.as_tensor(xc).cuda()}
    tau_rx, tau_tx, t0, fs, (below, above) = _lut_problem(torch, T, N, M, n, 5)
    for kind, xg in traces.items():
        for method in ("nearest", "linear", "cubic", "lanczos3"):
            kw = dict(fs=fs, method=method)
            got = das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kw)
            torch.cuda.synchronize()
            ref = das_cuda.das_lut_sum_plain(xg, tau_rx, tau_tx, t0, **kw)
            a, r = errs.add(got, ref, f"phase5 {method} {kind}")
            _layout_parity(torch, das_cuda, lerrs, method, xg, f"phase5 layout {method} {kind}")
            k_ms = _ms(lambda: das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kw))
            p_ms = _ms(lambda: das_cuda.das_lut_sum_plain(xg, tau_rx, tau_tx, t0, **kw))
            print(f"phase5 {method:8s} {kind:7s} max_abs_err={a:.3e} rel={r:.3e} "
                  f"ti<0: {below:.3f} ti>T-1: {above:.3f} K2 {k_ms:.3f} ms plain "
                  f"{p_ms:.3f} ms  (T,N,M,I)={(T, N, M, n * n)}")
            assert r < TOL, (method, kind, r)


def _band_traces(torch, T, N, V, fs, fc, seed):
    """Random traces (T, N, V) on the card, band-limited to a Gaussian band
    of 1.2 MHz sigma around fc."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, N, V), generator=g, device="cuda")
    f = torch.fft.rfftfreq(T, device="cuda") * fs
    H = torch.exp(-0.5 * ((f - fc) / 1.2e6) ** 2)[:, None, None]
    return torch.fft.irfft(torch.fft.rfft(x, dim=0) * H, n=T, dim=0).contiguous()


def phase6(torch, qt, fdbf_cuda, errs):
    """K4 vs plain: keep '', 'rx', 'tx' x f32 / bf16 x (5 plane waves,
    128 FSA transmits), 256^2 pixels, N = M = 128, the bins of a -40 dB
    band."""
    import ctypes

    from qups_tpu_torch.ops.fdbf import bf_adjoint, geom_delays, select_fbins

    xdc = qt.TransducerArray.L11_5v()
    c0, T, fs = 1540.0, 1024, 4 * xdc.fc
    pi = _line_geometry(256, 4, 4, "plane")[0]
    pe = xdc.positions().T
    tau_rx = geom_delays(pi, pe, np.float32(1 / c0), "cuda")
    tau_tx = tau_rx

    # K4's phasors come from the special function unit: its sin and cos of
    # 2 pi frac(f tau) against the accurate routine's, on the f tau of this
    # phase's tables at 64 bins across the band
    fk = torch.arange(230, 294, device="cuda", dtype=torch.float32) * np.float32(fs / T)
    u = (fk[:, None] * tau_rx.reshape(-1)[None, ::16]).reshape(-1).contiguous()
    sc = torch.empty((u.numel(), 4), device="cuda")
    probe = fdbf_cuda._nvcc.load("fdbf")[0].turns_sincos_probe
    probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]
    assert probe(u.data_ptr(), sc.data_ptr(), u.numel(),
                 *fdbf_cuda._nvcc.stream_args(u.device)) == 0
    torch.cuda.synchronize()
    d = (sc[:, 2:] - sc[:, :2]).abs().max()
    dphi = torch.remainder(torch.atan2(sc[:, 2], sc[:, 3]) - torch.atan2(sc[:, 0], sc[:, 1])
                           + np.pi, 2 * np.pi) - np.pi
    print(f"phase6 K4 phasors, SFU __sincosf against the accurate sincosf on "
          f"{u.numel()} angles: max |sin, cos error| {float(d):.3e}, max phase error "
          f"{float(dphi.abs().max()):.3e} rad")
    assert float(d) < 1e-5
    for seqname, seq in (("PW 5", qt.SequenceRadial(type="PW", angles=np.arange(-10, 11, 5),
                                                   c0=c0)),
                         ("FSA 128", qt.Sequence(type="FSA", numpulse=128, c0=c0))):
        V = seq.num_pulse
        t0_off = np.broadcast_to(seq.t0_offset(), (V,))
        del_tx = seq.delays(xdc) + t0_off[None, :]
        apod = seq.apodization(xdc)
        x = _band_traces(torch, T, 128, V, fs, xdc.fc, V)
        sel = select_fbins(x, fs, -40.0)
        args = (x, tau_rx, tau_tx, del_tx, apod, 2e-6, t0_off, sel)
        for keep in ("", "rx", "tx"):
            for precision, tol in (("f32", TOL), ("bf16", TOL_BF16)):
                kw = dict(fs=fs, keep_rx=keep == "rx", keep_tx=keep == "tx",
                          precision=precision)
                got = fdbf_cuda.bf_adjoint_cuda(*args, **kw)
                torch.cuda.synchronize()
                ref = bf_adjoint(*args, **kw)
                a, r = errs.add(got, ref, f"phase6 {seqname} keep={keep!r} {precision}")
                k_ms = _ms(lambda: fdbf_cuda.bf_adjoint_cuda(*args, **kw), reps=2)
                p_ms = _ms(lambda: bf_adjoint(*args, **kw), reps=2)
                print(f"phase6 {seqname:7s} keep={keep!r:4s} {precision:4s} bins {sel.size} "
                      f"max_abs_err={a:.3e} rel={r:.3e} K4 {k_ms:.3f} ms plain "
                      f"{p_ms:.3f} ms  (T,N,M,V,I)={(T, 128, 128, V, pi.shape[0])}")
                assert r < tol, (seqname, keep, precision, r)


def _demo_system(qt):
    """examples/demo_imaging.py's system and phantom: L11-5v, plane waves
    at -10:5:10 degrees, 256 x 256 pixels over x +-12 mm, z 15-35 mm,
    fs = 4 fc, a 4 x 5 grid of point targets."""
    xdc = qt.TransducerArray.L11_5v()
    seq = qt.SequenceRadial(type="PW", angles=np.arange(-10, 11, 5), c0=1540.0)
    scan = qt.ScanCartesian(x=np.linspace(-12e-3, 12e-3, 256),
                            z=np.linspace(15e-3, 35e-3, 256))
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=4 * xdc.fc)
    Zs, Xs = np.meshgrid(np.linspace(18e-3, 32e-3, 4), np.linspace(-8e-3, 8e-3, 5),
                         indexing="ij")
    pos = np.stack([Xs.ravel(), np.zeros(Xs.size), Zs.ravel()])
    return us, pos, qt.Scatterers(pos=pos, amp=np.ones(pos.shape[1]), c0=1540.0)


def phase7(torch, qt, ops, errs):
    """The plane-wave demo path unmodified on the card. Returns the launches
    of each kernel in that run."""
    das_cuda, gfc, fdbf_cuda = ops.das_cuda, ops.greens_freq_cuda, ops.fdbf_cuda
    us, pos, scat = _demo_system(qt)
    cmap = np.full(us.scan.shape, 1540.0)
    calls = {
        "DAS (K1)": (lambda chd, **k: us.DAS(chd, **k), "das_k1", TOL),
        "bfDAS (K2)": (lambda chd, **k: us.bfDAS(chd, **k), "das_lut_k2", TOL),
        "DAS c0 map (K2)": (lambda chd, **k: us.DAS(chd, c0=cmap, **k), "das_lut_k2", TOL),
        "bfAdjoint bf16 (K4)": (lambda chd, **k: us.bfAdjoint(chd, **k),
                                "fdbf_adjoint_k4", TOL_BF16),
        "bfAdjoint f32 (K4)": (lambda chd, **k: us.bfAdjoint(chd, precision="f32", **k),
                               "fdbf_adjoint_k4", TOL),
    }

    das_cuda.LAUNCHES = das_cuda.LUT_LAUNCHES = das_cuda.LAYOUT_LAUNCHES = 0
    das_cuda.KEEP_LAUNCHES = das_cuda.APOD_LAUNCHES = das_cuda.LUT_KEEP_LAUNCHES = 0
    gfc.LAUNCHES = fdbf_cuda.LAUNCHES = 0
    t = time.perf_counter()
    chd = us.greens(scat, device="cuda")
    imgs = {name: fn(chd) for name, (fn, _, _) in calls.items()}
    coh = us.coherence_image(chd)  # the demo's fourth image, as it calls it
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t
    launches = {"das_k1": das_cuda.LAUNCHES, "das_lut_k2": das_cuda.LUT_LAUNCHES,
                "das_layout": das_cuda.LAYOUT_LAUNCHES, "greens_freq_k3": gfc.LAUNCHES,
                "fdbf_adjoint_k4": fdbf_cuda.LAUNCHES, "das_k1c": das_cuda.KEEP_LAUNCHES}
    print(f"phase7 demo path (greens -> DAS, bfDAS, DAS c0 map, bfAdjoint x2, "
          f"coherence_image): {t_path:.3f} s (first call) -> traces {tuple(chd.data.shape)} "
          f"{chd.data.dtype}; launches {launches}")
    assert launches == {"das_k1": 1, "das_lut_k2": 2, "das_layout": 4, "greens_freq_k3": 1,
                        "fdbf_adjoint_k4": 2, "das_k1c": 1}, launches
    assert chd.data.is_cuda and chd.M == 5

    P = us.scan.positions().reshape(3, -1)
    chd_p = us.greens(scat, device="cuda", kernel="plain")
    a, r = errs["greens_freq_k3"].add(chd.data, chd_p.data, "phase7 traces")
    assert r < TOL, r
    for name, (fn, kern, tol) in calls.items():
        b = imgs[name]
        assert b.is_cuda and b.shape == tuple(us.scan.shape) + (1, 1)
        assert bool(torch.isfinite(b).all()), name
        k = int(b.abs().reshape(-1).argmax())
        d = float(np.linalg.norm(pos - P[:, k:k + 1], axis=0).min())
        ref, t_plain = _sync_s(torch, lambda: fn(chd, kernel="plain"))
        a, r = errs[kern].add(b, ref, f"phase7 {name}")
        _, t_k = _sync_s(torch, lambda: fn(chd))
        print(f"phase7 {name:20s} peak {d * 1e3:.3f} mm from a target; vs plain: "
              f"max_abs_err={a:.3e} rel={r:.3e}; wall (host clock, synchronised, "
              f"warm) {t_k * 1e3:.3f} ms vs plain {t_plain * 1e3:.3f} ms")
        assert d < 1.1e-3, (name, d)
        assert r < tol, (name, r)
    # the coherence image: finite, a coherence factor <= 1, its PSF, and
    # against kernel='plain'
    assert coh.is_cuda and coh.shape == tuple(us.scan.shape) and bool(torch.isfinite(coh).all())
    assert float(coh.max()) <= 1 + 1e-6
    _coherence_psf(us, coh, imgs["DAS (K1)"], pos, "coherence_image (K1(c))", "phase7")
    ref, t_plain = _sync_s(torch, lambda: us.coherence_image(chd, kernel="plain"))
    _, t_k = _sync_s(torch, lambda: us.coherence_image(chd))
    a = float((coh - ref).abs().max())
    r = a / float(ref.abs().max())
    print(f"phase7 coherence_image (K1(c) keep_rx, cohfac) vs plain: max_abs_err={a:.3e} "
          f"rel={r:.3e}; wall (host clock, synchronised, warm) {t_k * 1e3:.3f} ms vs plain "
          f"{t_plain * 1e3:.3f} ms")
    assert r < TOL, r
    walls = [_sync_s(torch, lambda: us.greens(scat, device="cuda"))[1] for _ in range(3)]
    print(f"phase7 greens + focusTx wall, 3 warm runs: "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms")

    rf = chd.replace(data=chd.data.real.contiguous())
    # what the kernel now carries (K2(b)) runs, against kernel='plain'
    runs = {"bfDAS fmod (K2(b))": lambda **k: us.bfDAS(chd, fmod=us.xdc.fc, **k),
            "bfDAS a frame dim (K2(b))": lambda **k: us.bfDAS(
                rf.replace(data=rf.data[..., None]), **k)}
    for what, fn in runs.items():
        before = das_cuda.LUT_LAUNCHES
        got = fn()
        torch.cuda.synchronize()
        assert das_cuda.LUT_LAUNCHES == before + 1, what
        a, r = errs["das_lut_k2b"].add(got, fn(kernel="plain"), f"phase7 {what}")
        print(f"phase7 {what} runs on K2: {tuple(got.shape)} {got.dtype}; vs plain: "
              f"max_abs_err={a:.3e} rel={r:.3e}")
        assert r < TOL, (what, r)
    # K2(c): bfDAS keep_rx and the c0-map DAS with a dense weight, counted
    dense = us.ap_aperture_growth(f=1.5)
    k2c = {"bfDAS keep_rx (K2(c))": (lambda **k: us.bfDAS(chd, keep_rx=True, **k),
                                     lambda v: v.sum(3)),
           "DAS c0 map, dense ap_aperture_growth (K2(c))": (
               lambda **k: us.DAS(chd, c0=cmap, apod=dense, **k), lambda v: v)}
    das_cuda.LUT_KEEP_LAUNCHES = 0
    got = {what: fn() for what, (fn, _) in k2c.items()}
    torch.cuda.synchronize()
    launches["das_lut_k2c"] = das_cuda.LUT_KEEP_LAUNCHES
    assert launches["das_lut_k2c"] == 2, launches
    for what, (fn, view) in k2c.items():
        _psf(us, view(got[what]), pos, what, "phase7")
        a, r = errs["das_lut_k2c"].add(got[what], fn(kernel="plain"), f"phase7 {what}")
        print(f"phase7 {what} runs on K2: {tuple(got[what].shape)} {got[what].dtype}; vs "
              f"plain: max_abs_err={a:.3e} rel={r:.3e}")
        assert r < TOL, (what, r)
    # K2(e) and K1(e) on the demo: bfDAS in i8x4 (one scale per call) and
    # the demo's coherence image in bf16pair, counted; complex128 traces
    tables = us.das_delay_tables(device="cuda")
    nd = len(us.scan.shape)

    def k2_plain(precision):
        img = das_cuda.das_lut_sum_plain(chd.data, *tables, chd.t0, fs=float(chd.fs),
                                         method="cubic", precision=precision)
        return img.reshape(tuple(us.scan.shape) + tuple(img.shape[1:]))

    e_calls = {
        "bfDAS i8x4 (K2(e))": (lambda **k: us.bfDAS(chd, precision="i8x4", **k),
                               lambda: k2_plain("i8x4"), "das_lut_k2e"),
        "coherence_image bf16pair (K1(e) keep_rx)": (
            lambda **k: us.coherence_image(chd, precision="bf16pair", **k),
            lambda: _cohfac_image(_k1_plain(das_cuda, us, chd, "bf16pair", keep_rx=True), nd),
            None),
    }
    das_cuda.PREC_LAUNCHES = das_cuda.LUT_PREC_LAUNCHES = 0
    e_imgs = {name: fn() for name, (fn, _, _) in e_calls.items()}
    torch.cuda.synchronize()
    launches["das_lut_k2e"] = das_cuda.LUT_PREC_LAUNCHES
    assert (das_cuda.LUT_PREC_LAUNCHES, das_cuda.PREC_LAUNCHES) == (1, 1), launches
    _precision_checks(torch, us, pos, imgs["DAS (K1)"],
                      {n: c + (e_imgs[n],) for n, c in e_calls.items()}, errs, "phase7")
    before = das_cuda.LUT_LAUNCHES
    wide = us.bfDAS(chd.replace(data=chd.data.to(torch.complex128)))
    torch.cuda.synchronize()
    assert das_cuda.LUT_LAUNCHES == before + 1 and torch.equal(wide, imgs["bfDAS (K2)"])
    print("phase7 complex128 traces run on K2 after the cast: the complex64 image, bit for bit")
    return launches


def phase8(torch, ops, k1_ms, errs):
    """K2 and K4 at the headline size, 1024^2 pixels x 256 x 256."""
    from qups_tpu_torch import bench
    from qups_tpu_torch.ops.das import delay_tables
    from qups_tpu_torch.ops.fdbf import bf_adjoint, geom_delays

    das_cuda, fdbf_cuda = ops.das_cuda, ops.fdbf_cuda
    n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
    x, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
    xg = torch.as_tensor(x).cuda()
    del x
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    sums = n * n * N * M
    k2 = {}
    for method in METHODS:
        kw = dict(fs=fs, method=method)
        ms = _ms(lambda: das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kw), _reps(method))
        got = das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kw)
        if method in ("linear", "cubic"):  # the plain version on the full image
            ref, t_plain = _sync_s(torch, lambda: das_cuda.das_lut_sum_plain(
                xg, tau_rx, tau_tx, t0, **kw))
            what = "full image"
        else:  # ... and on 64 pixel rows
            rows = torch.arange(n * n, device="cuda").reshape(n, n)[::16].reshape(-1)
            ref, t_plain = _sync_s(torch, lambda: das_cuda.das_lut_sum_plain(
                xg, tau_rx[rows], tau_tx[rows], t0, **kw))
            got, what = got[rows], "64-row subset"
        a, r = errs["das_lut_k2"].add(got, ref, f"phase8 {method} {what}")
        print(f"phase8 K2 {method:8s} 1024^2 x 256 x 256 T=4096 (plane-wave "
              f"geometric tables): {ms:.3f} ms (layout kernel included), "
              f"{sums / (ms / 1e3):.4e} sums/s; K1 on the same problem (phase 4): "
              f"{k1_ms[method]:.3f} ms; plain, one run ({what}): {t_plain * 1e3:.3f} ms; "
              f"K2 vs plain ({what}): max_abs_err={a:.3e} rel={r:.3e}")
        assert r < TOL, (method, r)
        k2[method] = (ms, t_plain * 1e3)
    del xg, got, ref, tau_rx, tau_tx
    k2_all, k2 = {m: v[0] for m, v in k2.items()}, k2["cubic"]

    # K4: 256 receivers, 256 elements firing 256 plane waves (+-20 deg),
    # 64 bins around the 7.8 MHz of a 4096-sample trace at 31.25 MHz
    V = 256
    th = np.radians(np.linspace(-20, 20, V))
    del_tx = -(pr[:, 0:1] * np.sin(th)[None, :]) / 1540.0
    apod = np.ones((M, V))
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((T, N, V), generator=g, device="cuda")
    taur = geom_delays(pi, pr, np.float32(1 / 1540.0), "cuda")
    sel = np.arange(1024 - 32, 1024 + 32)
    args = (x, taur, taur, del_tx, apod, t0[0], np.zeros(V), sel)
    k4 = {}
    # the bound: K I (M + N) V complex multiply-adds (8 flops each) on the
    # tensor cores (bf16) or the CUDA cores (f32); the bytes of the traces,
    # the two delay tables and the image
    K = sel.size
    cmacs = float(K) * n * n * (N + M) * V
    nbytes = 4.0 * T * N * V + 4.0 * n * n * (N + M) + 8.0 * n * n
    lib = _k4_library(torch, x, taur, del_tx, apod, t0[0], V, sel, fs)
    for precision, tol in (("bf16", TOL_BF16), ("f32", TOL)):
        kw = dict(fs=fs, precision=precision)
        got = fdbf_cuda.bf_adjoint_cuda(*args, **kw)
        k_ms = _ms(lambda: fdbf_cuda.bf_adjoint_cuda(*args, **kw), reps=1)
        ref, t_plain = _sync_s(torch, lambda: bf_adjoint(*args, **kw))
        a, r = errs["fdbf_adjoint_k4"].add(got, ref, f"phase8 {precision} full image")
        flops = 8.0 * 64 * n * n * (N + M) * V  # 4 FMAs of 2 flops per complex MAC
        b = bound(8.0 * cmacs, BF16_FLOPS if precision == "bf16" else F32_FLOPS, nbytes)
        print(f"phase8 K4 {precision:4s} 1024^2 x 256 x 256 x 64 bins: {k_ms:.3f} ms "
              f"({flops / (k_ms / 1e3) / 1e12:.2f} TFLOP/s of complex MACs); plain, one "
              f"run: {t_plain * 1e3:.3f} ms; max_abs_err={a:.3e} rel={r:.3e}; library "
              f"yardstick {lib[precision]:.3f} ms")
        _share(f"phase8 K4 {precision}", k_ms, b)
        assert r < tol, (precision, r)
        k4[precision] = (k_ms, t_plain * 1e3, b, lib[precision])
        del got, ref
    return k2, k4, k2_all


def _k4_library(torch, x, taur, del_tx, apod, t0, V, sel, fs, nb=4, taut=None):
    """The yardstick of K4: the per-bin products of the tx and rx phasors
    (of ``taut``, default ``taur``, and ``taur``) with S_k and X_k as one
    batched PyTorch GEMM per bin, bf16 torch.bmm on the materialized
    real-block operands and complex64 torch.bmm (cmatmul's product in one
    call), on ``nb`` bins with the operands built outside the timing, scaled
    to all the bins. Only the products: the norm and the sum over v are left
    out. Returns {precision: ms}."""
    from qups_tpu_torch.ops import fdbf_cuda
    from qups_tpu_torch.ops.fdbf import adjoint_spectra, phasor

    _, fk, Xk, Sk = adjoint_spectra(x, del_tx, apod, t0, np.zeros(V), sel, fs=fs)
    out = {"bf16": 0.0, "f32": 0.0}
    I, M = taur.shape
    for k in np.linspace(0, fk.shape[0] - 1, nb).astype(int):
        W = torch.stack((phasor(fk[k], taur if taut is None else taut, -1.0),
                         phasor(fk[k], taur, 1.0)))
        Q = torch.stack((Sk[k], Xk[k]))  # (2, M, V): tables and arrays as phase 8's
        out["f32"] += _ms(lambda: torch.bmm(W, Q), reps=2)
        Wb = torch.view_as_real(W).reshape(2, I, 2 * M).to(torch.bfloat16)
        Qb = fdbf_cuda.block_operand(Q, M, V)
        del W
        out["bf16"] += _ms(lambda: torch.bmm(Wb, Qb), reps=2)
        del Wb
    return {p: v * fk.shape[0] / nb for p, v in out.items()}


def _speckle(qt, S, seed):
    """S scatterers with standard-normal amplitudes, uniform over the main
    system's scan (x +-15 mm, z 5-45 mm), from a seed."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-15e-3, 15e-3, S), np.zeros(S), rng.uniform(5e-3, 45e-3, S)])
    return qt.Scatterers(pos=pos, amp=rng.standard_normal(S), c0=1540.0)


def _simus_band(us, T):
    """(k0, F): the hull of the bins that ``us.simus`` selects at its
    default -60 dB for a trace length T."""
    fs = float(us.fs)
    wv = us.rx.impulse.conv(us.tx.impulse.conv(us.seq.pulse, fs), fs)
    lev = 20 * np.log10(np.abs(np.fft.rfft(np.real(np.asarray(wv.samples)), n=T)) + 1e-30)
    sel = np.where(lev >= lev.max() - 60.0)[0]
    sel = sel[sel > 0]
    return int(sel.min()), int(sel.max() - sel.min() + 1)


def _control(k3a, ref_b, where):
    """The control reading for TOL_K3B: K3(a)'s result (float32 operands)
    against the bf16 plain version on the same inputs; it must fail the
    limit. Returns the relative error."""
    r = float((k3a - ref_b).abs().max()) / float(ref_b.abs().max())
    print(f"{where}: control K3(a) (float32 operands) vs the bf16 plain version "
          f"rel={r:.3e}, must exceed TOL_K3B={TOL_K3B:.0e}")
    assert r > TOL_K3B, (where, r)
    return r


def _numpy_plan_traces(torch, gc, npl, T):
    """Traces through splat_plain and finish_plain on the card from the
    numpy plan (the JAX package's plan), uploaded: a path that shares
    nothing with the device plan. splat_plain takes no windows; it gets
    empty ones of K5's shape."""
    up = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    st = {k: v for k, v in npl["st"].items() if k != "CS"}
    M, Npad = npl["pv"].shape[2], npl["pn"].shape[2]
    win = torch.zeros((M, -(-st["Gtime"] // gc.BAND), Npad // gc.GROUP), dtype=torch.int32,
                      device="cuda")
    grid = sum(gc.splat_plain(win, win, up(npl["scat"]), up(pnk), up(npl["ofs_pad"]), up(pvk),
                              **st) for pnk in npl["pn"] for pvk in npl["pv"])
    return gc.finish_plain(grid, up(npl["kern"]), T=T, P0=npl["P0"], ofs=npl["ofs"])


def _plan_vs_numpy(plan, npl):
    """The device plan against the numpy plan on the same problem: P0 and
    Gtime equal, the row offsets within 1 (the card's float32 rows may round
    a median at a half-integer the other way), the same scatterers (as a
    multiset: a changed offset may reorder ties). Returns (offsets that
    differ, share of sorted rows in the numpy plan's order)."""
    assert (plan["P0"], plan["st"]["Gtime"]) == (npl["P0"], npl["st"]["Gtime"]), \
        (plan["P0"], plan["st"]["Gtime"], npl["P0"], npl["st"]["Gtime"])
    dofs = np.abs(plan["ofs"].cpu().numpy() - npl["ofs"])
    assert dofs.max() <= 1, dofs.max()
    got = plan["scat"].cpu().numpy()
    ref = npl["scat"][:got.shape[0]]
    assert not npl["scat"][got.shape[0]:, 3].any()  # the rest is zero-amplitude padding
    lex = lambda a: a[np.lexsort(a.T[::-1])]  # noqa: E731
    np.testing.assert_array_equal(lex(got), lex(ref))
    return int((dofs > 0).sum()), float((got == ref).all(1).mean())


def phase9(torch, qt, gc, errs, ferrs):
    """K5 vs plain at the main path's shapes on the device plan: deposit grid
    (a second launch bit for bit) and traces for linear / cubic x the
    complex kernel / its real part, and sub-elements; the finish kernel vs
    its plain version on each grid; the device plan vs the numpy plan, and
    the traces vs the plain versions on the numpy plan. Returns the main
    grid's (cubic, complex kernel, 10^4 scatterers) numbers for the kernels'
    JSON rows."""
    us, _, _ = _main_system(qt)
    speck = _speckle(qt, 10_000, 10)
    cases = [(m, c, (1, 1), speck) for m in ("linear", "cubic") for c in ("complex", "real")]
    cases.append(("cubic", "complex", (2, 1), _speckle(qt, 2_000, 9)))
    out = None
    for method, kind, sub, sc in cases:
        ps, kern, pn, pv, kw = us._greens_problem(sc, sub)
        kern = kern if kind == "complex" else np.real(kern)
        kw = dict(kw, method=method)
        plan = gc.plan_tiled_device(kern, ps, sc.amp, pn, pv, device="cuda", **kw)
        args = (plan["lo"], plan["hi"], plan["scat"], plan["pn"][0], plan["ofs_pad"],
                plan["pv"][0])
        got = gc.splat(*args, **plan["st"])
        again = gc.splat(*args, **plan["st"])
        torch.cuda.synchronize()
        ref = gc.splat_plain(*args, **plan["st"])
        a, r = errs.add(got, ref, f"phase9 grid {method} {kind} sub={sub}")
        assert r < TOL, (method, kind, sub, r)
        assert torch.equal(got, again), (method, kind, sub)
        kt = torch.as_tensor(plan["kern"], device="cuda")
        fin = dict(T=kw["T"], P0=plan["P0"], ofs=plan["ofs"])
        fx = gc.finish(got, kt, **fin)
        torch.cuda.synchronize()
        fp = gc.finish_plain(got, kt, **fin)
        af, rf = ferrs.add(fx, fp, f"phase9 finish {method} {kind} sub={sub}")
        assert rf < TOL, (method, kind, sub, rf)
        x = gc.greens_tiled(kern, ps, sc.amp, pn, pv, device="cuda", **kw)
        xp = gc.greens_tiled(kern, ps, sc.amp, pn, pv, device="cuda", kernel="plain", **kw)
        at, rt = errs.add(x, xp, f"phase9 traces {method} {kind} sub={sub}")
        assert rt < TOL, (method, kind, sub, rt)
        npl = gc.plan_tiled(kern, ps, sc.amp, pn, pv, **kw)
        nofs, same = _plan_vs_numpy(plan, npl)
        xn = _numpy_plan_traces(torch, gc, npl, kw["T"])
        an, rn = errs.add(x, xn, f"phase9 traces vs the numpy plan {method} {kind} sub={sub}")
        assert rn < TOL, (method, kind, sub, rn)
        print(f"phase9 device plan vs numpy plan {method} {kind} sub={sub}: P0 {plan['P0']}, "
              f"Gtime {plan['st']['Gtime']} equal; {nofs} of {plan['ofs'].numel()} row "
              f"offsets differ by 1; the same scatterers, {100 * same:.2f} % of them in the "
              f"same place; traces vs the plain versions on the numpy plan "
              f"max_abs_err={an:.3e} rel={rn:.3e}")
        k_ms = _ms(lambda: gc.splat(*args, **plan["st"]))
        p_ms = _ms(lambda: gc.splat_plain(*args, **plan["st"]), reps=1)
        f_ms = _ms(lambda: gc.finish(got, kt, **fin))
        fp_ms = _ms(lambda: gc.finish_plain(got, kt, **fin), reps=1)
        plan_s = min(_sync_s(torch, lambda: gc.plan_tiled_device(
            kern, ps, sc.amp, pn, pv, device="cuda", **kw))[1] for _ in range(3))
        vis = gc.visits(plan)
        lo = plan["lo"]
        print(f"phase9 K5 {method:6s} {kind:7s} sub={sub} S={sc.pos.shape[1]}: grid "
              f"{tuple(got.shape)}, windows (m, band, group) {tuple(lo.shape)} of "
              f"{float((plan['hi'] - lo).float().mean()):.1f} scatterers on average, "
              f"{vis:.4e} visits; grid max_abs_err={a:.3e} rel={r:.3e}, repeat bit-equal; "
              f"traces {tuple(x.shape)} {x.dtype} max_abs_err={at:.3e} rel={rt:.3e}; "
              f"K5 {k_ms:.3f} ms, plain {p_ms:.3f} ms; finish kernel {f_ms:.3f} ms vs plain "
              f"{fp_ms:.3f} ms, max_abs_err={af:.3e} rel={rf:.3e} "
              f"(bit-equal: {bool(torch.equal(fx, fp))}); device plan {plan_s * 1e3:.3f} ms "
              "(host clock, synchronised, best of 3)")
        if (method, kind, sub) == ("cubic", "complex", (1, 1)):
            # the visits of the tile windows (per 8-row tile, over all
            # receivers) that the numpy plan, the JAX package's, gives
            old = int(npl["nc"].astype(np.int64).sum()) * npl["st"]["CS"] * npl["pn"].shape[2]
            print(f"phase9 K5 visits per main-path grid: {vis:.4e} (bands of "
                  f"{gc.BAND} rows, groups of {gc.GROUP} receivers) against "
                  f"{old:.4e} with the numpy plan's tile windows ({old / vis:.1f}x fewer); "
                  f"deposits S N M = {sc.pos.shape[1] * 128 * 128:.4e}")
            assert 10 * vis <= old, (vis, old)
            T, N, M = x.shape
            K = plan["kern"].shape[0]
            out = dict(k5=(k_ms, p_ms), finish=(f_ms, fp_ms), deposits=ps.shape[0] * N * M,
                       radii=ps.shape[0] * (N + M),
                       grid=got.numel(), fin_bytes=4.0 * M * got.shape[1] * N + 8.0 * T * N * M,
                       fin_flops=4.0 * K * T * N * M, plan_ms=plan_s * 1e3, visits=vis,
                       old_visits=old)
    return out


def _psf(us, b, targets, what, phase):
    """Each target's image peak (within 3 mm of it) lies within 1.1 mm."""
    img = b.abs().reshape(-1).cpu().numpy()
    P = us.scan.positions().reshape(3, -1)
    ds = []
    for k in range(targets.shape[1]):
        near = np.linalg.norm(P - targets[:, k:k + 1], axis=0) < 3e-3
        j = np.flatnonzero(near)[np.argmax(img[near])]
        ds.append(float(np.linalg.norm(P[:, j] - targets[:, k])))
    print(f"{phase} PSF {what}: peaks {', '.join(f'{d * 1e3:.3f}' for d in ds)} mm "
          "from the targets")
    assert max(ds) < 1.1e-3, (what, ds)


def phase10(torch, qt, ops, errs):
    """The simulator path unmodified at full width (L11-5v, 128 x 128
    elements, 10^4 speckle scatterers). Returns the launches of each kernel
    in that run, K3(c)'s and its plain version's ms at its shapes, and the
    K3(b) control reading on the traces."""
    gc, gfc = ops.greens_cuda, ops.greens_freq_cuda
    from qups_tpu_torch.ops.simus import simus_prologue

    us, targets, scat5 = _main_system(qt)
    speck = _speckle(qt, 10_000, 10)
    pw = us.replace(seq=qt.SequenceRadial(type="PW", angles=np.arange(-10, 11, 5), c0=1540.0))
    focus = np.array([[0.0], [0.0], [25e-3]])
    fc = us.replace(seq=qt.Sequence(type="FC", focus=focus, c0=1540.0))
    calls = {  # name: (call, kernel whose errors it adds to, tolerance)
        "greens pallas (K5)": (lambda sc, **k: us.greens(sc, impl="pallas", device="cuda", **k),
                               "greens_splat_k5", TOL),
        "greens bf16 (K3(b))": (lambda sc, **k: us.greens(sc, precision="bf16", device="cuda",
                                                          **k), "greens_freq_k3b", TOL_K3B),
        "simus soft (K3(c))": (lambda sc, **k: us.simus(sc, device="cuda", **k),
                               "greens_freq_k3c", TOL),
        "simus hard (K3(c))": (lambda sc, **k: us.simus(sc, baffle="hard", device="cuda", **k),
                               "greens_freq_k3c", TOL),
        "calc_scat_all (K3(a))": (lambda sc, **k: us.calc_scat_all(sc, device="cuda", **k),
                                  "greens_freq_k3", TOL),
        "calc_scat_multi PW (K5)": (lambda sc, **k: pw.calc_scat_multi(
            sc, impl="pallas", device="cuda", **k), "greens_splat_k5", TOL),
        "calc_scat_multi PW bsize=1 (K5)": (lambda sc, **k: pw.calc_scat_multi(
            sc, impl="pallas", bsize=1, device="cuda", **k), "greens_splat_k5", TOL),
    }

    gc.LAUNCHES = gc.FINISH_LAUNCHES = gfc.LAUNCHES = 0
    for v in gfc.VARIANT_LAUNCHES:
        gfc.VARIANT_LAUNCHES[v] = 0
    t = time.perf_counter()
    outs = {name: fn(speck) for name, (fn, _, _) in calls.items()}
    hp = fc.calc_hp(device="cuda")
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t
    launches = {"greens_splat_k5": gc.LAUNCHES, "greens_finish": gc.FINISH_LAUNCHES,
                "greens_freq_k3": gfc.VARIANT_LAUNCHES["a"],
                "greens_freq_k3b": gfc.VARIANT_LAUNCHES["b"],
                "greens_freq_k3c": gfc.VARIANT_LAUNCHES["c"]}
    print(f"phase10 simulator path ({', '.join(calls)}, calc_hp FC) on 10^4 scatterers: "
          f"{t_path:.3f} s (first call); launches {launches}")
    assert launches["greens_splat_k5"] == 3 and launches["greens_finish"] == 3 \
        and launches["greens_freq_k3b"] == 1 \
        and launches["greens_freq_k3c"] >= 2 and launches["greens_freq_k3"] >= 1, launches

    for name, (fn, kern, tol) in calls.items():
        chd = outs[name]
        assert chd.data.is_cuda and bool(torch.isfinite(chd.data).all()), name
        ref, t_plain = _sync_s(torch, lambda: fn(speck, kernel="plain"))
        if kern == "greens_freq_k3b":
            ref_b = ref.data
        a, r = errs[kern].add(chd.data, ref.data, f"phase10 {name}")
        _, t_k = _sync_s(torch, lambda: fn(speck))
        print(f"phase10 {name:32s} traces {tuple(chd.data.shape)} {chd.data.dtype}; vs "
              f"plain: max_abs_err={a:.3e} rel={r:.3e}; wall (host clock, synchronised, "
              f"warm) {t_k * 1e3:.3f} ms vs plain {t_plain * 1e3:.3f} ms")
        assert r < tol, (name, r)
    a, b = outs["calc_scat_multi PW (K5)"].data, outs["calc_scat_multi PW bsize=1 (K5)"].data
    rb = float((a - b).abs().max()) / float(a.abs().max())
    print(f"phase10 calc_scat_multi blocked (bsize=1) vs fused: rel={rb:.3e}")
    assert rb < TOL, rb
    ctl = _control(outs["calc_scat_all (K3(a))"].data, ref_b, "phase10 greens traces")

    # calc_hp: finite, its peak at the focus, and on the card what it is on
    # the CPU for a 64 x 64 subset of the scan
    assert hp.is_cuda and hp.shape == tuple(us.scan.shape) + (1,) and bool(torch.isfinite(hp).all())
    P = us.scan.positions().reshape(3, -1)
    d = float(np.linalg.norm(P[:, int(hp.reshape(-1).argmax())] - focus[:, 0]))
    sub = fc.replace(scan=qt.ScanCartesian(x=us.scan.x[::4], z=us.scan.z[::4]))
    h_card, h_cpu = sub.calc_hp(device="cuda"), sub.calc_hp(device="cpu")
    rh = float((h_card.cpu() - h_cpu).abs().max()) / float(h_cpu.abs().max())
    _, t_hp = _sync_s(torch, lambda: fc.calc_hp(device="cuda"))
    print(f"phase10 calc_hp FC (focus 25 mm) {tuple(hp.shape)}: peak {d * 1e3:.3f} mm from "
          f"the focus; 64^2-pixel subset, card vs CPU rel={rh:.3e}; wall {t_hp * 1e3:.3f} ms")
    assert d < 1.1e-3 and rh < TOL, (d, rh)

    # the PSF oracle on the 5-target phantom, through us.DAS (K1)
    for name in ("greens pallas (K5)", "greens bf16 (K3(b))", "simus soft (K3(c))",
                 "simus hard (K3(c))", "calc_scat_all (K3(a))", "calc_scat_multi PW (K5)"):
        sysm = pw if name.startswith("calc_scat_multi") else us
        _psf(sysm, sysm.DAS(calls[name][0](scat5)), targets, name, "phase10")

    # K3(c) alone at the simus call's shapes, against its plain version
    ps, kern, pn, pv, kw = us._greens_problem(speck)
    k0, F = _simus_band(us, kw["T"])
    sl = np.float32(kw["fs"] / (kw["T"] * 1540.0))
    q1, w1, s1, q2, w2, s2 = simus_prologue(
        ps, speck.amp, pn[:, 0], np.zeros(128), pv[:, 0], np.zeros(128),
        [us.tx.width, us.rx.width], sl, baffle="soft", device="cuda")
    g = dict(k0=k0, F=F, s1=s1, s2=s2)
    got = gfc.freq_gemm(q1, w1, q2, w2, **g)
    ref = gfc.freq_gemm_plain(q1, w1, q2, w2, **g)
    a, r = errs["greens_freq_k3c"].add(got, ref, "phase10 K3(c) GEMM")
    k_ms = _ms(lambda: gfc.freq_gemm(q1, w1, q2, w2, **g))
    p_ms = _ms(lambda: gfc.freq_gemm_plain(q1, w1, q2, w2, **g), reps=1)
    print(f"phase10 K3(c) alone (S, N, M, F) = (10000, 128, 128, {F}), bins {k0}.."
          f"{k0 + F}: max_abs_err={a:.3e} rel={r:.3e}; K3(c) {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms")
    assert r < TOL, r
    return launches, (k_ms, p_ms), ctl


def phase11(torch, qt, gfc, errs):
    """K3(b) and K3(c) at 10^5 scatterers x 128 x 128. Each kernel runs its
    whole band; the plain version and the library yardstick run 32 bins of
    it (timed with CUDA events after a warm-up, as the kernels are), and
    their times are scaled to the band. Returns {name: (ms, scaled plain ms,
    bound, scaled library ms)} and, under 'control', the K3(b) control
    reading on the 32 bins, and under 'k3a' K3(a)'s ms and scaled library ms
    on K3(b)'s band."""
    from qups_tpu_torch.ops.greens_freq import host_plan, prologue
    from qups_tpu_torch.ops.simus import simus_prologue

    us, _, _ = _main_system(qt)
    speck = _speckle(qt, 100_000, 11)
    ps, kern, pn, pv, kw = us._greens_problem(speck)
    plan = host_plan(kern, ps, pn, pv, T=kw["T"], s0=kw["s0"], t0k=kw["t0k"], fs=kw["fs"],
                     cinv=kw["cinv"], fsr=kw["fsr"], rtol=0.0)
    ops_b = prologue(plan["phc"], ps, speck.amp, pn, pv, R0=kw["R0"], fsr=kw["fsr"],
                     device="cuda")
    k0, F = _simus_band(us, kw["T"])
    sl = np.float32(kw["fs"] / (kw["T"] * 1540.0))
    q1, w1, s1, q2, w2, s2 = simus_prologue(
        ps, speck.amp, pn[:, 0], np.zeros(128), pv[:, 0], np.zeros(128),
        [us.tx.width, us.rx.width], sl, baffle="soft", device="cuda")
    cases = {"greens_freq_k3b": (ops_b, dict(k0=plan["k0"], bf16=True), plan["k1"] - plan["k0"],
                                 "greens bf16, full band"),
             "greens_freq_k3c": ((q1, w1, q2, w2), dict(k0=k0, s1=s1, s2=s2), F,
                                 "simus directivity, -60 dB band")}
    out = {}
    for name, (ops, g, F, what) in cases.items():
        ms = _ms(lambda: gfc.freq_gemm(*ops, F=F, **g), reps=2)
        sub = dict(g, k0=g["k0"] + F // 2, F=32)
        got = gfc.freq_gemm(*ops, **sub)
        ref = gfc.freq_gemm_plain(*ops, **sub)
        a, r = errs[name].add(got, ref, f"phase11 {what}, 32 bins")
        if g.get("bf16"):
            ctl = _control(gfc.freq_gemm(*ops, **dict(sub, bf16=False)), ref,
                           "phase11 GEMM, 32 bins")
            sub_a = sub
        del ref
        p32 = _ms(lambda: gfc.freq_gemm_plain(*ops, **sub), reps=2)
        plain_ms = p32 * F / 32
        flops = 8.0 * F * 100_000 * 128 * 128
        bf = bool(g.get("bf16"))
        lib_ms = _k3_library(torch, gfc, ops, sub, bf) * F / 32
        print(f"phase11 {name} {what}: (S, N, M, F) = (100000, 128, 128, {F}): "
              f"{ms:.3f} ms, {flops / (ms / 1e3) / 1e12:.2f} TFLOP/s of complex MACs; plain "
              f"on 32 bins {p32:.3f} ms, scaled to the band {plain_ms:.3f} ms; "
              f"library yardstick on 32 bins, scaled {lib_ms:.3f} ms; "
              f"32 bins vs plain: max_abs_err={a:.3e} rel={r:.3e}")
        b = bound(flops, BF16_FLOPS if bf else F32_FLOPS, _k3_bytes(F, "s1" in g))
        _share(f"phase11 {name}", ms, b)
        assert r < (TOL_K3B if bf else TOL), (name, r)
        out[name] = (ms, plain_ms, b, lib_ms)
    out["control"] = ctl
    F = plan["k1"] - plan["k0"]
    ms32 = _ms(lambda: gfc.freq_gemm(*ops_b, F=F, k0=plan["k0"]), reps=1)
    lib_a = _k3_library(torch, gfc, ops_b, sub_a, False) * F / 32
    print(f"phase11 K3(a) float32 operands on the same full band: {ms32:.3f} ms; library "
          f"yardstick (complex64 torch.bmm) on 32 bins, scaled {lib_a:.3f} ms")
    _share("phase11 K3(a)", ms32, bound(8.0 * F * 100_000 * 128 * 128, F32_FLOPS,
                                        _k3_bytes(F, False)))
    out["k3a"] = (ms32, lib_a)
    return out


# K1(b) and K2(b): the trace kinds (complex traces, remodulated), the frame
# shapes of phase 12, and the remodulation frequency of phases 12 and 14
IQ_CASES = {"real+fmod": (False, True), "complex+fmod": (True, True),
            "complex": (True, False)}
FRAME_SHAPES = ((1,), (3,), (6,), (2, 3))
FMOD = 5e6


def _frame_traces(torch, T, N, M, fdims, cplx, seed):
    """Seeded traces (T, N, M, *fdims) on the card, complex64 or float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (T, N, M) + tuple(fdims)
    x = torch.randn(shape, generator=g, device="cuda")
    if cplx:
        x = torch.complex(x, torch.randn(shape, generator=g, device="cuda"))
    return x


def phase12(torch, das_cuda, errs, lerrs):
    """K1(b) and K2(b) vs plain: every sampler x (the three transmit models |
    geometric tables +-2 samples) x (real + fmod, complex + fmod, complex) x
    frames (1, 3, 6: a ragged block of 4, and dims (2, 3)), delays off both
    ends of the traces; the layout kernel with frames vs its plain version,
    bit for bit."""
    T, N, M, n, c0 = 2048, 128, 32, 128, 1540.0
    srcs = {m: _crossing_problem(torch, m, T, N, M, n) for m in ("plane", "diverging",
                                                                 "virtual")}
    tau_rx, tau_tx, t0, fs, _ = _lut_problem(torch, T, N, M, n, 12)
    seed = 120
    for fdims in FRAME_SHAPES:
        for case, (cplx, rot) in IQ_CASES.items():
            seed += 1
            xg = _frame_traces(torch, T, N, M, fdims, cplx, seed)
            worst = {}
            for src in ("plane", "diverging", "virtual", "tables"):
                for method in METHODS:
                    kw = dict(method=method, fmod=FMOD if rot else 0.0)
                    if src == "tables":
                        kern, plain, counter, e = (das_cuda.das_lut_sum,
                                                   das_cuda.das_lut_sum_plain,
                                                   "LUT_LAUNCHES", errs["das_lut_k2b"])
                        args, kw = (xg, tau_rx, tau_tx, t0), dict(kw, fs=fs)
                    else:
                        kern, plain, counter, e = (das_cuda.das_sum, das_cuda.das_sum_plain,
                                                   "LAUNCHES", errs["das_k1b"])
                        p = srcs[src]
                        args, kw = (xg,) + p[:5] + (np.float32(1 / c0),), dict(
                            kw, fs=p[5], tx_model=src)
                    # K1: the frames a launch from the tap stride of its pixels
                    sigma = None if src == "tables" else das_cuda.tap_stride(
                        args[1], args[6], kw["fs"])
                    blocks = -(-int(np.prod(fdims))
                               // das_cuda.frames_per_launch(method, cplx=cplx, sigma=sigma))
                    before = getattr(das_cuda, counter)
                    got = kern(*args, **kw)
                    torch.cuda.synchronize()
                    assert getattr(das_cuda, counter) == before + blocks
                    ref = plain(*args, **kw)
                    a, r = e.add(got, ref, f"phase12 F={fdims} {case} {src} {method}")
                    assert got.shape == (n * n, 1, 1) + fdims
                    assert r < TOL, (fdims, case, src, method, r)
                    worst[src] = max(worst.get(src, 0.0), r)
            print(f"phase12 F={str(fdims):7s} {case:13s} worst rel over the 4 samplers: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                  + f"  ((T,N,M,I)={(T, N, M, n * n)})")
            if fdims in ((3,), (6,)) and case != "complex+fmod":
                for method in METHODS:
                    _layout_parity(torch, das_cuda, lerrs, method, xg,
                                   f"phase12 layout F={fdims} {case} {method}")
    print("phase12 layout kernel with frames: bit-identical to trace_layout_plain for F = 3 "
          "and 6, real and complex, every sampler")
    # the short rotation alone against float64 over |phase| <= PHASE_MAX
    g = torch.Generator(device="cuda").manual_seed(12)
    pm = das_cuda.PHASE_MAX
    ph = torch.cat((torch.rand(1 << 22, generator=g, device="cuda") * (2 * pm) - pm,
                    torch.linspace(0.0, 5000.0, 1 << 20, device="cuda"),
                    (torch.arange(-4096, 4097, device="cuda", dtype=torch.float64)
                     * (np.pi / 2)).float(), torch.tensor([pm, -pm, 0.0], device="cuda")))
    sc = das_cuda.sincos_probe(ph).double()
    phd = ph.double()
    err = float(torch.maximum((sc[:, 0] - torch.sin(phd)).abs(),
                              (sc[:, 1] - torch.cos(phd)).abs()).max())
    print(f"phase12 the short rotation (sincos_reduced) of {ph.numel()} phases in "
          f"|phase| <= {pm:.0f} rad against float64: max abs error {err:.3e} "
          f"(2^{np.log2(err):.2f}), limit 2^-21")
    assert err <= 2.0 ** -21, err
    # a phase range past PHASE_MAX: the sincosf variants (das_k1_iq_wide)
    fmod = 4e9
    w = float(np.float32(2 * np.pi * fmod))
    xg = _frame_traces(torch, T, N, M, (3,), True, 199)
    for src in ("plane", "tables"):
        for method in METHODS:
            if src == "tables":
                kern, plain, e = (das_cuda.das_lut_sum, das_cuda.das_lut_sum_plain,
                                  errs["das_lut_k2b"])
                args, kw = (xg, tau_rx, tau_tx, t0), dict(fs=fs, method=method, fmod=fmod)
            else:
                p = srcs[src]
                kern, plain, e = das_cuda.das_sum, das_cuda.das_sum_plain, errs["das_k1b"]
                args, kw = (xg,) + p[:5] + (np.float32(1 / c0),), dict(
                    fs=p[5], tx_model=src, method=method, fmod=fmod)
            assert not das_cuda.reduced_rotation(w, T, kw["fs"])
            a, r = e.add(kern(*args, **kw), plain(*args, **kw),
                         f"phase12 fmod {fmod:.0e} (sincosf variants) {src} {method}")
            assert r < TOL, (src, method, r)
    print(f"phase12 fmod {fmod:.0e}, phases to {w * (T - 1) / fs:.3e} rad past PHASE_MAX: the "
          "sincosf variants of K1(b) and K2(b) within TOL of the plain version, every sampler")


def _frames_launches(das_cuda, F, method, cplx, sigma=None):
    """K1(b)'s or K2(b)'s launches, and layouts, for one call of F frames
    whose layout fits one chunk: one a block of the plan's frames a launch
    (K1: ``sigma``, the tap stride of its pixels), one layout for them all
    (in blocks, or planes where the plan runs the frames one at a time)."""
    return -(-F // das_cuda.frames_per_launch(method, cplx=cplx, sigma=sigma)), 1


def _demo_frames(qt, us, F, step=0.3e-3):
    """F frames of a 5-target phantom inside the demo's scan, the targets
    0.3 mm deeper each frame, each with two silent scatterers (at 12 and 38
    mm) that give every frame the same time window. Returns (targets of
    each frame (3, 5), Scatterers of each frame)."""
    base = np.array([[-8e-3, 0.0, 18e-3], [4e-3, 0.0, 21e-3], [0.0, 0.0, 25e-3],
                     [-4e-3, 0.0, 28e-3], [8e-3, 0.0, 31e-3]]).T
    silent = np.array([[0.0, 0.0], [0.0, 0.0], [12e-3, 38e-3]])
    tg = [base + np.array([[0.0], [0.0], [step * f]]) for f in range(F)]
    return tg, [qt.Scatterers(pos=np.concatenate([p, silent], 1),
                              amp=np.r_[np.ones(5), 0.0, 0.0], c0=1540.0) for p in tg]


def phase13(torch, qt, ops, errs):
    """The IQ ensemble path on the plane-wave demo's system, unmodified, with
    no device=: 4 frames (greens, K3) joined, hilbert, downmix(fc),
    resample(fs / 2), then DAS (K1(b)), bfDAS and the c0-map DAS (K2(b)),
    cubic2x (K1(b) on 2x traces) and bfAdjoint (K4), all with fmod = fc;
    launch counts zeroed just before and read just after; each frame's PSF;
    each call against kernel='plain'. Returns the launches."""
    das_cuda, gfc, fdbf_cuda = ops.das_cuda, ops.greens_freq_cuda, ops.fdbf_cuda
    us = _demo_system(qt)[0]
    F = 4
    targets, scats = _demo_frames(qt, us, F)
    cmap = np.full(us.scan.shape, 1540.0)
    calls = {
        "DAS (K1(b))": (lambda iq, **k: us.DAS(iq, fmod=us.fc, **k), "das_k1b", TOL),
        "bfDAS (K2(b))": (lambda iq, **k: us.bfDAS(iq, fmod=us.fc, **k), "das_lut_k2b", TOL),
        "DAS c0 map (K2(b))": (lambda iq, **k: us.DAS(iq, fmod=us.fc, c0=cmap, **k),
                               "das_lut_k2b", TOL),
        "DAS cubic2x (K1(b))": (lambda iq, **k: us.DAS(iq, fmod=us.fc, method="cubic2x", **k),
                                "das_k1b", TOL),
        "bfAdjoint (K4)": (lambda iq, **k: us.bfAdjoint(iq, fmod=us.fc, **k),
                           "fdbf_adjoint_k4", TOL_BF16),
    }

    def chain():
        chds = [us.greens(sc) for sc in scats]
        return chds[0].join(chds[1:]).hilbert().downmix(us.fc).resample(us.fs / 2)

    das_cuda.LAUNCHES = das_cuda.LUT_LAUNCHES = das_cuda.LAYOUT_LAUNCHES = 0
    gfc.LAUNCHES = fdbf_cuda.LAUNCHES = 0
    t = time.perf_counter()
    iq = chain()
    imgs = {name: fn(iq) for name, (fn, _, _) in calls.items()}
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t
    launches = {"das_k1b": das_cuda.LAUNCHES, "das_lut_k2b": das_cuda.LUT_LAUNCHES,
                "das_layout": das_cuda.LAYOUT_LAUNCHES, "greens_freq_k3": gfc.LAUNCHES,
                "fdbf_adjoint_k4": fdbf_cuda.LAUNCHES}
    print(f"phase13 IQ ensemble path (4 x greens -> join -> hilbert -> downmix -> resample "
          f"-> DAS, bfDAS, DAS c0 map, DAS cubic2x, bfAdjoint, fmod = fc): {t_path:.3f} s "
          f"(first call) -> IQ {tuple(iq.data.shape)} {iq.data.dtype} at {iq.fs / 1e6} MHz on "
          f"{iq.data.device}; launches {launches}")
    assert iq.data.is_cuda and iq.data.is_complex() and iq.data.shape[2:] == (5, F)
    (nc, lc), (nl, ll) = (_frames_launches(das_cuda, F, m, True, sg) for m, sg in (
        ("cubic", None), ("linear", das_cuda.tap_stride(us._pixels(), 1 / 1540.0, 2 * iq.fs))))
    assert launches["das_k1b"] == nc + nl and launches["das_lut_k2b"] == 2 * nc, launches
    assert launches["das_layout"] == 3 * lc + ll and all(v > 0 for v in launches.values()), \
        launches
    _, t_chain = _sync_s(torch, chain)
    print(f"phase13 the 4 frames' simulation and DSP chain, warm (host clock, synchronised): "
          f"{t_chain * 1e3:.3f} ms")
    for name, (fn, kern, tol) in calls.items():
        b = imgs[name]
        assert b.is_cuda and b.dtype == torch.complex64
        assert b.shape == tuple(us.scan.shape) + (1, 1, F), (name, b.shape)
        assert bool(torch.isfinite(b).all()), name
        for f in range(F):
            _psf(us, b[..., f], targets[f], f"{name} frame {f}", "phase13")
        ref, t_plain = _sync_s(torch, lambda: fn(iq, kernel="plain"))
        a, r = errs[kern].add(b, ref, f"phase13 {name}")
        _, t_k = _sync_s(torch, lambda: fn(iq))
        print(f"phase13 {name:20s} vs plain: max_abs_err={a:.3e} rel={r:.3e}; wall (host "
              f"clock, synchronised, warm) {t_k * 1e3:.3f} ms vs plain {t_plain * 1e3:.3f} ms")
        assert r < tol, (name, r)
    return launches


# flops of a K1(b) / K2(b) term, as phase 14's bound counts them. Once per
# term: the delay (K1 4: add, product, difference, scale; K2 3), the tap
# base and fraction 3, the phase 1 and its sin and cos 20 (counted for a
# 3-FMA reduction and two short polynomials, PR 7's count, kept); per
# frame: the sampler on complex traces
# (cubic 2 x 3 FMA, 12; linear 2 FMA, 4; nearest 0; lanczos3 2 x 4 taps, 16,
# with its weights 30 once per term), the complex product 6 and the sum 2.
TERM_FLOPS = {"nearest": 0, "linear": 4, "cubic": 12, "lanczos3": 16}


def _iq_term_flops(method, lut, F, rot=True):
    once = (3 if lut else 4) + 3 + (21 if rot else 0) + (30 if method == "lanczos3" else 0)
    return once + F * (TERM_FLOPS[method] + (6 if rot else 0) + 2)


def iq_headline(torch, qt, T=4096, F=4, fs=31.25e6):
    """Phase 14's IQ traces: bench.das_problem's traces (1024^2 pixels, 256
    x 256) as frame 0 and seeded draws as the others, (T, N, M, F) at fs,
    through hilbert, downmix(FMOD) and resample(fs / 4) on the card (T'
    1024 complex64, 2 GiB). Returns (the IQ ChannelData, (pi, pr, pv, nv),
    the chain's ms: CUDA events, one run after a warm-up)."""
    from qups_tpu_torch import bench

    x0, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=256, M=256, n=1024)
    xg = torch.empty(x0.shape + (F,), device="cuda")
    xg[..., 0] = torch.as_tensor(x0)
    del x0
    for f in range(1, F):
        xg[..., f] = torch.as_tensor(np.random.default_rng(f).standard_normal(
            xg.shape[:3], dtype=np.float32))
    rf = qt.ChannelData(data=xg, fs=fs, t0=t0)
    dsp = lambda: rf.hilbert().downmix(FMOD).resample(fs / 4)  # noqa: E731
    dsp_ms = _ms(dsp, reps=1)
    iq = dsp()
    del rf, xg
    torch.cuda.synchronize()
    return iq, (pi, pr, pv, nv), dsp_ms


def phase14(torch, qt, das_cuda, errs):
    """The headline in IQ: bench.das_problem's traces as frame 0 and three
    seeded draws, 4096 x 256 x 256 x 4 at 31.25 MHz, through hilbert,
    downmix(5 MHz) and resample(fs / 4) on the card (T' 1024, complex, 2 GiB;
    complex cubic runs as one-frame calls, each frame's layout 2 GiB in one
    chunk); then K1(b) and K2(b) for every
    sampler: the 4 frames in one call, the same frames as 4 one-frame calls,
    and both without fmod, timed with CUDA events (mean of 3
    after a warm-up, lanczos3 1), each against the plain version on every
    64th pixel. Returns {kernel: (ms, plain ms scaled, bound)} at cubic, and
    the IQ traces with the geometry and pixel subset, for phase 18."""
    from qups_tpu_torch import bench
    from qups_tpu_torch.ops.das import delay_tables

    n, N, M, F = 1024, 256, 256, 4
    iq, (pi, pr, pv, nv), dsp_ms = iq_headline(torch, qt)
    x = iq.data
    Tq = x.shape[0]
    print(f"phase14 DSP chain hilbert -> downmix(5 MHz) -> resample(fs / 4) on "
          f"{(4096, N, M, F)} float32: {dsp_ms:.3f} ms (CUDA events, one run after a warm-up) "
          f"-> IQ {tuple(x.shape)} {x.dtype} ({x.numel() * 8 / 2**30:.2f} GiB), "
          f"t0 {tuple(np.shape(iq.t0))}; one frame's cubic layout in "
          f"{len(das_cuda.tx_chunks(x[..., :1], 'cubic'))} chunk(s)")
    assert Tq == 1024 and x.is_complex()
    ones = [x[..., f].contiguous() for f in range(F)]
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    cinv, fsq = np.float32(1 / 1540.0), iq.fs
    w = float(np.float32(2 * np.pi * FMOD))
    phase = abs(w) * (Tq - 1) / float(np.float32(fsq))
    assert das_cuda.reduced_rotation(w, Tq, fsq), phase
    plan = {m: das_cuda.frames_per_launch(m) for m in METHODS}
    print(f"phase14 K1(b)/K2(b) plan on complex float32 traces: frames a launch {plan}, "
          f"the frames innermost in the layout (one-frame calls where 1); the phases within "
          f"{phase:.1f} rad, the short rotation (PHASE_MAX {das_cuda.PHASE_MAX:.0f} rad)")
    sub = torch.arange(0, n * n, 64, device="cuda")  # every 64th pixel
    pig = torch.as_tensor(pi).cuda()
    k1 = (das_cuda.das_sum, das_cuda.das_sum_plain,
          lambda xx, rows=None: (xx, pig if rows is None else pig[rows], pr, pv, nv, iq.t0,
                                 cinv),
          dict(fs=fsq, tx_model="plane"), "das_k1b", False)
    k2 = (das_cuda.das_lut_sum, das_cuda.das_lut_sum_plain,
          lambda xx, rows=None: (xx, tau_rx if rows is None else tau_rx[rows],
                                 tau_tx if rows is None else tau_tx[rows], iq.t0),
          dict(fs=fsq), "das_lut_k2b", True)
    terms = float(n * n) * N * M
    nbytes = lambda lut: x.numel() * 8.0 + n * n * F * 8.0 + (  # noqa: E731
        4.0 * n * n * (N + M) if lut else 12.0 * n * n)
    out = {}
    for kern, plain, args, kw, name, lut in (k1, k2):
        for method in METHODS:
            k = dict(kw, method=method)
            reps = _reps(method)
            t4 = _ms(lambda: kern(*args(x), fmod=FMOD, **k), reps)
            t1 = _ms(lambda: [kern(*args(o), fmod=FMOD, **k) for o in ones], reps)
            t0f = _ms(lambda: kern(*args(x), fmod=0.0, **k), reps)
            t10 = _ms(lambda: [kern(*args(o), fmod=0.0, **k) for o in ones], reps)
            got = kern(*args(x), fmod=FMOD, **k)[sub]
            ref, t_plain = _sync_s(torch, lambda: plain(*args(x, sub), fmod=FMOD, **k))
            a, r = errs[name].add(got, ref, f"phase14 {method} every 64th pixel")
            assert r < TOL, (name, method, r)
            b = bound(_iq_term_flops(method, lut, F) * terms, F32_FLOPS, nbytes(lut))
            b1 = bound(_iq_term_flops(method, lut, 1) * terms, F32_FLOPS, nbytes(lut) / F)
            b0 = bound(_iq_term_flops(method, lut, F, rot=False) * terms, F32_FLOPS,
                       nbytes(lut))
            rate = terms * F / (t4 / 1e3)
            print(f"phase14 {name} {method:8s} 1024^2 x 256 x 256 x 4 frames, T' {Tq} IQ: "
                  f"4 frames in one call {t4:.3f} ms ({rate:.4e} sums/s, "
                  f"{rate / bench.BASELINE_SUMS_PER_S:.3f}x the RTX-3070 figure); 4 one-frame "
                  f"calls {t1:.3f} ms; without fmod {t0f:.3f} ms, as 4 one-frame calls "
                  f"{t10:.3f} ms; the rotation's cost (fmod - none, 4 frames) "
                  f"{t4 - t0f:.3f} ms; {das_cuda.frames_per_launch(method)} frames a launch, "
                  f"one call / 4 calls {t4 / t1:.3f} (fmod), {t0f / t10:.3f} (none); bounds (ops) "
                  f"{b[0]:.3f} / {4 * b1[0]:.3f} / {b0[0]:.3f} ms "
                  f"({_iq_term_flops(method, lut, F)} / {4 * _iq_term_flops(method, lut, 1)} / "
                  f"{_iq_term_flops(method, lut, F, rot=False)} flop per term); plain on every "
                  f"64th pixel {t_plain * 1e3:.3f} ms; max_abs_err={a:.3e} rel={r:.3e}")
            if method == "cubic":
                out[name] = (t4, 64 * t_plain * 1e3, b)
            del got, ref
    return out, (iq, pig, pr, pv, nv, sub)


KEEP_MODES = {"": {}, "rx": dict(keep_rx=True), "tx": dict(keep_tx=True),
              "both": dict(keep_rx=True, keep_tx=True)}
WEIGHT_KINDS = ("none", "aperture_growth", "acceptance_angle", "tx_scanline", "tx_multiline",
                "tx_parallelogram", "mixed", "dense (I, N, 1)", "dense (1, N, M)")


def _phase15_weights(qt, kind, n, N, M, rng):
    """Phase 15's apodization of one kind at its shapes (pixels on x in
    +-15 mm, receivers on x in +-19 mm, M transmits)."""
    lat_tx = np.linspace(-15e-3, 15e-3, M)
    return {
        "none": (),
        "aperture_growth": (qt.Fused("aperture_growth", f=1.0, Dmax=20e-3),),
        "acceptance_angle": (qt.Fused("acceptance_angle", theta=40.0),),
        "tx_scanline": (qt.Fused("tx_scanline", tol=1.5e-3, lat_tx=lat_tx),),
        "tx_multiline": (qt.Fused("tx_multiline", dlat=1.2e-3, lat_tx=lat_tx),),
        "tx_parallelogram": (qt.Fused("tx_parallelogram", xlo=-12e-3, xhi=14e-3),),
        "mixed": (qt.Fused("aperture_growth", f=1.5), qt.Fused("tx_parallelogram",
                                                               xlo=-12e-3, xhi=14e-3)),
        "dense (I, N, 1)": (rng.uniform(0, 1, (n, n, 1, N, 1)).astype(np.float32),),
        "dense (1, N, M)": (rng.uniform(0, 1, (1, 1, 1, N, M)).astype(np.float32),),
    }[kind]


def phase15(torch, qt, das_cuda, errs):
    """K1(c), K1(d) and K2(c) against their plain versions at phase 12's
    shapes (T 2048, N 128, M 32, 128^2 px): every keep mode x each fused
    kind alone, two mixed and two dense weights x (the three transmit
    models | perturbed tables, which take no Fused) x one of (real + fmod,
    complex, complex + fmod) x frames (1, 3) in turn, nearest and cubic
    (keep_rx unweighted and mixed: all four samplers); delays off both ends
    of the traces; receivers tilted up to +-10 degrees."""
    T, N, M, n, c0 = 2048, 128, 32, 128, 1540.0
    srcs = {m: _crossing_problem(torch, m, T, N, M, n) for m in ("plane", "diverging",
                                                                 "virtual")}
    tau_rx, tau_tx, t0l, fsl, _ = _lut_problem(torch, T, N, M, n, 15)
    az = np.radians(np.linspace(-10.0, 10.0, N))
    ori = np.stack([np.sin(az), np.cos(az)])
    rng = np.random.default_rng(15)
    cases = [(cplx, rot, F) for (cplx, rot) in ((False, True), (True, False), (True, True))
             for F in ((), (3,))]
    traces = {}
    t = time.perf_counter()
    count, worst = 0, {}
    for ki, keep in enumerate(KEEP_MODES):
        for wi, kind in enumerate(WEIGHT_KINDS):
            if keep == "" and kind == "none":
                continue
            apod = _phase15_weights(qt, kind, n, N, M, rng)
            fused = any(isinstance(a, qt.Fused) for a in apod)
            for si, src in enumerate(("plane", "diverging", "virtual", "tables")):
                if src == "tables" and fused:
                    continue  # K2 takes dense weights (Fused.materialize)
                cplx, rot, fd = cases[(ki + wi + si) % len(cases)]
                key = (cplx, fd)
                if key not in traces:
                    traces[key] = _frame_traces(torch, T, N, M, fd, cplx, 150 + len(traces))
                xg = traces[key]
                methods = METHODS if keep == "rx" and kind in ("none", "mixed") \
                    else ("nearest", "cubic")
                for method in methods:
                    kw = dict(method=method, fmod=FMOD if rot else 0.0, apod=apod,
                              im_shape=(n, n, 1), **KEEP_MODES[keep])
                    if src == "tables":
                        kern, plain, name = (das_cuda.das_lut_sum, das_cuda.das_lut_sum_plain,
                                             "das_lut_k2c")
                        args, kw = (xg, tau_rx, tau_tx, t0l), dict(kw, fs=fsl)
                    else:
                        kern, plain = das_cuda.das_sum, das_cuda.das_sum_plain
                        name = "das_k1c" if keep else "das_k1d"
                        p = srcs[src]
                        args = (xg,) + p[:5] + (np.float32(1 / c0),)
                        kw = dict(kw, fs=p[5], tx_model=src, orientations=ori)
                    got = kern(*args, **kw)
                    torch.cuda.synchronize()
                    ref = plain(*args, **kw)
                    a, r = errs[name].add(got, ref, f"phase15 keep={keep!r} {kind} {src} "
                                                    f"{method} cplx={cplx} fmod={rot} F={fd}")
                    assert got.shape == (n * n, N if "keep_rx" in kw else 1,
                                         M if "keep_tx" in kw else 1) + fd, got.shape
                    assert r < TOL, (keep, kind, src, method, cplx, rot, fd, r)
                    worst[keep] = max(worst.get(keep, 0.0), r)
                    count += 1
                    del got, ref
    print(f"phase15 K1(c)/(d), K2(c) vs plain: {count} calls in {time.perf_counter() - t:.1f} s; "
          "worst rel per keep mode: " + ", ".join(f"{k or 'summed'} {v:.3e}"
                                                 for k, v in worst.items())
          + f"  ((T,N,M,I)={(T, N, M, n * n)})")
    _phase15_edges(torch, qt, das_cuda, errs)


def _phase15_edges(torch, qt, das_cuda, errs):
    """The keep kernel's variants at their edges, at phase 15's shapes with
    N 100 (receiver chunks 32 + 32 + 32 + 4: a sub-chunk of KEEP_NCK or
    KEEP_NCK_WIDE receivers past each chunk's end): each keep mode
    unweighted and weighted
    (masks: aperture growth and a parallelogram; real-valued: acceptance
    angle and a dense (1, N, M) weight; on the tables the dense weight) x F
    1, 3 x no rotation, the short rotation (fmod 5 MHz) and
    sincosf (fmod 20 GHz, phases past PHASE_MAX: the _iq_wide entries),
    cubic, real traces, plane waves and tables, against the plain version;
    two launches bit for bit; the launches counted, one a frame
    (KEEP_FRAMES)."""
    T, N, M, n = 2048, 100, 32, 128
    assert N % das_cuda.KEEP_NCK and N % das_cuda.KEEP_NCK_WIDE
    pi, pr, pv, nv, t0, fs, _ = _crossing_problem(torch, "plane", T, N, M, n)
    tau_rx, tau_tx, t0l, fsl, _ = _lut_problem(torch, T, N, M, n, 16)
    rng = np.random.default_rng(16)
    dense = (rng.uniform(0, 1, (1, 1, 1, N, M)).astype(np.float32),)
    weights = {"none": (), "masks": (qt.Fused("aperture_growth", f=1.5),
                                     qt.Fused("tx_parallelogram", xlo=-12e-3, xhi=14e-3)),
               "real": (qt.Fused("acceptance_angle", theta=40.0),) + dense}
    t, count, worst = time.perf_counter(), 0, {}
    for fd in ((), (3,)):
        xg = _frame_traces(torch, T, N, M, fd, False, 170 + len(fd))
        F = int(np.prod(fd, dtype=np.int64))
        for keep, kk in KEEP_MODES.items():
            for wkind, apod in weights.items():
                if keep == "" and wkind == "none":
                    continue
                weighted = wkind != "none"
                for fmod, rot in ((0.0, "none"), (FMOD, "reduced"), (2e10, "sincosf")):
                    for src in ("plane", "tables"):
                        if src == "tables" and wkind == "masks":
                            continue  # K2 takes dense weights
                        kw = dict(method="cubic", fmod=fmod, im_shape=(n, n, 1),
                                  apod=dense if src == "tables" and weighted else apod, **kk)
                        if src == "tables":
                            kern, plain, name = (das_cuda.das_lut_sum,
                                                 das_cuda.das_lut_sum_plain, "das_lut_k2c")
                            args, kw = (xg, tau_rx, tau_tx, t0l), dict(kw, fs=fsl)
                            counters = ("LUT_KEEP_LAUNCHES",)
                        else:
                            kern, plain = das_cuda.das_sum, das_cuda.das_sum_plain
                            name = "das_k1c" if keep else "das_k1d"
                            args = (xg, pi, pr, pv, nv, t0, np.float32(1 / 1540.0))
                            kw = dict(kw, fs=fs, tx_model="plane")
                            counters = (("KEEP_LAUNCHES",) if keep else ()) + (
                                ("APOD_LAUNCHES",) if weighted else ())
                        assert das_cuda.rotation(fmod, T, kw["fs"]) == rot, (fmod, rot)
                        blocks = -(-F // das_cuda.KEEP_FRAMES)
                        before = [getattr(das_cuda, c) for c in counters]
                        got = kern(*args, **kw)
                        again = kern(*args, **kw)
                        torch.cuda.synchronize()
                        where = f"phase15 edges keep={keep!r} {wkind} {src} F={fd} {rot}"
                        assert torch.equal(got, again), where
                        assert [getattr(das_cuda, c) - b for c, b in zip(counters, before)] \
                            == [2 * blocks] * len(counters), where
                        ref = plain(*args, **kw)
                        a, r = errs[name].add(got, ref, where)
                        assert r < TOL, (where, r)
                        worst[rot] = max(worst.get(rot, 0.0), r)
                        count += 1
                        del got, again, ref
    print(f"phase15 keep kernel edges (N {N}: a sub-chunk of {das_cuda.KEEP_NCK} or "
          f"{das_cuda.KEEP_NCK_WIDE} past each chunk's end; F 1, 3; no weights, masks or "
          f"real-valued weights) vs plain, "
          f"two launches bit for bit: {count} "
          f"calls in {time.perf_counter() - t:.1f} s; worst rel per rotation: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def phase16(torch, qt, das_cuda, k1_cubic_ms, errs, iq_args):
    """The headline, 1024^2 px x 256 tx x 256 rx, T 4096, cubic, real
    traces (bench.das_problem's): the summed call (phase 4's time),
    keep_rx (1 GiB out; two launches bit for bit), keep_tx, the summed call
    with aperture_growth + acceptance_angle + tx_parallelogram, K2 keep_rx
    on the plane-wave tables, and coherence_image's two steps, keep_rx then
    cohfac or slsc (64 lags) on its output; then keep_rx and keep_tx on one
    frame of phase 14's IQ headline (T' 1024, complex) with fmod 5 MHz (2
    GiB out each); CUDA events, each against the plain version on every
    64th pixel, beside its bound. Returns {kernel: (ms, plain ms scaled,
    bound)} and the coherence times."""
    from qups_tpu_torch import bench
    from qups_tpu_torch.ops.coherence import cohfac, slsc
    from qups_tpu_torch.ops.das import delay_tables

    n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
    x, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
    xg = torch.as_tensor(x).cuda()
    del x
    I = n * n
    terms = float(I) * N * M
    sub = np.arange(0, I, 64)  # every 64th pixel
    pig = torch.as_tensor(pi).cuda()
    bounds = pr[:, 0].min() - 1e-4, pr[:, 0].max() + 1e-4
    fused = (qt.Fused("aperture_growth", f=1.5), qt.Fused("acceptance_angle", theta=45.0),
             qt.Fused("tx_parallelogram", xlo=float(bounds[0]), xhi=float(bounds[1])))
    # flops, from csrc/das.cu: a cubic term 14 (its delay 4, base and
    # fraction 3, the cubic 6, its sum 1); a weighted term 2 more (the
    # product of its factors and the sample times it); a receive factor of
    # aperture growth and acceptance angle 16 a (pixel, receiver) (d and z
    # 6, their test 2, Dmax 1, the cosine test 4, the receiver's
    # difference 3) and a parallelogram factor 5 a (pixel, transmit)
    tr = 4.0 * T * N * M + 12.0 * I
    cases = {
        "keep_rx (K1(c))": ("das_k1c", dict(keep_rx=True), 14.0 * terms, 4.0 * I * N),
        "keep_tx (K1(c))": ("das_k1c", dict(keep_tx=True), 14.0 * terms, 4.0 * I * M),
        "aperture_growth + acceptance_angle + tx_parallelogram (K1(d))": (
            "das_k1d", dict(apod=fused), 16.0 * terms + 16.0 * I * N + 5.0 * I * M, 4.0 * I),
    }
    out, t_rx = {}, None
    for what, (name, extra, flops, obytes) in cases.items():
        kw = dict(fs=fs, tx_model="plane", method="cubic", **extra)
        ms = _ms(lambda: das_cuda.das_sum(xg, pig, pr, pv, nv, t0, np.float32(1 / 1540.0), **kw),
                 reps=2)
        got = das_cuda.das_sum(xg, pig, pr, pv, nv, t0, np.float32(1 / 1540.0), **kw)
        ref, t_plain = _sync_s(torch, lambda: das_cuda.das_sum_plain(
            xg, pig[sub], pr, pv, nv, t0, np.float32(1 / 1540.0), **kw))
        a, r = errs[name].add(got[sub], ref, f"phase16 {what} every 64th pixel")
        assert r < TOL, (what, r)
        b = bound(flops, F32_FLOPS, tr + obytes)
        print(f"phase16 {what}: 1024^2 x 256 x 256 T=4096 cubic, {ms:.3f} ms (layout kernel "
              f"included; the summed call, phase 4: {k1_cubic_ms:.3f} ms) -> "
              f"{tuple(got.shape)}; plain on every 64th pixel {t_plain * 1e3:.3f} ms; "
              f"max_abs_err={a:.3e} rel={r:.3e}")
        _share(f"phase16 {what}", ms, b)
        if name not in out:
            out[name] = (ms, 64 * t_plain * 1e3, b)
        if "keep_rx" in extra:
            t_rx = ms
            brx = got[:, :, 0]  # (I, N)
            assert torch.equal(got, das_cuda.das_sum(xg, pig, pr, pv, nv, t0,
                                                     np.float32(1 / 1540.0), **kw))
        del got, ref
    # coherence_image's two steps on the keep_rx output: the reduction alone
    coh = {}
    for post, fn in (("cohfac", lambda: cohfac(brx, axis=1).abs()),
                     ("slsc", lambda: slsc(brx, axis=1, lags=None))):
        r_ms = _ms(fn, reps=2)
        v = fn()
        assert bool(torch.isfinite(v).all()) and v.shape == (I,)
        assert post != "cohfac" or float(v.max()) <= 1 + 1e-6
        b = bound(0.0, F32_FLOPS, 4.0 * I * N + 4.0 * I)
        coh[post] = (t_rx, r_ms)
        print(f"phase16 coherence_image {post} (lags 64): keep_rx {t_rx:.3f} ms + the reduction "
              f"{r_ms:.3f} ms = {t_rx + r_ms:.3f} ms; the reduction's bound "
              f"{b[0]:.3f} ms (bytes), {100 * b[0] / r_ms:.1f} % of it")
    del brx
    # K2(c): keep_rx on the plane-wave tables
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    kw = dict(fs=fs, method="cubic", keep_rx=True)
    ms = _ms(lambda: das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kw), reps=2)
    got = das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kw)
    rows = torch.as_tensor(sub, device="cuda")
    ref, t_plain = _sync_s(torch, lambda: das_cuda.das_lut_sum_plain(
        xg, tau_rx[rows], tau_tx[rows], t0, **kw))
    a, r = errs["das_lut_k2c"].add(got[rows], ref, "phase16 K2 keep_rx every 64th pixel")
    assert r < TOL, r
    b = bound(13.0 * terms, F32_FLOPS, tr + 4.0 * I * (N + M) + 4.0 * I * N)
    print(f"phase16 K2 keep_rx (K2(c)) on the plane-wave tables: {ms:.3f} ms; plain on every "
          f"64th pixel {t_plain * 1e3:.3f} ms; max_abs_err={a:.3e} rel={r:.3e}")
    _share("phase16 K2 keep_rx (K2(c))", ms, b)
    out["das_lut_k2c"] = (ms, 64 * t_plain * 1e3, b)
    del tau_rx, tau_tx, got, ref, xg
    # keep_rx and keep_tx on one frame of the IQ headline, fmod 5 MHz: the
    # short rotation (phase 14's phases within PHASE_MAX)
    iq, pig, pr, pv, nv, rows = iq_args
    x1 = iq.data[..., 0].contiguous()
    Tq = x1.shape[0]
    assert das_cuda.rotation(FMOD, Tq, iq.fs) == "reduced"
    for keep, extra, kept in (("keep_rx", dict(keep_rx=True), N), ("keep_tx",
                                                                   dict(keep_tx=True), M)):
        kw = dict(fs=iq.fs, tx_model="plane", method="cubic", fmod=FMOD, **extra)
        args = lambda p: (x1, p, pr, pv, nv, iq.t0, np.float32(1 / 1540.0))  # noqa: E731
        ms = _ms(lambda: das_cuda.das_sum(*args(pig), **kw), reps=2)
        got = das_cuda.das_sum(*args(pig), **kw)[rows]
        ref, t_plain = _sync_s(torch, lambda: das_cuda.das_sum_plain(*args(pig[rows]), **kw))
        a, r = errs["das_k1c"].add(got, ref, f"phase16 IQ {keep} fmod every 64th pixel")
        assert r < TOL, (keep, r)
        b = bound(_iq_term_flops("cubic", False, 1) * terms, F32_FLOPS,
                  x1.numel() * 8.0 + 8.0 * I * kept + 12.0 * I)
        print(f"phase16 IQ headline, one frame, {keep} fmod 5 MHz (K1(c), short rotation): "
              f"1024^2 x 256 x 256 T' {Tq} complex, cubic, {ms:.3f} ms (layout kernel "
              f"included) -> ({I}, {kept if keep == 'keep_rx' else 1}, "
              f"{kept if keep == 'keep_tx' else 1}) complex64; plain on every 64th pixel "
              f"{t_plain * 1e3:.3f} ms; max_abs_err={a:.3e} rel={r:.3e}")
        _share(f"phase16 IQ {keep} fmod", ms, b)
        del got, ref
    del x1
    return out, coh


# K1(e) and K2(e): each reduced precision and the samplers it takes
PREC_METHODS = {"bf16pair": METHODS, "bf16": METHODS, "i8x4": ("cubic", "lanczos3")}
# The flops of a K1(e) / K2(e) call, as phase 18's bounds count them: the
# least arithmetic the function needs, whatever implements it, an FMA 2
# flops (the float32 peak's count), nothing for the storage format's
# decode. Once per term: the delay (K1 4, K2 3) and the tap base (nearest
# 1) and fraction (3 in all); the sampler on the rounded taps of each of
# the term's s tap sets (s = F frames, 2 F for complex traces): linear 3 a
# set (a difference and an FMA); cubic 6 a set, the Catmull-Rom cubic's
# three FMAs in u, its coefficients depending on the taps alone and so
# formed once per tap base (10 flops a tap base and part, _lp_layout_ops:
# c1 2, c2 4, c3 4, as stencil_entry forms them); lanczos3 its weights 30
# once and the dot 7 a set; the sum 1 a frame and part; remodulation the
# phase and its sincosf 21 once, the product 6 a complex frame (2 a real
# one). 'i8x4' scales each transmit's sum once: 2 flops a frame and part
# per (pixel, transmit), 2 / N a term, or, where the receivers are kept
# (keep_rx), the sum becomes an FMA with s_m / 127, 1 more a frame and
# part. (An earlier count took the cubic per term, min(1 + 15 s, 11 +
# 7 s): Horner on tap differences or the weights of u and a 4-tap dot, 24
# flops a real K1 term.)


def _lp_term_ops(precision, method, lut, F=1, cplx=False, rot=False, keep_rx=False, N=256):
    parts = 2 if cplx else 1
    sets = F * parts
    sampler = {"nearest": 0, "linear": 3 * sets, "cubic": 6 * sets,
               "lanczos3": 30 + 7 * sets}[method]
    sums = F * (2 if cplx or rot else 1)
    scale = (1.0 if keep_rx else 2.0 / N) * sums if precision == "i8x4" else 0.0
    remod = 21 + F * (6 if cplx else 2) if rot else 0
    return (3 if lut else 4) + (1 if method == "nearest" else 3) + sampler + sums + scale + remod


def _lp_layout_ops(method, samples):
    """The flops of forming the cubic's coefficients once per tap base of
    ``samples`` trace samples (parts and frames counted), 0 for the other
    samplers (see _lp_term_ops)."""
    return 10.0 * samples if method == "cubic" else 0.0


def _layout_parity_q(torch, das_cuda, lerrs, x, method, precision, where, form=None):
    """The layout kernel's entries at a reduced precision in ``form``
    (default the rounded taps: int16 bf16 bits or int8 taps; 'f32c' the
    float32 coefficients of the rounded taps, 'h16' the int8 taps'
    coefficients as half-precision bits) against trace_layout_plain, bit
    for bit."""
    sc = das_cuda.i8_scale(x) if precision == "i8x4" else None
    got = das_cuda.trace_layout(x, method, precision=precision, scale=sc, form=form)
    ref = das_cuda.trace_layout_plain(x, method, precision, sc, form)
    assert got.dtype == ref.dtype and torch.equal(got, ref), where
    if got.dtype == torch.float32:
        got, ref = got.view(torch.int32), ref.view(torch.int32)
    lerrs.add(got.to(torch.int32), ref.to(torch.int32), where)


def _acc16_check(torch, das_cuda, got, ref, k, where):
    """QUPS_DAS_ACC16's limit: every value of ``got`` a bfloat16, within
    TOL of the largest plus k bfloat16 steps (2^-7 of its size) of the
    plain version ``ref``, which rounds at the same k stores (a sum whose
    float32 value lies within rounding of a tie may round the other way),
    and fewer than 1 % of values past TOL; returns that share."""
    assert torch.equal(got, das_cuda.round_bf16_even(got)), where
    off = (got - ref).abs() - TOL * float(ref.abs().max())
    assert bool((off <= k * 2.0 ** -7 * ref.abs()).all()), where
    share = float((off > 0).float().mean())
    assert share < 1e-2, (where, share)
    return share


def phase17(torch, qt, das_cuda, errs):
    """K1(e) and K2(e) against their plain versions at phase 12's and 15's
    shapes (T 2048, N 128, M 32, 128^2 px): the layout kernel's narrow
    entries bit for bit; every precision x each sampler it takes x (the
    three transmit models | perturbed tables, not 'bf16') x two of (real,
    real + fmod, complex, complex + fmod) x frames 1 | 3 in turn; keep
    modes x weights (none, fused mixed, dense (I, N, 1), tx_multiline) in
    bf16pair and i8x4; the bfloat16 kept sums of QUPS_DAS_ACC16 (keep_rx,
    keep_tx at f32, bf16pair, i8x4), whose limit allows one bfloat16 step at
    a value whose float32 sum lies within rounding of a tie."""
    T, N, M, n, c0 = 2048, 128, 32, 128, 1540.0
    srcs = {m: _crossing_problem(torch, m, T, N, M, n) for m in ("plane", "diverging",
                                                                 "virtual")}
    tau_rx, tau_tx, t0l, fsl, _ = _lut_problem(torch, T, N, M, n, 17)
    az = np.radians(np.linspace(-10.0, 10.0, N))
    ori = np.stack([np.sin(az), np.cos(az)])
    rng = np.random.default_rng(17)
    kinds = [(cplx, rot, fd) for cplx, rot in ((False, False), (False, True), (True, False),
                                                (True, True)) for fd in ((), (3,))]
    traces = {}

    def trace(cplx, fd):
        if (cplx, fd) not in traces:
            traces[cplx, fd] = _frame_traces(torch, T, N, M, fd, cplx, 170 + len(traces))
        return traces[cplx, fd]

    t = time.perf_counter()
    nforms = 0
    for precision, methods in PREC_METHODS.items():
        for method in methods:
            forms = [None] + (["f32c"] if method == "cubic" else []) + (
                ["h16"] if method == "cubic" and precision == "i8x4" else [])
            for form in forms:  # the rounded taps, and the cubic's coefficient forms
                for cplx, fd in ((False, ()), (True, (3,)), (False, (3,)), (True, ())):
                    _layout_parity_q(torch, das_cuda, errs["das_layout"], trace(cplx, fd),
                                     method, precision, f"phase17 layout {precision} {method} "
                                                        f"{form or 'taps'} cplx={cplx} F={fd}",
                                     form)
                    nforms += 1

    def call(src, precision, method, cplx, rot, fd, **extra):
        xg = trace(cplx, fd)
        kw = dict(method=method, fmod=FMOD if rot else 0.0, precision=precision, **extra)
        if src == "tables":
            return (das_cuda.das_lut_sum, das_cuda.das_lut_sum_plain,
                    (xg, tau_rx, tau_tx, t0l), dict(kw, fs=fsl), "das_lut_k2e")
        p = srcs[src]
        return (das_cuda.das_sum, das_cuda.das_sum_plain, (xg,) + p[:5] + (np.float32(1 / c0),),
                dict(kw, fs=p[5], tx_model=src, orientations=ori), "das_k1e")

    def check(kern, plain, args, kw, name, where):
        before = das_cuda.PREC_LAUNCHES + das_cuda.LUT_PREC_LAUNCHES
        got = kern(*args, **kw)
        torch.cuda.synchronize()
        assert das_cuda.PREC_LAUNCHES + das_cuda.LUT_PREC_LAUNCHES > before, where
        ref = plain(*args, **kw)
        a, r = errs[name].add(got, ref, where)
        assert r < TOL, (where, r)
        return r

    # a real cubic call at 'bf16pair' or 'bf16' is the float32 term on the
    # rounded taps' float32 layout: bit for bit das_sum(round_taps(x), 'f32')
    same = 0
    for precision in ("bf16pair", "bf16"):
        for src in ("plane", "virtual", "tables"):
            if src == "tables" and precision == "bf16":
                continue
            for fd in ((), (3,)):
                for rot in (False, True):
                    xg = trace(False, fd)
                    kern, _, args, kw, _ = call(src, precision, "cubic", False, rot, fd)
                    got = kern(*args, **kw)
                    ref = kern(das_cuda.round_taps(xg, precision), *args[1:],
                               **dict(kw, precision="f32"))
                    assert torch.equal(got, ref), ("f32c bit for bit", precision, src, fd, rot)
                    same += 1
    count, worst = 0, {}
    for pi_, (precision, methods) in enumerate(PREC_METHODS.items()):
        for mi, method in enumerate(methods):
            for si, src in enumerate(("plane", "diverging", "virtual", "tables")):
                if src == "tables" and precision == "bf16":
                    continue  # K2 takes no 'bf16', as das_lut_plan
                for j in range(2):
                    cplx, rot, fd = kinds[(pi_ + mi + si + 4 * j) % len(kinds)]
                    c = call(src, precision, method, cplx, rot, fd)
                    r = check(*c, f"phase17 {precision} {method} {src} cplx={cplx} "
                                  f"fmod={rot} F={fd}")
                    worst[precision] = max(worst.get(precision, 0.0), r)
                    count += 1
    weights = {"none": (), "mixed": (qt.Fused("aperture_growth", f=1.5),
                                     qt.Fused("tx_parallelogram", xlo=-12e-3, xhi=14e-3)),
               "dense (I, N, 1)": (rng.uniform(0, 1, (n, n, 1, N, 1)).astype(np.float32),),
               "tx_multiline": (qt.Fused("tx_multiline", dlat=1.2e-3,
                                         lat_tx=np.linspace(-15e-3, 15e-3, M)),)}
    for pi_, precision in enumerate(("bf16pair", "i8x4")):
        for ki, keep in enumerate(KEEP_MODES):
            for wi, (kind, apod) in enumerate(weights.items()):
                if keep == "" and kind == "none":
                    continue
                fused = any(isinstance(a, qt.Fused) for a in apod)
                src = ("plane", "diverging", "virtual", "tables")[(ki + wi) % (3 if fused else 4)]
                cplx, rot, fd = kinds[(pi_ + ki + wi) % len(kinds)]
                method = (("nearest", "cubic") if precision == "bf16pair"
                          else ("cubic", "lanczos3"))[(ki + wi) % 2]
                c = call(src, precision, method, cplx, rot, fd, apod=apod, im_shape=(n, n, 1),
                         **KEEP_MODES[keep])
                r = check(*c, f"phase17 keep={keep!r} {kind} {precision} {method} {src} "
                              f"cplx={cplx} fmod={rot} F={fd}")
                worst[f"{precision} keep"] = max(worst.get(f"{precision} keep", 0.0), r)
                count += 1
    # QUPS_DAS_ACC16: the kept sums stored as bfloat16, K1 only
    os.environ["QUPS_DAS_ACC16"] = "1"
    try:
        acc = []
        for precision in ("f32", "bf16pair", "i8x4"):
            for keep, k in (("rx", 1), ("tx", -(-N // das_cuda.NC))):
                kern, plain, args, kw, _ = call("virtual", precision, "cubic", False, True, (),
                                                **KEEP_MODES[keep])
                before = das_cuda.PREC_LAUNCHES
                got = kern(*args, **kw)
                torch.cuda.synchronize()
                assert das_cuda.PREC_LAUNCHES == before + 1
                ref = plain(*args, **kw)
                share = _acc16_check(torch, das_cuda, got, ref, k, (precision, keep))
                acc.append(f"{precision} keep_{keep} {share:.2e}")
                count += 1
    finally:
        del os.environ["QUPS_DAS_ACC16"]
    print(f"phase17 layouts bit for bit: {nforms} (precision, sampler, form, trace type, "
          f"frames); real cubic bf16pair/bf16 calls bit for bit equal to float32 on the "
          f"rounded taps: {same}")
    print(f"phase17 K1(e), K2(e) vs plain: {count} calls in {time.perf_counter() - t:.1f} s; "
          "worst rel: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + "; QUPS_DAS_ACC16 (every value a bfloat16; share of values off by one bfloat16 "
          "step): " + ", ".join(acc) + f"  ((T,N,M,I)={(T, N, M, n * n)})")


def phase18(torch, das_cuda, k1_ms, k2_ms, iqh, iq_args, keep, errs):
    """The headline (1024^2 px x 256 tx x 256 rx, T 4096, plane wave, real)
    at each reduced precision: K1(e) for bf16pair (every sampler), bf16
    (cubic: its layout rounds half to even) and i8x4 (cubic, lanczos3),
    K2(e) for bf16pair and i8x4 (real cubic: the float32 term on the
    float32 coefficients of the rounded taps), the layout kernel alone in
    each entry form; then the IQ headline (phase 14's traces, 4 frames,
    fmod 5 MHz) in bf16pair and i8x4 cubic (bf16 taps; the int8 taps'
    half-precision coefficients) and the headline's keep_rx in i8x4,
    bf16pair and with QUPS_DAS_ACC16 (float32 traces). CUDA events (mean of
    3 after a warm-up; lanczos3 1), each beside the float32 time (phases
    4, 8, 14, 16), the plain version on every 64th pixel and its bound
    (_lp_term_ops, _lp_layout_ops). Returns {kernel: (ms, plain ms scaled,
    bound)} for the JSON rows (bf16pair cubic)."""
    from qups_tpu_torch import bench
    from qups_tpu_torch.ops.das import delay_tables

    n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
    x, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
    xg = torch.as_tensor(x).cuda()
    del x
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    I = n * n
    terms = float(I) * N * M
    sub = torch.arange(0, I, 64, device="cuda")
    pig = torch.as_tensor(pi).cuda()
    cinv = np.float32(1 / 1540.0)
    out = {}
    cases = [("K1", p, m) for p in ("bf16pair", "bf16", "i8x4") for m in PREC_METHODS[p]
             if p != "bf16" or m == "cubic"]
    cases += [("K2", p, m) for p in ("bf16pair", "i8x4") for m in PREC_METHODS[p]]
    for kern, precision, method in cases:
        lut = kern == "K2"
        kw = dict(fs=fs, method=method, precision=precision)
        if lut:
            run = lambda rows=None, f=das_cuda.das_lut_sum: f(  # noqa: E731
                xg, tau_rx if rows is None else tau_rx[rows],
                tau_tx if rows is None else tau_tx[rows], t0, **kw)
            plain = lambda rows: run(rows, das_cuda.das_lut_sum_plain)  # noqa: E731
        else:
            run = lambda rows=None, f=das_cuda.das_sum: f(  # noqa: E731
                xg, pig if rows is None else pig[rows], pr, pv, nv, t0, cinv,
                tx_model="plane", **kw)
            plain = lambda rows: run(rows, das_cuda.das_sum_plain)  # noqa: E731
        ms = _ms(run, _reps(method))
        got = run()[sub]
        ref, t_plain = _sync_s(torch, lambda: plain(sub))
        name = "das_lut_k2e" if lut else "das_k1e"
        a, r = errs[name].add(got, ref, f"phase18 {kern} {precision} {method} every 64th pixel")
        assert r < TOL, (kern, precision, method, r)
        form = das_cuda.entry_form(method, precision, False)
        lay = das_cuda._UNIT[das_cuda.FORMS[form]].itemsize * float(T) * N * M * {
            "nearest": 1, "linear": 2}.get(method, 4)
        ops = _lp_term_ops(precision, method, lut)
        b = bound(ops * terms + _lp_layout_ops(method, float(T) * N * M), F32_FLOPS,
                  4.0 * T * N * M + 4.0 * I + (4.0 * I * (N + M) if lut else 0.0))
        f32 = (k2_ms if lut else k1_ms)[method]
        print(f"phase18 {kern}(e) {precision:8s} {method:8s} 1024^2 x 256 x 256 T=4096: "
              f"{ms:.3f} ms (layout kernel included; float32 {f32:.3f} ms, x{ms / f32:.3f}); "
              f"{terms / (ms / 1e3):.4e} sums/s; plain on every 64th pixel "
              f"{t_plain * 1e3:.3f} ms; max_abs_err={a:.3e} rel={r:.3e}; bound {ops:.6g} flop "
              f"per term + {_lp_layout_ops(method, 1):.0f} per tap base; entry form {form}, "
              f"{lay / 2**30:.2f} GiB of entries")
        _share(f"phase18 {kern}(e) {precision} {method}", ms, b)
        if precision == "bf16pair" and method == "cubic":
            out[name] = (ms, 64 * t_plain * 1e3, b)
        del got, ref
    # the layout kernel alone, cubic, in each entry form
    for precision, form in (("f32", "f32"), ("bf16pair", "bf16"), ("i8x4", "i8"),
                            ("bf16pair", "f32c"), ("i8x4", "f32c"), ("i8x4", "h16")):
        sc = das_cuda.i8_scale(xg) if precision == "i8x4" else None
        ms = _ms(lambda: das_cuda.trace_layout(xg, "cubic", precision=precision, scale=sc,
                                               form=form))
        unit = das_cuda._UNIT[das_cuda.FORMS[form]].itemsize
        b = bound(_lp_layout_ops("cubic", float(T) * N * M) if form in ("f32", "f32c", "h16")
                  else 0.0, F32_FLOPS, 4.0 * T * N * M + unit * 4.0 * T * N * M)
        print(f"phase18 layout kernel alone, cubic, {precision} {form}: {ms:.3f} ms")
        _share(f"phase18 layout kernel, cubic, {precision} {form}", ms, b)
    # the headline's keep_rx in i8x4 (K1(e) in the keep kernel)
    kw = dict(fs=fs, tx_model="plane", method="cubic", keep_rx=True, precision="i8x4")
    ms = _ms(lambda: das_cuda.das_sum(xg, pig, pr, pv, nv, t0, cinv, **kw), reps=2)
    got = das_cuda.das_sum(xg, pig, pr, pv, nv, t0, cinv, **kw)[sub]
    ref, t_plain = _sync_s(torch, lambda: das_cuda.das_sum_plain(xg, pig[sub], pr, pv, nv, t0,
                                                                 cinv, **kw))
    a, r = errs["das_k1e"].add(got, ref, "phase18 keep_rx i8x4 every 64th pixel")
    assert r < TOL, r
    ops = _lp_term_ops("i8x4", "cubic", False, keep_rx=True)
    b = bound(ops * terms + _lp_layout_ops("cubic", float(T) * N * M), F32_FLOPS,
              float(T) * N * M * 4 + 4.0 * I * N)
    print(f"phase18 keep_rx i8x4 (K1(e) keep kernel) cubic: {ms:.3f} ms (float32, phase 16: "
          f"{keep['das_k1c'][0]:.3f} ms); plain on every 64th pixel {t_plain * 1e3:.3f} ms; "
          f"max_abs_err={a:.3e} rel={r:.3e}; bound {ops:.6g} flop per term + 10 per tap base")
    _share("phase18 keep_rx i8x4", ms, b)
    # and in bf16pair: the float32 unweighted keep_rx variant on the f32c layout
    kw = dict(kw, precision="bf16pair")
    ms = _ms(lambda: das_cuda.das_sum(xg, pig, pr, pv, nv, t0, cinv, **kw), reps=2)
    got = das_cuda.das_sum(xg, pig, pr, pv, nv, t0, cinv, **kw)[sub]
    ref, t_plain = _sync_s(torch, lambda: das_cuda.das_sum_plain(xg, pig[sub], pr, pv, nv, t0,
                                                                 cinv, **kw))
    a, r = errs["das_k1e"].add(got, ref, "phase18 keep_rx bf16pair every 64th pixel")
    assert r < TOL, r
    ops = _lp_term_ops("bf16pair", "cubic", False, keep_rx=True)
    b = bound(ops * terms + _lp_layout_ops("cubic", float(T) * N * M), F32_FLOPS,
              float(T) * N * M * 4 + 4.0 * I * N)
    print(f"phase18 keep_rx bf16pair (K1(e) keep kernel) cubic: {ms:.3f} ms; plain on every "
          f"64th pixel {t_plain * 1e3:.3f} ms; max_abs_err={a:.3e} rel={r:.3e}")
    _share("phase18 keep_rx bf16pair", ms, b)
    # the headline's keep_rx on float32 traces with QUPS_DAS_ACC16: the kept
    # sums stored as bfloat16 (2 of the output's 4 bytes a sum; K1(c)'s 14
    # flops a term, as phase 16)
    kw = dict(fs=fs, tx_model="plane", method="cubic", keep_rx=True)
    os.environ["QUPS_DAS_ACC16"] = "1"
    try:
        ms = _ms(lambda: das_cuda.das_sum(xg, pig, pr, pv, nv, t0, cinv, **kw), reps=2)
        got = das_cuda.das_sum(xg, pig, pr, pv, nv, t0, cinv, **kw)[sub]
        ref, t_plain = _sync_s(torch, lambda: das_cuda.das_sum_plain(xg, pig[sub], pr, pv, nv,
                                                                     t0, cinv, **kw))
    finally:
        del os.environ["QUPS_DAS_ACC16"]
    chunks = len(das_cuda.tx_chunks(xg, "cubic"))  # keep_rx stores once a chunk
    share = _acc16_check(torch, das_cuda, got, ref, chunks, "phase18 keep_rx f32 ACC16")
    a = float((got - ref).abs().max())
    r = a / float(ref.abs().max())
    b = bound(14.0 * terms, F32_FLOPS, 4.0 * T * N * M + 12.0 * I + 2.0 * I * N)
    print(f"phase18 keep_rx f32 QUPS_DAS_ACC16=1 (K1(e) keep kernel, bfloat16 kept sums) "
          f"cubic: {ms:.3f} ms (float32 sums, phase 16: {keep['das_k1c'][0]:.3f} ms); plain on "
          f"every 64th pixel {t_plain * 1e3:.3f} ms; max_abs_err={a:.3e} rel={r:.3e} "
          f"({chunks} store(s) a value; {share:.2e} of values one bfloat16 step off)")
    _share("phase18 keep_rx f32 ACC16", ms, b)
    del xg, got, ref, tau_rx, tau_tx
    # the IQ headline in bf16pair and i8x4 cubic, 4 frames in one call
    iq, pigq, prq, pvq, nvq, subq = iq_args
    xq = iq.data
    F = xq.shape[3]
    for precision in ("bf16pair", "i8x4"):
        kw = dict(fs=iq.fs, tx_model="plane", method="cubic", fmod=FMOD, precision=precision)
        args = lambda rows=None: (xq, pigq if rows is None else pigq[rows], prq, pvq,  # noqa
                                  nvq, iq.t0, cinv)
        ms = _ms(lambda: das_cuda.das_sum(*args(), **kw))
        got = das_cuda.das_sum(*args(), **kw)[subq]
        ref, t_plain = _sync_s(torch, lambda: das_cuda.das_sum_plain(*args(subq), **kw))
        a, r = errs["das_k1e"].add(got, ref, f"phase18 IQ {precision} cubic every 64th pixel")
        assert r < TOL, r
        ops = _lp_term_ops(precision, "cubic", False, F=F, cplx=True, rot=True)
        b = bound(ops * terms + _lp_layout_ops("cubic", 2.0 * xq.numel()), F32_FLOPS,
                  8.0 * xq.numel() + 8.0 * I * F)
        print(f"phase18 IQ headline, K1(e) {precision} cubic, 4 frames in one call, T' "
              f"{xq.shape[0]}: {ms:.3f} ms (float32, phase 14: {iqh['das_k1b'][0]:.3f} ms); "
              f"entry form {das_cuda.entry_form('cubic', precision, True)}, layout in "
              f"{len(das_cuda.tx_chunks(xq, 'cubic', precision))} chunk(s); plain on every 64th "
              f"pixel {t_plain * 1e3:.3f} ms; max_abs_err={a:.3e} rel={r:.3e}; bound "
              f"{ops:.6g} flop per term + 10 per tap base and part")
        _share(f"phase18 IQ {precision} cubic", ms, b)
    return out


# K4(b): the volumetric path (Part A of slice 10)
def _volume_system(qt):
    """The volumetric path's system: a 32 x 32 matrix array (0.3 mm pitch,
    3 MHz), FSA over its 1024 elements at fs = 4 fc, 64^3 voxels on x, y in
    +-5 mm, z in 20-40 mm; 5 point targets."""
    xdc = qt.TransducerMatrix(numd=(32, 32), pitch2=(0.3e-3, 0.3e-3), fc=3e6)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=xdc.numel),
        scan=qt.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 64), y=np.linspace(-5e-3, 5e-3, 64),
                              z=np.linspace(20e-3, 40e-3, 64)), fs=4 * xdc.fc)
    targets = np.array([[0.0, 0.0, 30e-3], [-3e-3, 2e-3, 24e-3], [3.5e-3, -1.5e-3, 27e-3],
                        [-2e-3, -3e-3, 34e-3], [2.5e-3, 3e-3, 37e-3]]).T  # (3, 5)
    return us, targets, qt.Scatterers(pos=targets, c0=1540.0)


def _adjoint_args(us, chd, max_bins, bins=None):
    """The arguments bfAdjoint hands K4 on ``chd`` (no frame dims), its tables
    from its cache; the bins ``bins``, else its choice of ``max_bins``."""
    from qups_tpu_torch.ops.fdbf import select_fbins

    V = us.seq.num_pulse
    tau_rx, tau_tx = us._adjoint_tables(float(us.seq.c0), chd.data.device)
    t0_off = np.broadcast_to(us.seq.t0_offset(), (V,))
    del_tx = us.seq.delays(us.tx) + t0_off[None, :]
    sel = select_fbins(chd.data, chd.fs, -40.0, max_bins) if bins is None \
        else np.asarray(bins, np.int32)
    return (chd.data, tau_rx, tau_tx, del_tx, us.seq.apodization(us.tx), chd.t0_host, t0_off,
            sel)


def _table_parity(torch, fdbf_cuda, fk, tau, sign, Lp, err, where):
    """The wide route's phasor table kernel against its plain version on
    ``tau``: every entry the bf16 rounding of a value within 2^-20 of the
    plain float32 phasor (``phasor_table_plain`` rounds the accurate one;
    the kernel's sin and cos come from the special function unit, about
    2^-21.4 from it), a second launch bit for bit. Returns the share of
    entries equal to the plain table's."""
    from qups_tpu_torch.ops.fdbf import phasor

    got = fdbf_cuda.phasor_table(fk, tau, sign, Lp)
    again = fdbf_cuda.phasor_table(fk, tau, sign, Lp)
    ref = fdbf_cuda.phasor_table_plain(fk, tau, sign, Lp)
    torch.cuda.synchronize()
    err.add(got.float(), ref.float(), where)
    L = tau.shape[1]
    g4 = got.reshape(fk.shape[0], -1, Lp, 2)
    p = torch.stack([torch.view_as_real(phasor(fk[g], tau, sign)) for g in range(fk.shape[0])])
    eps = 2.0 ** -20
    lo, hi = (p - eps).to(torch.bfloat16).float(), (p + eps).to(torch.bfloat16).float()
    k = g4[:, :, :L].float()
    assert bool(((k >= lo) & (k <= hi)).all()), where
    assert not bool(g4[:, :, L:].float().abs().any()) and torch.equal(got, again), where
    return float((got == ref).float().mean())


def _k4b_parity(torch, fdbf_cuda, us, err, terr):
    """K4 against its plain version at the volumetric path's arrays (N = M =
    1024 elements, the volume's tables on every 64th voxel), 16 bins of a
    band: V = 1024 in every keep mode and precision (bf16 on the wide route:
    the phasor tables in device memory, 128-pixel blocks; f32 keep_rx by
    chunks of conj(Ahat)); keep_rx at V = 300 in f32 in one pass and by
    forced chunks of 128 columns, in bf16 in one chunk of the wide route
    and with its budget cut to groups of 3 bins, then to one bin and two
    chunks of voxels (bit for bit against one chunk); every call launched
    twice, bit for bit. The
    phasor table kernel against its plain version on these tables. Then the
    f32 chunks' cost, keep_rx on every 4th voxel with CUDA events: V = 300
    in one pass and in three chunks, V = 1024 in the plan's chunks and
    wider. Returns {(V, precision, chunk columns or 0): [ms, ms]}."""
    from qups_tpu_torch.ops.fdbf import bf_adjoint

    fs, T = us.fs, 256
    taur, taut = us._adjoint_tables(1540.0, torch.device("cuda"))
    rows = torch.arange(0, us.scan.npix, 64, device="cuda")
    sel = np.arange(60, 76)  # 2.8-3.6 MHz at fs / T = 46.9 kHz
    fk = torch.as_tensor(sel * np.float32(fs / T), dtype=torch.float32, device="cuda")
    for sign, tau in ((-1.0, taut), (1.0, taur)):
        same = _table_parity(torch, fdbf_cuda, fk[:4], tau[rows], sign, 1024, terr,
                             f"phase19 table sign={sign:+.0f}")
        print(f"phase19 phasor table kernel vs plain, sign {sign:+.0f}, 4 bins x "
              f"{rows.numel()} voxels x 1024 elements: within 2^-20 before the bf16 "
              f"rounding; {100 * same:.4f} % of entries equal the plain table's; "
              f"max_abs_err={terr.abs:.3e}")
    plan, budget = fdbf_cuda.rx_chunk, fdbf_cuda.WIDE_BYTES

    def run(args, kw, forced, cut=None):
        fdbf_cuda.rx_chunk = plan if forced is None else (lambda *a: forced)
        fdbf_cuda.WIDE_BYTES = budget if cut is None else cut
        try:
            return fdbf_cuda.bf_adjoint_cuda(*args, **kw)
        finally:
            fdbf_cuda.rx_chunk, fdbf_cuda.WIDE_BYTES = plan, budget

    traces = {}
    for V in (1024, 300):
        x = _band_traces(torch, T, 1024, V, fs, 3e6, 19 + V)
        del_tx = np.random.default_rng(V).uniform(0, 2e-6, (1024, V))
        rest = (del_tx, np.ones((1024, V)), 1e-6, np.zeros(V), sel)
        traces[V] = (x, rest)
        args = (x, taur[rows], taut[rows], *rest)
        n = rows.numel()
        per = n * fdbf_cuda.wide_bytes(1024, 1024, V, "rx")  # one bin of all voxels
        cases = [(k, p, None, None) for k in ("", "rx", "tx") for p in ("bf16", "f32")] \
            if V == 1024 else [("rx", "f32", None, None), ("rx", "f32", 128, None),
                               ("rx", "bf16", None, None), ("rx", "bf16", None, 3 * per),
                               ("rx", "bf16", None, per // 2)]
        whole = None
        for keep, precision, forced, cut in cases:
            kw = dict(fs=fs, keep_rx=keep == "rx", keep_tx=keep == "tx", precision=precision)
            if fdbf_cuda.wide_route(1024, 1024, V, keep, precision):
                fdbf_cuda.WIDE_BYTES = budget if cut is None else cut
                plan_w = fdbf_cuda.wide_plan(n, 1024, 1024, V, sel.size, keep)
                fdbf_cuda.WIDE_BYTES = budget
                route = (f"wide route, groups of {plan_w['bins']} bins, chunks of "
                         f"{plan_w['rows']} voxels")
            else:
                vh = forced or (plan(1024, 1024, V, precision) if keep == "rx" else 0)
                route = f"chunks of {vh} columns" if vh else "one pass"
            got, again = run(args, kw, forced, cut), run(args, kw, forced, cut)
            torch.cuda.synchronize()
            ref = bf_adjoint(*args, **kw)
            a, r = err.add(got, ref, f"phase19 V={V} keep={keep!r} {precision} {route}")
            print(f"phase19 K4(b) parity V={V:4d} keep={keep!r:4s} {precision:4s} ({route}): "
                  f"max_abs_err={a:.3e} rel={r:.3e}; a second launch bit-equal: "
                  f"{bool(torch.equal(got, again))}  (T,N,M,I,K)="
                  f"{(T, 1024, 1024, rows.numel(), sel.size)}")
            assert r < (TOL_BF16 if precision == "bf16" else TOL), (V, keep, precision, r)
            assert torch.equal(got, again), (V, keep, precision)
            if V == 300 and precision == "bf16":  # the cut budget: bit for bit
                whole = got if cut is None else whole
                assert cut is None or torch.equal(got, whole), "wide route by chunks"
        del got, again, ref
    # the f32 chunks' cost: keep_rx on every 4th voxel, in turns; V = 300 in
    # one pass and in three chunks of 128 columns, V = 1024 in the plan's
    # chunks (two blocks an SM) and the widest that fit a block
    rows4 = torch.arange(0, us.scan.npix, 4, device="cuda")
    cost = {}
    for V, precision, widths in ((300, "f32", (0, 128)), (1024, "f32", (128, 384))):
        x, rest = traces[V]
        args = (x, taur[rows4], taut[rows4], *rest)
        kw = dict(fs=fs, keep_rx=True, precision=precision)
        for vh in widths + widths[::-1]:  # in turns
            ms = _ms(lambda: run(args, kw, vh or None), reps=1)
            cost.setdefault((V, precision, vh), []).append(ms)
        line = ", ".join(f"{f'chunks of {vh}' if vh else 'one pass'} "
                         f"{min(cost[(V, precision, vh)]):.3f} ms" for vh in widths)
        print(f"phase19 K4 keep_rx V={V} on every 4th voxel ({rows4.numel()} x 1024 x 1024 x "
              f"{sel.size} bins) {precision}, the better of two runs in turns: {line}")
    return cost


def phase19(torch, qt, ops, errs):
    """K4(b): parity on the wide route and the f32 chunked and one-pass
    keep_rx routes, then the volumetric path unmodified, no device=:
    us.greens (K3) and us.bfAdjoint(max_bins=64) keep '' and keep_rx (K4 on
    its wide route, N = M = V = 1024 on 64^3 voxels), PSF in 3-D, launches
    counted (K4 and the phasor table kernel); each K4 call (keep '',
    keep_rx, keep_tx) timed beside its plain version on every 64th voxel,
    its bound, its share of it and the bf16 torch.bmm yardstick of its
    products; the phasor tables' own ms. Returns the launches, the K4(b)
    row's numbers, the table kernel row's numbers and the chunk costs."""
    from qups_tpu_torch.ops.fdbf import adjoint_spectra, bf_adjoint

    fdbf_cuda, gfc = ops.fdbf_cuda, ops.greens_freq_cuda
    us, targets, scat = _volume_system(qt)
    chunk_cost = _k4b_parity(torch, fdbf_cuda, us, errs["fdbf_adjoint_k4b"],
                             errs["fdbf_phasor_table"])

    gfc.LAUNCHES = fdbf_cuda.LAUNCHES = fdbf_cuda.TABLE_LAUNCHES = 0
    t = time.perf_counter()
    chd = us.greens(scat)
    t_sim = time.perf_counter() - t
    b = us.bfAdjoint(chd, max_bins=64)
    brx = us.bfAdjoint(chd, max_bins=64, keep_rx=True)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t
    launches = {"greens_freq_k3": gfc.LAUNCHES, "fdbf_adjoint_k4b": fdbf_cuda.LAUNCHES,
                "fdbf_phasor_table": fdbf_cuda.TABLE_LAUNCHES}
    print(f"phase19 volumetric path, us.greens then us.bfAdjoint(max_bins=64) keep '' and "
          f"keep_rx, no device=: {t_path:.3f} s (first calls; greens {t_sim:.3f} s) -> traces "
          f"{tuple(chd.data.shape)} {chd.data.dtype}, images {tuple(b.shape)}, "
          f"{tuple(brx.shape)}; launches {launches}")
    # the tables of each group of bins and chunk of voxels of wide_plan:
    # keep '' Wtx and Wrx, keep_rx Wtx (at 64 bins: 2 x 64, and 64 x 2 chunks)
    I, K = us.scan.npix, _adjoint_args(us, chd, 64)[-1].size
    want = 0
    for keep in ("", "rx"):
        pl = fdbf_cuda.wide_plan(I, 1024, 1024, 1024, K, keep)
        want += -(-I // pl["rows"]) * -(-K // pl["bins"]) * (1 if keep == "rx" else 2)
    assert launches["greens_freq_k3"] > 0 and launches["fdbf_adjoint_k4b"] == 2, launches
    assert launches["fdbf_phasor_table"] == want, (launches, want)
    assert b.is_cuda and b.shape == tuple(us.scan.shape) + (1, 1)
    assert brx.shape == tuple(us.scan.shape) + (1024, 1)
    assert bool(torch.isfinite(b).all()) and bool(torch.isfinite(brx).all())
    _psf(us, b, targets, "bfAdjoint keep '' (K4(b))", "phase19")
    _psf(us, brx.sum(3), targets, "bfAdjoint keep_rx summed over the receivers (K4(b))",
         "phase19")
    del brx

    args = _adjoint_args(us, chd, 64)
    x, taur, taut, del_tx, apod, t0, t0_off, sel = args
    I, N, V, M, K, T = taur.shape[0], x.shape[1], x.shape[2], taut.shape[1], sel.size, x.shape[0]
    rows = torch.arange(0, I, 64, device="cuda")
    sub = (x, taur[rows], taut[rows], *args[3:])
    nbytes = 8.0 * T * N * V + 4.0 * I * (N + M)
    out = {}
    for keep in ("", "rx", "tx"):
        kw = dict(fs=chd.fs, keep_rx=keep == "rx", keep_tx=keep == "tx", precision="bf16")
        got = fdbf_cuda.bf_adjoint_cuda(*args, **kw)[rows]  # and the warm-up
        k_ms = _ms(lambda: fdbf_cuda.bf_adjoint_cuda(*args, **kw), reps=1, warm=False)
        ref, t_plain = _sync_s(torch, lambda: bf_adjoint(*sub, **kw))
        a, r = errs["fdbf_adjoint_k4b"].add(got, ref, f"phase19 path keep={keep!r} bf16")
        flops = 8.0 * K * I * (M + N) * V + (8.0 * K * I * V * N if keep == "rx" else 0.0)
        cols = N if keep == "rx" else (V if keep == "tx" else 1)
        bnd = bound(flops, BF16_FLOPS, nbytes + 8.0 * I * cols)
        p_ms = t_plain * 1e3 * I / rows.numel()
        plan = fdbf_cuda.wide_plan(I, M, N, V, K, keep)
        print(f"phase19 K4 keep={keep!r:4s} bf16 64^3 voxels x 1024 x 1024 x 1024 pulses x "
              f"{K} bins, wide route (groups of {plan['bins']} bins, chunks of {plan['rows']} "
              f"voxels, {plan['scratch'] / 2**30:.3f} GiB of scratch): {k_ms:.3f} ms "
              f"({flops / (k_ms / 1e3) / 1e12:.2f} TFLOP/s); plain on every 64th voxel "
              f"{t_plain * 1e3:.3f} ms, scaled {p_ms:.3f} ms; vs plain: max_abs_err={a:.3e} "
              f"rel={r:.3e}")
        _share(f"phase19 K4 keep={keep!r} bf16", k_ms, bnd)
        assert r < TOL_BF16, (keep, r)
        out[keep] = (k_ms, p_ms, bnd)
        del got, ref
    lib = _k4_library(torch, x, taur, del_tx, apod, t0, V, sel, chd.fs, taut=taut)["bf16"]
    print(f"phase19 library yardstick, the products alone (bf16 torch.bmm on the real-block "
          f"operands, 4 bins scaled): {lib:.3f} ms; K4 bf16 keep '' {out[''][0]:.3f} ms "
          f"({out[''][0] / lib:.2f}x), keep_rx {out['rx'][0]:.3f} ms, keep_tx "
          f"{out['tx'][0]:.3f} ms")
    # the phasor build alone: Wtx and Wrx of every bin, as keep '' builds them
    fk = adjoint_spectra(x, del_tx, apod, t0, t0_off, sel, fs=chd.fs)[1]
    Mp, Np = fdbf_cuda.wide_layout(M, N, V, "")[:2]
    buf = torch.empty(I * 2 * max(Mp, Np), dtype=torch.bfloat16, device="cuda")

    def tables():
        for k in range(K):
            fdbf_cuda.phasor_table(fk[k:k + 1], taut, -1.0, Mp, buf)
            fdbf_cuda.phasor_table(fk[k:k + 1], taur, 1.0, Np, buf)

    t_ms = _ms(tables, reps=2)
    t_plain = _ms(lambda: (fdbf_cuda.phasor_table_plain(fk[:1], taut, -1.0, Mp),
                           fdbf_cuda.phasor_table_plain(fk[:1], taur, 1.0, Np)), reps=1) * K
    t_bnd = bound(0.0, BF16_FLOPS, 4.0 * I * (M + N) + 4.0 * K * I * (Mp + Np))
    print(f"phase19 phasor tables, Wtx and Wrx of {K} bins at {I} voxels x {M} + {N} "
          f"elements ({K * I * (M + N):.4e} phasors, each built once a call): {t_ms:.3f} ms, "
          f"{100 * t_ms / out[''][0]:.1f} % of K4 keep ''; plain (one bin, scaled) "
          f"{t_plain:.3f} ms")
    _share("phase19 phasor tables", t_ms, t_bnd)
    wall = _sync_s(torch, lambda: us.bfAdjoint(chd, max_bins=64))[1]
    print(f"phase19 bfAdjoint keep '' wall (host clock, synchronised, warm): {wall:.3f} s")
    return launches, (*out[""], lib), (t_ms, t_plain, t_bnd, None), chunk_cost


# the eikonal beamformer (Part B of slice 10)
def phase20(torch, qt, ops, errs):
    """The eikonal path on the main system (L11-5v FSA, 256^2 px), no
    device=: bfEikonal on the default grid, in a homogeneous medium (the
    PSF, and agreement with bfDAS) and under a 1300 m/s layer over the
    first 5 mm (the on-axis target at 28 mm simulated at the effective
    speed: the peak within 1.1 mm, closer than bfDAS's); K2 launches
    counted; each call against kernel='plain'; the host solve, the tables'
    upload and K2 timed apart. Returns the path's K2 launches."""
    from qups_tpu_torch.ops.eikonal import msfm_multi
    from qups_tpu_torch.system import _cmap_zx

    das_cuda = ops.das_cuda
    us, targets, scat = _main_system(qt)
    homog = qt.Medium(c0=1540.0)
    lens = qt.Medium(c0=1540.0, pertreg=((lambda P: P[2] < 5e-3, {"c": 1300.0}),))
    c_eff = 28e-3 / (5e-3 / 1300.0 + 23e-3 / 1540.0)
    on_axis = np.array([[0.0], [0.0], [28e-3]])
    chd = us.greens(scat)
    chd_lens = us.greens(qt.Scatterers(pos=on_axis, c0=c_eff))
    torch.cuda.synchronize()

    das_cuda.LUT_LAUNCHES = 0
    t = time.perf_counter()
    b = us.bfEikonal(chd, homog)
    b_lens = us.bfEikonal(chd_lens, lens)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t
    launches = das_cuda.LUT_LAUNCHES
    print(f"phase20 eikonal path, us.bfEikonal on the default grid in two media, no device=: "
          f"{t_path:.3f} s (first calls) -> images {tuple(b.shape)}; K2 launches {launches}")
    assert launches == 2, launches
    assert b.is_cuda and b.shape == tuple(us.scan.shape) + (1, 1)
    assert bool(torch.isfinite(b).all()) and bool(torch.isfinite(b_lens).all())
    _psf(us, b, targets, "bfEikonal, homogeneous (K2)", "phase20")

    # homogeneous: bfDAS's peaks within a pixel, correlation > 0.9
    d = us.bfDAS(chd)
    P = us.scan.positions().reshape(3, -1)
    ie, idas = b.abs().reshape(-1).cpu().numpy(), d.abs().reshape(-1).cpu().numpy()
    for k in range(targets.shape[1]):
        near = np.flatnonzero(np.linalg.norm(P - targets[:, k:k + 1], axis=0) < 3e-3)
        j1 = np.unravel_index(near[np.argmax(ie[near])], us.scan.shape[:2])
        j2 = np.unravel_index(near[np.argmax(idas[near])], us.scan.shape[:2])
        assert abs(j1[0] - j2[0]) <= 1 and abs(j1[1] - j2[1]) <= 1, (k, j1, j2)
    bv, dv = b.reshape(-1), d.reshape(-1)
    corr = float((bv.conj() * dv).sum().abs() / (bv.norm() * dv.norm()))
    print(f"phase20 homogeneous: each target's peak within one pixel of bfDAS's; "
          f"correlation with bfDAS {corr:.4f}")
    assert corr > 0.9, corr
    # the lens: the on-axis peak within 1.1 mm, closer than bfDAS's
    dl = us.bfDAS(chd_lens)
    z_eik = P[2, int(b_lens.abs().reshape(-1).argmax())]
    z_das = P[2, int(dl.abs().reshape(-1).argmax())]
    print(f"phase20 lens (1300 m/s over 5 mm, target at 28 mm, simulated at {c_eff:.2f} m/s): "
          f"eikonal peak at z {z_eik * 1e3:.3f} mm, bfDAS at {z_das * 1e3:.3f} mm")
    assert abs(z_eik - 28e-3) < abs(z_das - 28e-3) + 1e-9 and abs(z_eik - 28e-3) < 1.1e-3
    for what, (c, m, img) in {"homogeneous": (chd, homog, b),
                              "lens": (chd_lens, lens, b_lens)}.items():
        ref = us.bfEikonal(c, m, kernel="plain")
        a, r = errs["das_lut_k2"].add(img, ref, f"phase20 bfEikonal {what}")
        print(f"phase20 bfEikonal {what}: K2 vs plain max_abs_err={a:.3e} rel={r:.3e}")
        assert r < TOL, (what, r)

    # where the time goes: the host solve, the sampled tables, their upload, K2
    cgrd = us._eikonal_grid()
    h = float(cgrd.dz)
    pe = us.rx.positions()  # the elements lie inside the default grid
    cells = np.stack([np.round((pe[2] - cgrd.z[0]) / h), np.round((pe[0] - cgrd.x[0]) / h)],
                     -1).astype(int)
    t = time.perf_counter()
    maps = msfm_multi(_cmap_zx(cgrd, lens.props(cgrd, "c")), h, cells)
    t_solve = time.perf_counter() - t
    t = time.perf_counter()
    tabs = us.eikonal_tables(lens, cgrd, device="cpu")
    t_tables = time.perf_counter() - t
    t = time.perf_counter()
    tabs_g = tuple(a.cuda() for a in tabs)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t
    k2_ms = _ms(lambda: us.bfDASLUT(chd_lens, *tabs_g), reps=3)
    print(f"phase20 eikonal tables: grid {cgrd.nz} x {cgrd.nx} cells at {h * 1e3:.4f} mm, "
          f"{maps.shape[0]} maps; msfm_multi alone {t_solve:.3f} s (host, {os.cpu_count()} "
          f"cores), eikonal_tables on the host (solve + cubic sampling) {t_tables:.3f} s, "
          f"upload of the (I, N) and (I, M) float32 tables {t_up * 1e3:.3f} ms, bfDASLUT "
          f"on them (K2, CUDA events, warm) {k2_ms:.3f} ms")
    assert np.isfinite(maps).all()
    return launches


# refocus and Stolt migration (Part A of slice 11)
def _hadamard(n):
    H = np.array([[1.0]])
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H


def _events_ms(torch, fn):
    """(result, ms) of one call of ``fn``, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _near_cpu(torch, got, ref, what, phase, tol=TOL):
    """The card's result against the port's own device='cpu' run:
    max|got - ref| < tol * max|ref|."""
    r = float((got.cpu() - ref).abs().max() / ref.abs().max())
    print(f"{phase} {what}: card vs device='cpu' rel={r:.3e} (limit {tol:.0e})")
    assert r < tol, (what, r)
    return r


def phase21(torch, qt, ops):
    """REFoCUS and Stolt migration on the card, no device=: the
    bench_refocus cell (T 4096, N = M = 256, Hadamard 256, gamma 0, fs
    31.25 MHz): the cold decode, the cached one and one with the default
    gamma, the norm, the solve and the apply timed apart, the norm's
    alternatives beside it; the decode as imaging on the main system
    (greens -> focusTx onto a 128 x 128 Hadamard -> refocus -> DAS); the
    bench_migration cell (4096 x 256 x 16); bfMigration on the demo
    system; the card against the port's device='cpu' runs on the demo's
    shapes. Returns {name: value} for the record and the imaging path's K1
    launches."""
    from qups_tpu_torch import system as tsystem
    from qups_tpu_torch.ops import fdbf

    das_cuda = ops.das_cuda
    out = {}
    # the bench_refocus cell, as benches.py builds it
    T, N, M, fs = 4096, 256, 256, 31.25e6
    xdc = qt.TransducerArray(numel=M, pitch=0.2e-3, fc=5e6)
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=M, c0=1540.0),
                             scan=qt.ScanCartesian(x=[0.0], z=[20e-3]), fs=fs)
    H = _hadamard(M)
    seq_enc = qt.Sequence(type="FSA", numpulse=M, c0=1540.0, apd=H, del_=np.zeros((M, M)))
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((T, N, M), generator=g, device="cuda")
    chd = qt.ChannelData(data=x, fs=fs, t0=0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tsystem._REFOCUS_OP_CACHE.clear()
    dec, t_cold = _sync_s(torch, lambda: us.refocus(chd, seq_enc, gamma=0.0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert dec.data.is_cuda and dec.data.shape == (T, N, M) and len(tsystem._REFOCUS_OP_CACHE) == 1
    # re-encoding the decode gives the traces back
    back = torch.matmul(dec.data.real.reshape(-1, M),
                        torch.as_tensor(H, dtype=torch.float32, device="cuda")).reshape(T, N, M)
    r_back = float((back - x).abs().max() / x.abs().max())
    del back, dec
    dec2, t_cached = _sync_s(torch, lambda: us.refocus(chd.replace(data=0.5 * x), seq_enc,
                                                       gamma=0.0))
    del dec2
    dec3, t_gamma = _sync_s(torch, lambda: us.refocus(chd, seq_enc))
    assert bool(torch.isfinite(dec3.data).all())
    del dec3
    tsystem._REFOCUS_OP_CACHE.clear()
    # the decode's steps apart, CUDA events, warm (each called once before)
    tau = np.zeros((M, M), np.float32)
    apd = H.astype(np.float32)
    op = lambda: fdbf.refocus_op(tau, apd, T=T, fs=fs, gamma=0.0)  # noqa: E731
    op()
    Hi, ms_op0 = _events_ms(torch, op)
    _, ms_apply = _events_ms(torch, lambda: fdbf.refocus_apply(x, Hi, 0.0, fs=fs))
    del Hi
    f = torch.as_tensor(fdbf.fftfreq32(T, fs), device="cuda")
    Hm = torch.as_tensor(apd.T, device="cuda")[None] * fdbf._cexp(
        (2 * np.pi) * f[:, None, None] * torch.as_tensor(tau.T, device="cuda")[None])
    A = torch.matmul(Hm.conj().transpose(1, 2), Hm)
    # the norm loops one eigensolver call a bin: timed on 1024 bins, scaled
    s, ms_norm = _events_ms(torch, lambda: fdbf.spectral_norm(Hm[:1024], A[:1024]))
    ms_norm *= T / 1024
    _, ms_solve = _events_ms(torch, lambda: torch.linalg.solve_ex(A, Hm.conj().transpose(1, 2))[0])
    # the norm's alternatives: cuSOLVER's batched gesvda (all bins, by
    # batches of 2^25 elements: its workspace size is a 32-bit count) and
    # torch's default ord-2 norm (64 bins, scaled); the exact norm of a
    # Hadamard encoding is sqrt(M) = 16 at every bin
    def gesvda():
        return torch.cat([torch.linalg.svdvals(Hm[k:k + 512], driver="gesvda")[:, 0]
                          for k in range(0, T, 512)])

    gesvda()
    sv, ms_sv = _events_ms(torch, gesvda)
    mn, ms_mn = _events_ms(torch, lambda: torch.linalg.matrix_norm(Hm[:64], ord=2))
    ex = np.sqrt(M)
    errs_n = {k: float((v - ex).abs().max() / ex) for k, v in
              (("eigvalsh (kept)", s), ("gesvda", sv), ("matrix_norm", mn))}
    del Hm, A
    out["refocus"] = dict(cold_s=t_cold, cached_s=t_cached, gamma_s=t_gamma, op0_ms=ms_op0,
                          apply_ms=ms_apply, norm_ms=ms_norm, solve_ms=ms_solve,
                          gesvda_ms=ms_sv, mn_ms=ms_mn * 64, peak_gib=peak)
    print(f"phase21 bench_refocus cell (T {T}, N = M = {M}, Hadamard, fs 31.25 MHz), "
          f"us.refocus on the card (host clock, synchronised): cold decode gamma 0 "
          f"{t_cold:.4f} s (operator built and applied; peak memory {peak:.2f} GiB), cached "
          f"{t_cached:.4f} s, default gamma {t_gamma:.4f} s (norm on the path); re-encoding "
          f"the decode gives the traces back within rel {r_back:.3e}")
    print(f"phase21 decode steps (CUDA events, warm): refocus_op gamma 0 {ms_op0:.3f} ms, "
          f"refocus_apply {ms_apply:.3f} ms; the default gamma's norm (eigvalsh of H^H H, "
          f"1024 bins, scaled to 4096) {ms_norm:.3f} ms and its solve {ms_solve:.3f} ms")
    print(f"phase21 norm alternatives: batched gesvda {ms_sv:.3f} ms (4096 bins), "
          f"torch.linalg.matrix_norm(ord=2) {ms_mn * 64:.3f} ms (64 bins, scaled); relative "
          f"error against the exact 16: " + ", ".join(f"{k} {v:.3e}" for k, v in errs_n.items()))
    assert r_back < TOL, r_back
    assert errs_n["eigvalsh (kept)"] < 1e-5, errs_n
    del x, chd
    torch.cuda.empty_cache()

    # the decode as imaging: the main system's FSA through a Hadamard encoding
    us, targets, scat = _main_system(qt)
    fsa = us.greens(scat)
    n = us.tx.numel
    enc_seq = qt.Sequence(type="FSA", numpulse=n, apd=_hadamard(n), del_=np.zeros((n, n)))
    enc = us.focusTx(fsa, enc_seq)
    def path():
        d = us.refocus(enc, enc_seq, gamma=0.0)
        return d, us.DAS(d)

    das_cuda.LAUNCHES = 0
    (dec, b), t_path = _sync_s(torch, path)
    k1 = das_cuda.LAUNCHES
    r_fsa = float((dec.data - fsa.data).abs().max() / fsa.data.abs().max())
    print(f"phase21 refocus imaging path (main system, 128 x 128 Hadamard, no device=): "
          f"refocus + DAS {t_path:.3f} s (first call); decoded FSA vs the original: "
          f"{r_fsa:.3e} of its peak (limit 0.05); K1 launches {k1}")
    assert r_fsa < 0.05 and k1 >= 1 and b.is_cuda
    _psf(us, b, targets, "refocus -> DAS (K1)", "phase21")

    # the bench_migration cell
    T, N, M = 4096, 256, 16
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((T, N, M), generator=g, device="cuda")
    th = np.linspace(-9.0, 9.0, M)
    mig = lambda: fdbf.stolt_migration(x, 0.0, np.zeros((N, M), np.float32), tuple(th),  # noqa
                                       fs=31.25e6, c0=1540.0, pitch=0.15e-3)
    img = mig()
    assert img.shape == (T, N, 1) and bool(torch.isfinite(img).all())
    ms_mig = _ms(mig, reps=3)
    out["migration_s"] = ms_mig / 1e3
    print(f"phase21 bench_migration cell ({T} x {N} x {M}), stolt_migration on the card: "
          f"{ms_mig / 1e3:.5f} s per frame (CUDA events, 3 runs after a warm-up)")
    del x, img

    # migration as imaging on the demo system; card against CPU on its shapes
    us, targets, scat = _demo_system(qt)
    chd = us.greens(scat)
    (b, bscan), t_mig = _sync_s(torch, lambda: us.bfMigration(chd))
    print(f"phase21 bfMigration on the demo system (5 PW, no device=): {t_mig:.3f} s (first "
          f"call), image {tuple(b.shape)}, native grid {len(bscan.z)} x {len(bscan.x)}")
    assert b.is_cuda and b.shape == tuple(us.scan.shape) + (1, 1)
    _psf(us, b, targets, "bfMigration", "phase21")
    chd_cpu = chd.replace(data=chd.data.cpu())
    ref, _ = us.bfMigration(chd_cpu, device="cpu")
    out["mig_cpu_rel"] = _near_cpu(torch, b, ref, "bfMigration, demo", "phase21")
    # the rank-1 bin f = 0 of a plane-wave encoding stops gesvda
    Hpw = torch.as_tensor(us.seq.apodization(us.tx).T, dtype=torch.complex64,
                          device="cuda")[None]  # (1, V, M) at f = 0
    try:
        torch.linalg.svdvals(Hpw.transpose(1, 2), driver="gesvda")
        print("phase21 gesvda on the demo's plane-wave encoding at f = 0 (rank 1): ran")
    except RuntimeError as e:
        print(f"phase21 gesvda on the demo's plane-wave encoding at f = 0 (rank 1): "
              f"{str(e).splitlines()[0][:120]}")
    s1 = float(fdbf.spectral_norm(Hpw)[0])
    print(f"phase21 the kept norm there: {s1:.6f} (exact sqrt(V M) = "
          f"{np.sqrt(Hpw.shape[1] * Hpw.shape[2]):.6f})")
    assert abs(s1 - np.sqrt(Hpw.shape[1] * Hpw.shape[2])) < 1e-5 * s1
    dec = us.refocus(chd)
    ref = us.refocus(chd_cpu, device="cpu")
    out["ref_cpu_rel"] = _near_cpu(torch, dec.data, ref.data, "refocus (default gamma), demo",
                                   "phase21")
    tsystem._REFOCUS_OP_CACHE.clear()
    return out, k1


# the full-wave simulator and the ray path integrals (Part B of slice 11)
def _kernel_steps(torch, fn, steps):
    """(kernels a step, device busy ms a step) of ``fn`` (``steps`` steps)
    from torch.profiler: the CUDA kernels and copies it ran, their device
    time. (None, None) when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not dev:
        return None, None
    busy = sum(e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total
               for e in dev) / 1e3
    return len(dev) / steps, busy / steps


def _blob_medium(qt, targets, lam):
    """Medium(c0 1540, rho0 1000) with a density-2000 blob of radius
    lambda / 2 at each target."""
    def blobs(P):
        m = np.zeros(P.shape[1:], bool)
        for k in range(targets.shape[1]):
            m |= np.hypot(P[0] - targets[0, k], P[2] - targets[2, k]) < lam / 2
        return m
    return qt.Medium(c0=1540.0, rho0=1000.0, pertreg=((blobs, {"rho": 2000.0}),))


def phase22(torch, qt, ops):
    """The full-wave simulator and the ray path integrals on the card, no
    device=: the bench_fdtd cell (225^2, 400 steps: ms a step, kernels a
    step, against the device='cpu' run); kspaceFirstOrder on the demo
    system's default grid through 20 density blobs, then DAS (K1), the PSF;
    kspace_sim_3d on 48^3 and kspace_sim_1d against their device='cpu'
    runs with the free-field and reflection times; ray_paths_device on
    256^2 x 16384 rays against the host weights on every 64th ray; and
    global_average_c through phase 20's layered medium. Returns {name:
    value} for the record and the full-wave path's K1 launches."""
    from qups_tpu_torch.ops.rays import global_average_c, ray_paths, ray_paths_device
    from qups_tpu_torch.sim.fdtd import kspace_sim_1d, kspace_sim_2d, kspace_sim_3d
    from qups_tpu_torch.system import _cmap_zx

    das_cuda = ops.das_cuda
    out = {}
    # the bench_fdtd cell, as benches.py builds it
    n, c0, h = 225, 1500.0, 0.2e-3
    dt = 0.3 * h / c0
    steps = 400
    t = np.arange(steps) * dt
    sig = (np.sin(2 * np.pi * 2e6 * t)
           * np.exp(-((t - 1e-6) / 0.5e-6) ** 2))[:, None].astype(np.float32)
    cmap = np.full((n, n), c0, np.float32)
    rmap = np.full((n, n), 1000.0, np.float32)
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=c0, record_rows=(n - 20,))
    run = lambda **k: kspace_sim_2d(cmap, rmap, [20], [n // 2], sig, **kw, **k)  # noqa: E731
    rec = run()
    assert rec.is_cuda and rec.shape == (steps, 1, n)
    ms = _ms(run, reps=2, warm=False)
    ref, s_cpu = _sync_s(torch, lambda: run(device="cpu"))
    # float32 rounding gathers over the 400 steps (the steppers lie ~1e-4 of
    # the peak from a float64 run of the scheme on 64^2 grids and 48 steps,
    # tests/test_torch_fdtd.py), and the record's largest values lie in the
    # PML columns at the window's end; the first card runs read 5.4e-4 from
    # the CPU's (5.7e-4 outside the PML)
    r = _near_cpu(torch, rec, ref, "bench_fdtd cell record", "phase22", tol=1e-3)
    inner = slice(10, n - 10)
    r_in = _near_cpu(torch, rec[..., inner], ref[..., inner],
                     "bench_fdtd cell record, columns outside the PML", "phase22", tol=1e-3)
    k_step, busy = _kernel_steps(torch, lambda: kspace_sim_2d(
        cmap, rmap, [20], [n // 2], sig[:50], **dict(kw, steps=50)), 50)
    out["fdtd"] = dict(ms_step=ms / steps, kernels_step=k_step, busy_ms_step=busy, cpu_rel=r,
                       cpu_rel_inner=r_in)
    print(f"phase22 bench_fdtd cell ({n}^2, {steps} steps), kspace_sim_2d on the card: "
          f"{ms / steps:.4f} ms a step (CUDA events over the call, 2 runs); torch.profiler over "
          f"50 steps: {k_step} kernels and copies a step, device busy "
          + (f"{busy:.4f} ms a step ({100 * busy / (ms / steps):.1f} % of the step)"
             if busy is not None else "not measured")
          + f"; the CPU run of the call {s_cpu:.3f} s")

    # full wave on the demo system, default grid, nearest projection
    us, targets, _ = _demo_system(qt)
    med = _blob_medium(qt, targets, us.lmbda)
    cgrd = us._eikonal_grid()
    das_cuda.LAUNCHES = 0
    chd, t_fw = _sync_s(torch, lambda: us.kspaceFirstOrder(med))
    b, t_das = _sync_s(torch, lambda: us.DAS(chd))
    k1 = das_cuda.LAUNCHES
    npml = 10
    nodes = (cgrd.nz + 2 * npml) * (cgrd.nx + 2 * npml)
    fs = float(us.fs)
    k = max(1, int(np.ceil(1.0 / (fs * 0.3 * float(cgrd.dz) / 1540.0))))
    dtf = 1.0 / (fs * k)
    diag = np.hypot(cgrd.x[-1] - cgrd.x[0], cgrd.z[-1] - cgrd.z[0])
    wv = us.tx.impulse.conv(us.seq.pulse, 1.0 / dtf)
    fsteps = int(np.ceil((2.2 * diag / 1540.0 + wv.duration) / dtf))
    M = us.seq.num_pulse
    out["fullwave"] = dict(wall_s=t_fw, grid=(cgrd.nz + 2 * npml, cgrd.nx + 2 * npml),
                           dt_ns=dtf * 1e9, steps=fsteps, ms_step=t_fw * 1e3 / fsteps,
                           node_steps_per_s=nodes * fsteps * M / t_fw, das_s=t_das)
    print(f"phase22 full wave, demo system (5 PW, 20 density blobs of radius lambda/2), "
          f"us.kspaceFirstOrder(med), no device=: grid {cgrd.nz + 2 * npml} x "
          f"{cgrd.nx + 2 * npml} nodes (PML included) at {float(cgrd.dz) * 1e3:.4f} mm, dt "
          f"{dtf * 1e9:.3f} ns, {fsteps} steps, {M} transmits in one batch: wall {t_fw:.3f} s "
          f"(host clock, first call), {t_fw * 1e3 / fsteps:.4f} ms a step of the batch, "
          f"{nodes * fsteps * M / t_fw:.4e} node-steps/s; traces {tuple(chd.data.shape)} on "
          f"{chd.data.device}; DAS {t_das:.3f} s; K1 launches {k1}")
    assert chd.data.is_cuda and bool(torch.isfinite(chd.data).all()) and k1 >= 1
    _psf(us, b, targets, "kspaceFirstOrder -> DAS (K1)", "phase22")
    # the transmits in one batch against one stepper a transmit, on the
    # demo's grid and time step with 128 sources, 200 steps
    nz, nx = out["fullwave"]["grid"]
    gmap = np.full((nz, nx), 1540.0, np.float32)
    g = torch.Generator(device="cuda").manual_seed(2)
    sg = torch.randn((200, M, 128), generator=g, device="cuda")
    rows, cols = [npml] * 128, np.linspace(npml, nx - npml - 1, 128).astype(int)
    kwb = dict(steps=200, dt=dtf, dx=float(cgrd.dz), c_ref=1540.0, record_rows=(npml,))
    batch = lambda: kspace_sim_2d(gmap, gmap * 0 + 1000.0, rows, cols, sg, **kwb)  # noqa: E731
    recb = batch()
    ms_b = _ms(batch, reps=1, warm=False)
    singles = [kspace_sim_2d(gmap, gmap * 0 + 1000.0, rows, cols, sg[:, v], **kwb)
               for v in range(M)]
    ms_s = _ms(lambda: [kspace_sim_2d(gmap, gmap * 0 + 1000.0, rows, cols, sg[:, v], **kwb)
                        for v in range(M)], reps=1, warm=False)
    r_b = max(float((recb[:, v] - singles[v]).abs().max() / singles[v].abs().max())
              for v in range(M))
    kb_step, busy_b = _kernel_steps(torch, lambda: kspace_sim_2d(
        gmap, gmap * 0 + 1000.0, rows, cols, sg[:20], **dict(kwb, steps=20)), 20)
    out["fullwave"].update(batch_ms_step=ms_b / 200, single_ms_step=ms_s / 200,
                           batch_rel=r_b, kernels_step=kb_step, busy_ms_step=busy_b)
    print(f"phase22 the demo grid's {M} transmits as one batch {ms_b / 200:.4f} ms a step, "
          f"as {M} steppers {ms_s / 200:.4f} ms a step of all {M} (CUDA events, 200 steps); "
          f"batch vs single runs {r_b:.3e} of the peak (limit 1e-4); the batch: {kb_step} "
          "kernels and copies a step, device busy "
          + (f"{busy_b:.4f} ms a step" if busy_b is not None else "not measured"))
    assert r_b < 1e-4, r_b

    # small parity runs: 3-D and 1-D against their CPU runs, with physics
    N3, h3, fc3 = 48, 0.4e-3, 1.5e6
    dt3 = 0.3 * h3 / c0
    t3 = np.arange(140) * dt3
    s3 = (np.exp(-((t3 - 1.2e-6) * fc3 * 2) ** 2)
          * np.sin(2 * np.pi * fc3 * t3))[:, None].astype(np.float32)
    kw3 = dict(steps=140, dt=dt3, dx=h3, c_ref=c0, record_rows=(28, 40))
    cube = np.full((N3,) * 3, c0)
    src3 = np.array([[10], [24], [24]])
    rec3, s_gpu = _sync_s(torch, lambda: kspace_sim_3d(cube, cube * 0 + 1000.0, src3, s3, **kw3))
    ref3 = kspace_sim_3d(cube, cube * 0 + 1000.0, src3, s3, device="cpu", **kw3)
    # the first card runs: 3-D 1.1e-5, 1-D 3.4e-5 of the peak from the CPU's
    out["sim3d_rel"] = _near_cpu(torch, rec3, ref3, "kspace_sim_3d 48^3, 140 steps", "phase22",
                                 tol=1e-4)
    tr = rec3[:, :, 24, 24].abs().cpu().numpy()
    d3 = t3[tr[:, 1].argmax()] - t3[tr[:, 0].argmax()]
    assert abs(d3 - 12 * h3 / c0) < 4 * dt3, d3
    rho1 = np.full(512, 1000.0)
    rho1[300:] = 3000.0
    t1 = np.arange(1900) * (0.3 * h / c0)
    s1 = (np.exp(-((t1 - 1e-6) * 2e6 * 2) ** 2)
          * np.sin(2 * np.pi * 2e6 * t1))[:, None].astype(np.float32)
    kw1 = dict(steps=1900, dt=0.3 * h / c0, dx=h, c_ref=c0, record_rows=(60, 240))
    rec1, s1_gpu = _sync_s(torch, lambda: kspace_sim_1d(np.full(512, c0), rho1, [40], s1, **kw1))
    ref1 = kspace_sim_1d(np.full(512, c0), rho1, [40], s1, device="cpu", **kw1)
    out["sim1d_rel"] = _near_cpu(torch, rec1, ref1, "kspace_sim_1d 512, 1900 steps", "phase22",
                                 tol=1e-4)
    e1 = rec1[:, 0].abs().cpu().numpy()
    sel = t1 > 0.7 * ((260 + 240) * h / c0 + 1e-6)
    t_echo = t1[sel][e1[sel].argmax()]
    assert abs(t_echo - ((260 + 240) * h / c0 + 1e-6)) < 6 * 0.3 * h / c0, t_echo
    print(f"phase22 kspace_sim_3d 48^3 x 140 steps {s_gpu:.3f} s, differential arrival "
          f"{d3 * 1e6:.4f} us (12 cells: {12 * h3 / c0 * 1e6:.4f}); kspace_sim_1d 512 x 1900 "
          f"steps {s1_gpu:.3f} s, echo off the impedance step at {t_echo * 1e6:.4f} us")

    # rays: two facing 128-element lines across a 256^2 grid
    xg = np.linspace(-20e-3, 20e-3, 256)
    zg = np.linspace(0.0, 40e-3, 256)
    line = np.linspace(-19e-3, 19e-3, 128)
    pa = np.stack([np.repeat(line, 128), np.full(128 * 128, 0.5e-3)])
    pb = np.stack([np.tile(line, 128), np.full(128 * 128, 39.5e-3)])
    W = ray_paths_device(xg, zg, pa, pb)
    ms_rays = _ms(lambda: ray_paths_device(xg, zg, pa, pb), reps=2)
    sub = np.arange(0, pa.shape[1], 64)
    Wh = ray_paths(xg, zg, pa[:, sub], pb[:, sub])
    r_rays = float(np.abs(W[:, :, sub].cpu().numpy() - Wh).max() / np.abs(Wh).max())
    L = np.hypot(*(pb - pa))
    r_len = float(np.abs(W.sum((0, 1)).double().cpu().numpy() - L).max() / L.max())
    out["rays"] = dict(ms=ms_rays, rel=r_rays, len_rel=r_len, gb=W.numel() * 4 / 1e9)
    print(f"phase22 ray_paths_device 256^2 x {pa.shape[1]} rays ({W.numel() * 4 / 1e9:.2f} GB "
          f"float32) on the card: {ms_rays:.3f} ms (CUDA events, 2 runs); every 64th ray vs the "
          f"host's float64 weights: {r_rays:.3e} of the largest weight (limit 1e-5); each ray's "
          f"total vs its length: {r_len:.3e} relative")
    assert W.is_cuda and r_rays < 1e-5 and r_len < 1e-5, (r_rays, r_len)
    del W

    # global_average_c through phase 20's layered medium
    us20, _, _ = _main_system(qt)
    lens = qt.Medium(c0=1540.0, pertreg=((lambda P: P[2] < 5e-3, {"c": 1300.0}),))
    g20 = us20._eikonal_grid()
    cz = _cmap_zx(g20, lens.props(g20, "c"))
    ends = np.array([[0.0, 5e-3, -10e-3], [28e-3, 28e-3, 40e-3]])  # (x, z) of three targets
    cavg = global_average_c(cz, g20.x, g20.z, np.array([0.0, 0.0]), ends)
    f_lay = 5e-3 / ends[1]
    want = 1.0 / (f_lay / 1300.0 + (1 - f_lay) / 1540.0)
    print(f"phase22 global_average_c through phase 20's layer: {np.round(cavg, 3)} m/s, "
          f"straight-ray values {np.round(want, 3)} m/s")
    assert np.all(np.abs(cavg - want) < 0.01 * want), (cavg, want)
    return out, k1


def _records(rows):
    """A list of dicts as a Verasonics struct array (a numpy record array of
    object fields, as savemat writes a struct array)."""
    names = list(rows[0])
    a = np.zeros((len(rows),), dtype=[(n, "O") for n in names])
    for i, r in enumerate(rows):
        a[i] = tuple(r[n] for n in names)
    return a


def _picmus_trans(rng):
    """PICMUS's probe as a Vantage 'Trans' struct: an L11-4v, 128 elements at
    0.3 mm pitch, 0.27 mm wide, 5 mm tall, 5.208 MHz; ConnectorES a fixed
    permutation from the seed, so the channel map is exercised."""
    return dict(name="L11-4v", units="mm", frequency=5.208, numelements=128,
                elementWidth=0.27, elementLength=5.0, spacingMm=0.3,
                Bandwidth=np.array([3.5, 7.0]), type=0, ElementPos=np.zeros((128, 5)),
                elevationFocusMm=20.0, ConnectorES=rng.permutation(128) + 1)


def kernels_under(trace_file, annotation, kernel):
    """The CUDA kernel events of a Chrome trace (``utils.trace``) whose name
    holds ``kernel`` and that ran under the CPU annotation ``annotation``:
    the kernel's launch call (runtime or driver API, matched by correlation
    id) lies inside the annotation's span, or the kernel lies inside the
    annotation's span on the device (``gpu_user_annotation``). Returns
    (those events, every kernel event, the categories seen)."""
    ev = json.load(open(trace_file))["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in ev
             if e.get("name") == annotation and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    gspans = [(e["ts"], e["ts"] + e["dur"]) for e in ev
              if e.get("name") == annotation and e.get("cat") == "gpu_user_annotation"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kerns = [e for e in ev if e.get("cat") == "kernel"]

    def inside(t, sp):
        return any(a <= t <= b for a, b in sp)

    hits = [e for e in kerns if kernel in e["name"] and (
        inside(launch_ts.get(e.get("args", {}).get("correlation"), -1.0), spans)
        or inside(e["ts"], gspans))]
    return hits, kerns, sorted({str(e.get("cat")) for e in ev})


def _same_fields(a, b, where):
    """Two obj2dict dicts equal, field by field (None entries, the dropped
    waveform functions, aside)."""
    if isinstance(a, dict):
        a = {k: v for k, v in a.items() if v is not None}
        b = {k: v for k, v in b.items() if v is not None}
        assert a.keys() == b.keys(), (where, a.keys(), b.keys())
        for k in a:
            _same_fields(a[k], b[k], f"{where}.{k}")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), where


def phase23(torch, qt, ops, errs):
    """The Vantage import path at PICMUS's widths, on the card, under the
    port's profiler: PICMUS's plane-wave acquisition (an L11-4v, 128
    elements, 75 plane waves over +-16 degrees, RF at fs = 4 fc = 20.832
    MHz) of 5 point targets at 12-44 mm, 4 frames (0.3 mm deeper each),
    simulated with us.greens (K3), quantized to int16 and written with
    scipy's savemat in the Vantage layout (RcvData rows of 75 acquisitions
    back to back, each rounded to 128-sample blocks, x 128 channels through
    a permuted ConnectorES x 4 frames; Receive, TX with the Vantage delays,
    Trans); read back with interop.load_verasonics; the traces' t0 from the
    acquisition's start plus out['t0'] (held to the known offset); uploaded;
    us.DAS on K1(b) (4 real frames, cubic) and, after hilbert and downmix on
    the card, us.DAS(iq, fmod=fc), 512^2 px over x +-18 mm, z 10-50 mm;
    launch counts zeroed just before the path and read just after. Checks:
    the imported traces equal the int16 samples written, after the map, bit
    for bit; each frame's PSF (RF and IQ) within 1.1 mm; each image within
    1e-4 x max of the plain version on every 64th pixel; save_chd/load_chd
    of the IQ, then DAS again, bit for bit; save_checkpoint/
    load_checkpoint(like=) of the card images, back on the card bit for bit;
    save_mat/load_mat of xdc, seq and scan, equal fields; the IQ DAS inside
    utils.trace with annotate('das') records das_frames_kernel under the
    annotation. Host seconds (utils.Timer) for savemat, load_verasonics and
    the channel map; the upload; DAS ms (CUDA events, mean of 3 after a
    warm-up). Returns the launches and the phase's record."""
    import tempfile

    from scipy.io import savemat

    from qups_tpu_torch import interop, io as qio
    from qups_tpu_torch.utils import Timer, annotate, trace

    das_cuda = ops.das_cuda
    t_phase = time.perf_counter()
    rng = np.random.default_rng(23)
    c0, fc, F = 1540.0, 5.208e6, 4
    Trans = _picmus_trans(rng)
    xdc = interop.transducer_from_verasonics(Trans, c0)
    angs = np.linspace(-16.0, 16.0, 75)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.SequenceRadial(type="PW", angles=angs, c0=c0),
        scan=qt.ScanCartesian(x=np.linspace(-18e-3, 18e-3, 512),
                              z=np.linspace(10e-3, 50e-3, 512)), fs=4 * fc)
    base = np.array([[-8e-3, 0.0, 12e-3], [6e-3, 0.0, 20e-3], [0.0, 0.0, 28e-3],
                     [-5e-3, 0.0, 36e-3], [9e-3, 0.0, 44e-3]]).T
    silent = np.array([[0.0, 0.0], [0.0, 0.0], [6e-3, 47e-3]])
    targets = [base + np.array([[0.0], [0.0], [0.3e-3 * f]]) for f in range(F)]
    chds = [us.greens(qt.Scatterers(pos=np.concatenate([t, silent], 1),
                                    amp=np.r_[np.ones(5), 0.0, 0.0], c0=c0)) for t in targets]
    assert len({(c.T, float(c.t0_host[0])) for c in chds}) == 1
    rf = torch.stack([c.data.real for c in chds], -1)  # (T, N, M, F) on the card
    q16 = torch.round(rf / rf.abs().max() * 16000).to(torch.int16).cpu().numpy()
    del rf
    N, M = xdc.numel, len(angs)
    Tv = -(-q16.shape[0] // 128) * 128  # whole 128-sample blocks, as the Vantage
    q16 = np.concatenate([q16, np.zeros((Tv - q16.shape[0],) + q16.shape[1:], np.int16)])
    k = Trans["ConnectorES"] - 1
    rcv = np.zeros((Tv * M, N, F), np.int16)
    for a in range(M):
        rcv[a * Tv:(a + 1) * Tv, k] = q16[:, :, a]
    tau = us.seq.delays(xdc)  # (N, M), the sequence's delays
    off = -tau.max(axis=0)    # the sequence's time of the Vantage delays' zero
    start = float(chds[0].t0_host[0]) - off  # each acquisition's start, Vantage clock
    rx_rows = [dict(bufnum=1, framenum=f + 1, acqNum=a + 1, startSample=a * Tv + 1,
                    endSample=(a + 1) * Tv, decimSampleRate=4 * 5.208, demodFrequency=5.208,
                    sampleMode="NS200BW", startDepth=start[a] * fc / 2, Apod=np.ones(N))
               for f in range(F) for a in range(M)]
    TX = _records([dict(Apod=np.ones(N), Steer=np.array([np.radians(a), 0.0]), focus=0.0,
                        Origin=np.zeros(3), Delay=(tau[:, m].max() - tau[:, m]) * fc)
                   for m, a in enumerate(angs)])
    ws = dict(Trans=Trans, Receive=_records(rx_rows), TX=TX, RcvData=np.empty((1,), object),
              Resource=dict(Parameters=dict(speedOfSound=c0)))
    ws["RcvData"][0] = rcv
    tm = Timer()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vantage_pw75.mat")
        with tm("savemat"):
            savemat(path, ws, long_field_names=True)
        with tm("load_verasonics"):
            out = interop.load_verasonics(path)
        with tm("channel map"):  # the same import on the structs in memory
            interop.channel_data_from_verasonics([rcv], rx_rows, Trans)
        mat_bytes = os.path.getsize(path)
    chd = out["chd"][0]
    assert chd.data.device.type == "cpu" and chd.data.shape == (Tv, N, M, F), chd.data.shape
    assert torch.equal(chd.data, torch.from_numpy(q16.astype(np.float32))), \
        "imported traces differ from the int16 samples written"
    assert out["seq"].type == "PW" and np.isclose(out["fmod"][0], fc) \
        and out["smode"] == ["NS200BW"]
    assert np.allclose(out["t0"], off, rtol=0, atol=1e-12), np.abs(out["t0"] - off).max()
    chd = chd.replace(t0=(start + out["t0"]).reshape(1, 1, M))
    assert np.allclose(chd.t0_host, chds[0].t0_host[0], rtol=0, atol=1e-12)
    del chds, rcv, ws
    # the loaded geometry is the simulated one
    np.testing.assert_array_equal(out["xdc"].positions(), xdc.positions())
    assert np.allclose(out["seq"].focus_array, us.seq.focus_array, rtol=0, atol=1e-12)
    with tm("upload"):
        g = chd.replace(data=chd.data.to("cuda"))
        torch.cuda.synchronize()

    das_cuda.LAUNCHES = das_cuda.LAYOUT_LAUNCHES = 0
    t = time.perf_counter()
    b_rf = us.DAS(g)
    iq = g.hilbert().downmix(fc)
    b_iq = us.DAS(iq, fmod=fc)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t
    launches = {"das_k1b": das_cuda.LAUNCHES, "das_layout": das_cuda.LAYOUT_LAUNCHES}
    print(f"phase23 Vantage import path (PICMUS PW75: 128 el, 75 PW +-16 deg, fs "
          f"{us.fs / 1e6:.3f} MHz, {F} frames): .mat {mat_bytes / 1e6:.3f} MB, traces "
          f"{q16.nbytes / 1e6:.3f} MB int16 ({Tv} samples an acquisition) -> "
          f"{g.data.numel() * 4 / 1e6:.3f} MB float32; savemat {tm.times['savemat']:.3f} s, "
          f"load_verasonics {tm.times['load_verasonics']:.3f} s, channel map "
          f"{tm.times['channel map']:.3f} s (host clock); upload "
          f"{tm.times['upload'] * 1e3:.3f} ms; DAS RF, hilbert, downmix, DAS IQ on "
          f"{torch.cuda.get_device_name(0)}: {t_path:.3f} s (first call); launches {launches}")
    n, nl = _frames_launches(das_cuda, F, "cubic", True)  # IQ
    nrf, lrf = _frames_launches(das_cuda, F, "cubic", False,  # RF: PICMUS's tap stride
                                das_cuda.tap_stride(us._pixels(), 1 / c0, g.fs))
    assert launches == {"das_k1b": nrf + n, "das_layout": lrf + nl}, launches
    assert g.data.is_cuda and iq.data.is_cuda and iq.data.is_complex()
    for name, b, dt in (("RF", b_rf, torch.float32), ("IQ", b_iq, torch.complex64)):
        assert b.is_cuda and b.dtype == dt and b.shape == tuple(us.scan.shape) + (1, 1, F), \
            (name, b.shape, b.dtype)
        assert bool(torch.isfinite(b).all()), name
        for f in range(F):
            _psf(us, b[..., f], targets[f], f"{name} frame {f}", "phase23")
    # the plain version on every 64th pixel
    pv, nv, model = us._tx_geometry()
    sub = np.arange(0, us.scan.npix, 64)
    ms = {}
    for name, b, x, fm in (("RF", b_rf, g, 0.0), ("IQ", b_iq, iq, fc)):
        ref = das_cuda.das_sum_plain(x.data, us._pixels()[sub], us.rx.positions().T, pv, nv,
                                     x.t0, np.reciprocal(np.float32(c0)), fs=float(x.fs),
                                     tx_model=model, method="cubic", fmod=fm)
        got = b.reshape(us.scan.npix, F)[torch.as_tensor(sub, device="cuda")]
        a, r = errs["das_k1b"].add(got, ref.reshape(got.shape), f"phase23 {name} DAS")
        assert r < TOL, (name, r)
        ms[name] = _ms(lambda: us.DAS(x, fmod=fm))
        print(f"phase23 DAS {name} on K1(b) vs plain on every 64th pixel: max_abs_err={a:.3e} "
              f"rel={r:.3e}; {ms[name]:.3f} ms (CUDA events, mean of 3 after a warm-up), "
              f"{us.scan.npix * N * M * F / (ms[name] / 1e3):.4e} sums/s")
    # round trips on the card
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "iq.npz")
        with tm("save_chd"):
            qio.save_chd(p, iq)
        with tm("load_chd"):
            back = qio.load_chd(p, device="cuda")
            torch.cuda.synchronize()
        npz_bytes = os.path.getsize(p)
        assert back.data.is_cuda and torch.equal(back.data, iq.data)
        np.testing.assert_array_equal(back.t0_host, iq.t0_host)
        assert torch.equal(us.DAS(back, fmod=fc), b_iq), "DAS of the reloaded IQ differs"
        p = os.path.join(tmp, "images.pt")
        qio.save_checkpoint(p, {"rf": b_rf, "iq": b_iq, "fs": np.float64(us.fs)})
        ck = qio.load_checkpoint(p, like={"rf": b_rf, "iq": b_iq})
        assert ck["rf"].is_cuda and ck["iq"].is_cuda and isinstance(ck["fs"], np.float64)
        assert torch.equal(ck["rf"], b_rf) and torch.equal(ck["iq"], b_iq)
        p = os.path.join(tmp, "geometry.mat")
        interop.save_mat(p, xdc=us.rx, seq=us.seq, scan=us.scan)
        mat = interop.load_mat(p)
        for k, v in (("xdc", us.rx), ("seq", us.seq), ("scan", us.scan)):
            assert type(mat[k]) is type(v), k
            _same_fields(qio.obj2dict(mat[k]), qio.obj2dict(v), k)
        # the profiler's trace: K1(b) under the annotation (the IQ call's
        # frames: das_frames_kernel's rotating variant; the RF call's run
        # das_kernel, one frame a launch at PICMUS's tap stride)
        logdir = os.path.join(tmp, "trace")
        with trace(logdir):
            with annotate("das"):
                us.DAS(iq, fmod=fc)
        tfile = os.path.join(logdir, "trace.json")
        hits, kerns, cats = kernels_under(tfile, "das", "das_frames_kernel")
        trace_bytes = os.path.getsize(tfile)
    print(f"phase23 round trips on the card, bit for bit: save_chd {tm.times['save_chd']:.3f} s "
          f"/ load_chd {tm.times['load_chd']:.3f} s of the IQ ({npz_bytes / 1e6:.3f} MB .npz), "
          f"then DAS again: the same image; save_checkpoint / load_checkpoint(like=) of the "
          f"two images: on the card; save_mat / load_mat of xdc, seq, scan: equal fields")
    print(f"phase23 trace (utils.trace + annotate('das')): {trace_bytes / 1e6:.3f} MB Chrome "
          f"trace, {len(kerns)} kernel events, {len(hits)} das_frames_kernel under 'das'; "
          f"categories {cats}")
    assert hits, ("no das_frames_kernel event under the annotation", cats,
                  sorted({e["name"][:60] for e in kerns}))
    rec = dict(mat_MB=mat_bytes / 1e6, traces_int16_MB=q16.nbytes / 1e6,
               traces_f32_MB=g.data.numel() * 4 / 1e6, samples=Tv,
               savemat_s=tm.times["savemat"], load_verasonics_s=tm.times["load_verasonics"],
               channel_map_s=tm.times["channel map"], upload_ms=tm.times["upload"] * 1e3,
               das_rf_ms=ms["RF"], das_iq_ms=ms["IQ"], trace_MB=trace_bytes / 1e6,
               save_chd_s=tm.times["save_chd"], load_chd_s=tm.times["load_chd"],
               npz_MB=npz_bytes / 1e6, phase_s=time.perf_counter() - t_phase)
    print("phase23 record: " + json.dumps(rec))
    return launches, rec


def _k3_bytes(F, directivity, S=100_000, N=128, M=128):
    """K3's bytes read or written once: q and w of both sides (and the
    directivity slopes), and G (F, N, M) complex64."""
    return 4.0 * S * (N + M) * (3 if directivity else 2) + 8.0 * F * N * M


# several devices from one process (slice 13): the port's mesh on one card
def _path_counts(ops):
    """The launch counts the mesh and bench paths move, by the kernels
    line's names (K3: its float32 variant, the K3 row)."""
    dc, gc = ops.das_cuda, ops.greens_cuda
    return {"das_k1": dc.LAUNCHES, "das_k1e": dc.PREC_LAUNCHES, "das_k1c": dc.KEEP_LAUNCHES,
            "das_layout": dc.LAYOUT_LAUNCHES, "das_lut_k2": dc.LUT_LAUNCHES,
            "greens_freq_k3": ops.greens_freq_cuda.VARIANT_LAUNCHES["a"],
            "greens_freq_k3b": ops.greens_freq_cuda.VARIANT_LAUNCHES["b"],
            "greens_freq_k3c": ops.greens_freq_cuda.VARIANT_LAUNCHES["c"],
            "fdbf_adjoint_k4": ops.fdbf_cuda.LAUNCHES, "greens_splat_k5": gc.LAUNCHES,
            "greens_finish": gc.FINISH_LAUNCHES}


def _counted(torch, ops, fn):
    """Run ``fn`` once with every launch count set to 0 just before and read
    just after: (result, the counts that moved, host seconds, synchronised)."""
    dc, gc, gfc = ops.das_cuda, ops.greens_cuda, ops.greens_freq_cuda
    dc.LAUNCHES = dc.PREC_LAUNCHES = dc.KEEP_LAUNCHES = dc.APOD_LAUNCHES = 0
    dc.LAYOUT_LAUNCHES = dc.LUT_LAUNCHES = dc.LUT_KEEP_LAUNCHES = dc.LUT_PREC_LAUNCHES = 0
    gfc.LAUNCHES = ops.fdbf_cuda.LAUNCHES = gc.LAUNCHES = gc.FINISH_LAUNCHES = 0
    for v in gfc.VARIANT_LAUNCHES:
        gfc.VARIANT_LAUNCHES[v] = 0
    out, s = _sync_s(torch, fn)
    return out, {k: v for k, v in _path_counts(ops).items() if v}, s


def _vs(got, ref, where):
    """(max abs error, relative error) of a sharded result against the
    single-device one."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, (where, got.shape, ref.shape)
    a = float((got - ref).abs().max())
    return a, a / float(ref.abs().max())


def _slsc_check(torch, got, ref, kr, brx, tol, slsc):
    """slsc scales each kept sample to unit magnitude, so a sample within
    rounding of 0 takes its sign from the rounding: the shards sum their
    transmits in halves, the single call in one pass. Hold the in-mesh
    reduction to ops/coherence.py's slsc of the same kept samples (the
    sharded keep_rx image) within ``tol``, and to the single-device two
    steps within ``tol`` at every pixel none of whose samples lies within 4x
    the kept images' largest difference of 0 (those pixels < 1 %)."""
    same = slsc(kr, axis=1)
    r_same = float((got - same).abs().max() / same.abs().max())
    eps = 4 * float((kr - brx).abs().max())
    excused = (brx.abs() < eps).any(1)
    off = (got - ref).abs() >= tol * float(ref.abs().max())
    share = float(excused.float().mean())
    r_live = float((got - ref)[~excused].abs().max() / ref.abs().max())
    print(f"phase24 post slsc vs slsc of the sharded keep_rx samples: rel={r_same:.3e} (limit "
          f"{tol:.0e}); vs the single call where no sample lies within {eps:.3e} of 0 "
          f"({100 * (1 - share):.3f} % of pixels): rel={r_live:.3e}; pixels off "
          f"{int(off.sum())}, all excused: {not bool((off & ~excused).any())}")
    assert r_same < tol and r_live < tol and not bool((off & ~excused).any()) and share < 0.01


def _tax(what, ms, ms_one, counts, rec):
    """Print and record one sharded call beside its single-device call."""
    rec[what] = dict(ms=ms, single_ms=ms_one, tax=ms / ms_one, launches=counts)
    print(f"phase24 {what}: sharded {ms:.3f} ms, one device {ms_one:.3f} ms, sharding tax "
          f"{ms / ms_one:.3f}x; launches {counts}")


def phase24(torch, qt, ops):
    """Several devices from one process: the port's mesh (parallel/mesh.py)
    on four shards of the one card, mesh4 = make_mesh([cuda:0] * 4, axes=
    ('rx', 'tx'), shape=(2, 2)), and make_mesh() (every card, one here). The
    main path at the headline, 1024^2 px x 256 tx x 256 rx, T 4096, cubic:
    das_sharded_pallas summed (K1), bf16pair (K1(e)), post='cohfac' and
    'slsc' (K1(c), 64 lags) and us.coherence_image(mesh=mesh4), each
    against the single-device call on the card; das_lut_sharded_pallas on
    the headline tables (K2); us.greens(mesh=mesh4, impl='freq') at phase
    10's speckle size (K3); bf_adjoint_sharded at phase 8's adjoint headline
    (K4); kspaceFirstOrder(mesh=) on a bench_fdtd-size grid against the
    loop; refocus_sharded, focus_tx_freq_sharded and migration_sharded on
    phase 21's shapes; and the cheat sheet as `python -m
    qups_tpu_torch.examples.cheat_sheet`. Each sharded call's launches
    counted (zeroed just before, read just after); each timed beside its
    single-device call (CUDA events, 2 runs after the counted one).
    The comparisons are sharded against single-device calls, not kernels
    against their plain versions, so they stay out of the kernels line's
    errors. Returns (launches by kernel, the record)."""
    from qups_tpu_torch import bench
    from qups_tpu_torch.ops import fdbf
    from qups_tpu_torch.ops.coherence import cohfac, slsc
    from qups_tpu_torch.ops.das import delay_tables
    from qups_tpu_torch.parallel import (bf_adjoint_sharded, das_lut_sharded_pallas,
                                         das_sharded_pallas, focus_tx_freq_sharded,
                                         make_mesh, migration_sharded, refocus_sharded)

    das_cuda, fdbf_cuda = ops.das_cuda, ops.fdbf_cuda
    t_phase = time.perf_counter()
    rec, launches = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    dev0 = torch.device("cuda", 0)
    mesh4 = make_mesh([dev0] * 4, axes=("rx", "tx"), shape=(2, 2))
    mesh1 = make_mesh(axes=("rx", "tx"))
    assert mesh1.size == torch.cuda.device_count()
    n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
    x, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
    xg = torch.as_tensor(x).cuda()
    del x
    pig = torch.as_tensor(pi).cuda()
    cinv = np.float32(1 / 1540.0)
    kw = dict(fs=fs, tx_model="plane", method="cubic")

    def one(**k):
        return das_cuda.das_sum(xg, pig, pr, pv, nv, t0, cinv, **kw, **k)

    def sharded(mesh, **k):
        return das_sharded_pallas(mesh, xg, pig, pr, pv, nv, t0, cinv, im_shape=(n, n, 1),
                                  **kw, **k)

    def two_step(post):
        brx = one(keep_rx=True)[:, :, 0]
        return cohfac(brx, axis=1).abs() if post == "cohfac" else slsc(brx, axis=1)

    torch.cuda.reset_peak_memory_stats()
    ref = one()
    got1 = sharded(mesh1)
    print(f"phase24 make_mesh() on this machine: {mesh1.shape}, devices "
          f"{[str(d) for d in mesh1.devices.flat]}; summed headline equal to the "
          f"single-device call bit for bit: {bool(torch.equal(got1, ref))}")
    assert mesh1.size > 1 or torch.equal(got1, ref)
    del got1
    cases = {  # what: (sharded call, single-device call, kernel, limit)
        "summed f32 (K1)": (lambda: sharded(mesh4), one, "das_k1", TOL),
        "bf16pair (K1(e))": (lambda: sharded(mesh4, precision="bf16pair"),
                             lambda: one(precision="bf16pair"), "das_k1e", TOL),
        "post cohfac (K1(c))": (lambda: sharded(mesh4, post="cohfac"),
                                lambda: two_step("cohfac"), "das_k1c", TOL),
        "post slsc, 64 lags (K1(c))": (lambda: sharded(mesh4, post="slsc"),
                                       lambda: two_step("slsc"), "das_k1c", 1e-3),
    }
    for what, (fn, fn1, kern, tol) in cases.items():
        got, counts, _ = _counted(torch, ops, fn)
        assert counts.get(kern) == 4 and counts.get("das_layout") == 4, (what, counts)
        add(counts)
        ref = fn1()
        a, r = _vs(got, ref, f"phase24 {what} on mesh4 vs one device")
        print(f"phase24 {what} on mesh4 vs the single-device call: max_abs_err={a:.3e} "
              f"rel={r:.3e} (limit {tol:.0e})")
        if "slsc" in what:
            _slsc_check(torch, got, ref, sharded(mesh4, keep_rx=True)[:, :, 0],
                        one(keep_rx=True)[:, :, 0], tol, slsc)
        else:
            assert r < tol, (what, r)
        if kern == "das_k1e":  # the bf16pair band against float32
            f32 = one()
            r32 = float((got - f32).abs().max() / f32.abs().max())
            del f32
            print(f"phase24 bf16pair on mesh4 vs float32: rel={r32:.3e} (limit {BAND:.0e})")
            assert r32 < BAND
        del got, ref
        _tax(what, _ms(fn, reps=2, warm=False), _ms(fn1, reps=2), counts, rec)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase24 main path peak device memory: {rec['peak_gib']:.2f} GiB")

    # coherence_image(mesh=) on the headline as a system
    xdc = qt.TransducerArray(numel=N, pitch=24e-3 / (N - 1), fc=5e6)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.SequenceRadial(type="PW", angles=np.linspace(-9, 9, M),
                                              c0=1540.0),
        scan=qt.ScanCartesian(x=np.linspace(-12e-3, 12e-3, n), z=np.linspace(5e-3, 45e-3, n)),
        fs=fs)
    chd = qt.ChannelData(data=xg, fs=fs, t0=float(t0[0]))
    fn = lambda: us.coherence_image(chd, mesh=mesh4)  # noqa: E731
    fn1 = lambda: us.coherence_image(chd)  # noqa: E731
    got, counts, _ = _counted(torch, ops, fn)
    assert counts.get("das_k1c") == 4, counts
    add(counts)
    ref = fn1()
    a, r = _vs(got, ref, "phase24 coherence_image(mesh=mesh4) vs no mesh")
    print(f"phase24 us.coherence_image(chd, mesh=mesh4) vs us.coherence_image(chd): "
          f"max_abs_err={a:.3e} rel={r:.3e}")
    assert got.shape == tuple(us.scan.shape) and r < TOL
    del got, ref
    _tax("coherence_image cohfac (K1(c))", _ms(fn, reps=2, warm=False), _ms(fn1, reps=2),
         counts, rec)

    # K2: the headline's plane-wave tables
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    kl = dict(fs=fs, method="cubic")
    fn = lambda: das_lut_sharded_pallas(mesh4, xg, tau_rx, tau_tx, t0, **kl)  # noqa: E731
    fn1 = lambda: das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kl)  # noqa: E731
    got, counts, _ = _counted(torch, ops, fn)
    assert counts.get("das_lut_k2") == 4, counts
    add(counts)
    a, r = _vs(got, fn1(), "phase24 das_lut_sharded_pallas vs one device")
    print(f"phase24 das_lut_sharded_pallas headline cubic vs das_lut_sum: max_abs_err={a:.3e} "
          f"rel={r:.3e}")
    assert r < TOL
    del got
    _tax("das_lut_sharded_pallas cubic (K2)", _ms(fn, reps=2, warm=False), _ms(fn1, reps=2),
         counts, rec)
    del tau_rx, tau_tx, xg, chd
    torch.cuda.empty_cache()

    # K3: us.greens(mesh=) at phase 10's speckle size
    us, _, _ = _main_system(qt)
    speck = _speckle(qt, 10_000, 10)
    fn = lambda: us.greens(speck, impl="freq", mesh=mesh4).data  # noqa: E731
    fn1 = lambda: us.greens(speck, impl="freq").data  # noqa: E731
    got, counts, _ = _counted(torch, ops, fn)
    assert counts.get("greens_freq_k3") == 4, counts
    add(counts)
    a, r = _vs(got, fn1(), "phase24 greens(mesh=mesh4) vs no mesh")
    print(f"phase24 us.greens(speckle 10^4, impl='freq', mesh=mesh4) vs without a mesh: "
          f"max_abs_err={a:.3e} rel={r:.3e}")
    assert r < TOL
    del got
    _tax("greens freq, 10^4 scatterers, 128 x 128 (K3)", _ms(fn, reps=2, warm=False),
         _ms(fn1, reps=2), counts, rec)

    # K4: phase 8's adjoint headline, pixels sharded, the spectra copied
    V = 256
    th = np.radians(np.linspace(-20, 20, V))
    del_tx = -(pr[:, 0:1] * np.sin(th)[None, :]) / 1540.0
    g = torch.Generator(device="cuda").manual_seed(8)
    xa = torch.randn((T, N, V), generator=g, device="cuda")
    taur = fdbf.geom_delays(pi, pr, np.float32(1 / 1540.0), "cuda")
    args = (xa, taur, taur, del_tx, np.ones((M, V)), t0[0], np.zeros(V),
            np.arange(1024 - 32, 1024 + 32))
    fn = lambda: bf_adjoint_sharded(mesh4, *args, fs=fs, precision="bf16")  # noqa: E731
    fn1 = lambda: fdbf_cuda.bf_adjoint_cuda(*args, fs=fs, precision="bf16")  # noqa: E731
    got, counts, _ = _counted(torch, ops, fn)
    assert counts.get("fdbf_adjoint_k4") == 4, counts
    add(counts)
    ref = fn1()
    bit = bool(torch.equal(got, ref))
    a, r = _vs(got, ref, "phase24 bf_adjoint_sharded vs one device")
    print(f"phase24 bf_adjoint_sharded bf16 headline vs bf_adjoint_cuda: bit for bit {bit}; "
          f"max_abs_err={a:.3e} rel={r:.3e} (limit {TOL_BF16:.0e})")
    assert r < TOL_BF16
    rec["k4_bit_equal"] = bit
    del got, ref
    _tax("bf_adjoint_sharded bf16, 64 bins (K4)", _ms(fn, reps=2, warm=False),
         _ms(fn1, reps=2), counts, rec)
    del xa, taur, args
    torch.cuda.empty_cache()

    # kspaceFirstOrder(mesh=) on a bench_fdtd-size grid (225^2 with the PML)
    us, targets, _ = _demo_system(qt)
    h = 0.2e-3
    cgrd = qt.ScanCartesian(x=(np.arange(205) - 102) * h, y=[0.0], z=np.arange(205) * h)
    med = _blob_medium(qt, targets, us.lmbda)
    mesh_tx = make_mesh([dev0] * 4, axes=("tx",))
    chd1, s_mesh = _sync_s(torch, lambda: us.kspaceFirstOrder(med, cgrd, tmax=30e-6,
                                                              mesh=mesh_tx))
    chd0, s_loop = _sync_s(torch, lambda: us.kspaceFirstOrder(med, cgrd, tmax=30e-6))
    r = float((chd1.data - chd0.data).abs().max() / chd0.data.abs().max())
    same_t0 = bool(np.array_equal(chd1.t0_host, chd0.t0_host))
    print(f"phase24 kspaceFirstOrder(mesh=[cuda:0] x 4 on 'tx') on a 225^2 grid, 5 PW, "
          f"30 us: {s_mesh:.3f} s (host clock, first call) vs the loop (one batch) "
          f"{s_loop:.3f} s; rel={r:.3e} (limit 1e-5), t0 equal {same_t0}")
    assert r < 1e-5 and same_t0
    rec["kspaceFirstOrder"] = dict(s=s_mesh, single_s=s_loop, rel=r)

    # phase 21's shapes: the bench_refocus cell (gamma 0) and bench_migration
    T, N, M = 4096, 256, 256
    H = _hadamard(M).astype(np.float32)
    tau = np.zeros((M, M), np.float32)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((T, N, M), generator=g, device="cuda")

    def ref_decode():
        Hi = fdbf.refocus_op(tau, H, T=T, fs=fs, gamma=0.0)
        return fdbf.refocus_apply(x, Hi, 0.0, fs=fs)[0]

    fn = lambda: refocus_sharded(mesh4, x, tau, H, 0.0, fs=fs, gamma=0.0)[0]  # noqa: E731
    for what, f, f1 in (("refocus_sharded, Hadamard 256, gamma 0", fn, ref_decode),
                        ("focus_tx_freq_sharded, 256 -> 256",
                         lambda: focus_tx_freq_sharded(mesh4, x, tau, H, fs=fs),
                         lambda: fdbf.focus_tx_freq(x, tau, H, fs=fs))):
        got, s = _sync_s(torch, f)
        ref = f1()
        r = float((got - ref).abs().max() / ref.abs().max())
        print(f"phase24 {what} (T 4096, N = 256) on mesh4 vs one device: rel={r:.3e}")
        assert r < TOL, (what, r)
        del got, ref
        _tax(what, _ms(f, reps=2), _ms(f1, reps=2), {}, rec)
        torch.cuda.empty_cache()
    del x
    Mm = 16
    xm = torch.randn((T, N, Mm), generator=g, device="cuda")
    thm = tuple(np.linspace(-9.0, 9.0, Mm))
    km = dict(fs=31.25e6, c0=1540.0, pitch=0.15e-3)
    fn = lambda: migration_sharded(mesh4, xm, 0.0, np.zeros((N, Mm), np.float32), thm, **km)  # noqa
    fn1 = lambda: fdbf.stolt_migration(xm, 0.0, np.zeros((N, Mm), np.float32), thm, **km)  # noqa
    got, ref = fn(), fn1()
    r = float((got - ref).abs().max() / ref.abs().max())
    print(f"phase24 migration_sharded (bench_migration cell, 4096 x 256 x 16) on mesh4 vs one "
          f"device: rel={r:.3e}")
    assert r < TOL
    _tax("migration_sharded, 16 angles", _ms(fn, reps=2), _ms(fn1, reps=2), {}, rec)
    del xm, got, ref
    torch.cuda.empty_cache()

    # the cheat sheet, as a user runs it, on the card
    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    cs = subprocess.run([sys.executable, "-m", "qups_tpu_torch.examples.cheat_sheet"], cwd=root,
                        capture_output=True, text=True, timeout=600)
    rec["cheat_sheet_s"] = time.perf_counter() - t
    print(f"phase24 python -m qups_tpu_torch.examples.cheat_sheet: exit {cs.returncode}, "
          f"{rec['cheat_sheet_s']:.3f} s; last line {cs.stdout.strip().splitlines()[-1:]}")
    assert cs.returncode == 0 and "cheat sheet OK" in cs.stdout, cs.stderr[-4000:]
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase24 launches on the mesh path: {launches}; the phase {rec['phase_s']:.3f} s")
    return launches, rec


# the port's benchmark entry points (slice 14)
BENCH_BUDGET = "10"  # seconds a sweep may start new sizes in, as QUPS_BENCH_BUDGET
BENCH_RATE = 0.15  # the headline's host-clock sums/s against phase 4's CUDA-event rate


def _positive(v, where):
    """Every number of a bench record finite and positive."""
    if isinstance(v, dict):
        for k, u in v.items():
            _positive(u, f"{where}.{k}")
    elif isinstance(v, (list, tuple)):
        for u in v:
            _positive(u, where)
    elif isinstance(v, (int, float)) and not isinstance(v, bool):
        assert np.isfinite(v) and v > 0, (where, v)


def _entry(fn, argv, env):
    """``fn(argv)`` with the QUPS_BENCH_* knobs set to ``env`` alone and its
    standard output captured: (its return value, the JSON lines it printed)."""
    import contextlib
    import io

    saved = {k: v for k, v in os.environ.items() if k.startswith("QUPS_BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(env)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
    finally:
        for k in env:
            del os.environ[k]
        os.environ.update(saved)
    lines = [json.loads(s) for s in buf.getvalue().splitlines() if s.strip()]
    for rec in lines:
        assert "error" not in rec, rec
        _positive(rec, rec.get("bench", "bench"))
    return rc, lines


# the shapes the bench path ran, at which phase 25 holds each of its kernels
# to the plain version: the headline (bench.CONFIGS['full'], T N M n, whose
# traces the lut and adjoint sweeps draw too), the das sweep's largest image
# and the coherence sweep's default (T N M n), the greens sweep's largest
# cloud (elements a side, 2^p scatterers) and the adjoint sweep's bins
BENCH_SHAPES = dict(headline=(4096, 256, 256, 1024), das=(1024, 128, 128, 4096),
                    coherence=(2048, 128, 64, 512), greens=(128, 20), adjoint_bins=64)


def _bench_shapes_ran(sweeps, shapes):
    """The sweeps' records reached the shapes of ``shapes``."""
    by = {}
    for rec in sweeps:
        by.setdefault(rec["bench"], []).append(rec)
    das = max(by["das"], key=lambda r: r["n_px_side"])
    assert (das["T"], das["N"], das["M"], das["n_px_side"]) == shapes["das"], das
    for r in by["coherence"] + by["lut"] + by["adjoint"]:
        key = "coherence" if r["bench"] == "coherence" else "headline"
        assert (r["T"], r["N"], r["M"], r["n_px_side"]) == shapes[key], r
    N, p = shapes["greens"]
    assert {(r["impl"], r["S"], r["N"]) for r in by["greens"]} >= {
        ("freq", 2 ** p, N), ("pallas", 2 ** p, N)}, by["greens"]
    assert by["adjoint"][0]["bins"] == shapes["adjoint_bins"]


def _bench_parity(torch, ops, errs):
    """Each kernel the bench path launches, held to its plain version on the
    bench's own inputs at the bench's own shapes, built by
    ``qups_tpu_torch.bench`` and ``.benches``: the kernel on the whole
    problem, the plain version on every 64th pixel (greens: 16 x 16 of the
    elements, the array's ends among them, 1 in 64 traces at 128 a side).
    The headline in f32 and bf16pair, cubic and linear (K1, K1(e)); the lut
    sweep's tables, t0 = 0, on the headline's traces (K2 linear and cubic);
    the adjoint sweep's FSA system on the same traces (K4, bf16); the das
    sweep's largest image (K1 linear); the coherence sweep's keep_rx samples
    (K1(c)); the greens sweep's largest cloud through K3 and through K5 with
    the finish kernel; the layout kernel, bit for bit, on the headline's
    and the das sweep's traces. Within TOL (K4: TOL_BF16), each error into
    the kernels line. These launches compare, and are not counted."""
    from qups_tpu_torch import bench, benches
    from qups_tpu_torch.ops.fdbf import bf_adjoint

    dc, dev, shapes = ops.das_cuda, "cuda", BENCH_SHAPES

    def hold(name, got, ref, where, tol=TOL):
        a, r = errs[name].add(got, ref, f"phase25 {where}")
        print(f"phase25 {name} vs plain, {where}: max_abs_err={a:.3e} rel={r:.3e}")
        assert r < tol, (where, r)

    def every64(n):
        return torch.arange(0, n * n, 64, device=dev)

    T, N, M, n = shapes["headline"]
    x, pi, pr, pv, nv, t0 = bench.das_problem(T, N, M, n)
    xg = torch.as_tensor(x).to(dev)
    del x
    sub = every64(n)
    geo = tuple(torch.as_tensor(a).to(dev) for a in (pi, pr, pv, nv)) + (t0,)  # as headline()
    for precision in ("f32", "bf16pair"):
        for method in ("cubic", "linear"):
            kw = dict(fs=bench.FS, tx_model="plane", method=method, precision=precision)
            got = dc.das_sum(xg, *geo, bench.CINV, im_shape=(n, n, 1), **kw)[sub]
            ref = dc.das_sum_plain(xg, geo[0][sub], *geo[1:], bench.CINV, **kw)
            hold("das_k1" if precision == "f32" else "das_k1e", got, ref,
                 f"bench headline {precision} {method}, every 64th pixel")
    for method in ("cubic", "linear"):
        _layout_parity(torch, dc, errs["das_layout"], method, xg,
                       f"phase25 layout {method}, the headline's traces")
    tau_rx, tau_tx, t0z = benches.lut_tables(N, M, n, dev)
    for method in ("linear", "cubic"):
        kw = dict(fs=benches.FS, method=method)
        got = dc.das_lut_sum(xg, tau_rx, tau_tx, t0z, im_shape=(n, n, 1), precision="f32",
                             **kw)[sub]
        ref = dc.das_lut_sum_plain(xg, tau_rx[sub], tau_tx[sub], t0z, **kw)
        hold("das_lut_k2", got, ref, f"lut sweep {method}, every 64th pixel")
    del tau_rx, tau_tx
    us, chd, bins = benches.adjoint_problem(xg, n, shapes["adjoint_bins"])
    got = us.bfAdjoint(chd, bins=bins, kernel="auto", device=dev).reshape(-1)[sub]
    args = _adjoint_args(us, chd, None, bins)
    ref = bf_adjoint(xg, args[1][sub], args[2][sub], *args[3:], fs=float(chd.fs),
                     precision="bf16")
    hold("fdbf_adjoint_k4", got, ref.reshape(-1), "adjoint sweep bf16, every 64th pixel",
         TOL_BF16)
    del xg, us, chd, args, geo

    for what in ("das", "coherence"):
        T, N, M, n = shapes[what]
        x, pi, sub = benches.traces((T, N, M), dev), bench.pixels(n), every64(n)
        keep = what == "coherence"
        got = benches.das_image(x, pi, n, keep_rx=keep)[sub]
        ref = dc.das_sum_plain(x, pi[sub.cpu().numpy()], *benches.sweep_geometry(N, M),
                               1 / benches.C0, fs=benches.FS, tx_model="plane",
                               method="linear", keep_rx=keep)
        hold("das_k1c" if keep else "das_k1", got, ref,
             f"{what} sweep linear{' keep_rx' if keep else ''} {n}^2 x {N} x {M} T {T}, "
             "every 64th pixel")
        if not keep:
            _layout_parity(torch, dc, errs["das_layout"], "linear", x,
                           "phase25 layout linear, the das sweep's traces")
    del x

    N, p = shapes["greens"]
    *_, (S, (kern, ps, amp, pn, pv, kw)) = benches.greens_clouds(N, p)
    els = np.unique(np.linspace(0, N - 1, 16).round().astype(int))
    for impl, names in (("freq", ("greens_freq_k3",)),
                        ("pallas", ("greens_splat_k5", "greens_finish"))):
        got = benches.greens_traces(impl, kern, ps, amp, pn, pv, dev, **kw)[:, els][:, :, els]
        ref = benches.greens_traces(impl, kern, ps, amp, pn[els], pv[els], dev,
                                    kernel="plain", **kw)
        for name in names:
            hold(name, got, ref, f"greens sweep {impl} S={S} {N} x {N}, "
                 f"{els.size} x {els.size} traces")


def phase25(torch, ops, root, k1_cubic_ms, k1_check, errs):
    """The port's benchmark entry points on the card, in this process so
    that their launches are counted (zeroed just before, read just after):
    ``qups_tpu_torch.bench.main()`` at full size (1024^2 px x 256 x 256, T
    4096: cubic in float32 with linear beside it, then in bf16pair), every
    sweep of ``qups_tpu_torch.benches`` (QUPS_BENCH_BUDGET=BENCH_BUDGET);
    then ``python -m qups_tpu_torch.bench`` at QUPS_BENCH_SIZE=small as a
    user runs it. Every line parses, holds no error, and every number in it
    is finite and positive; the float32 headline's check equals phase 4's
    sum|img| (the same traces and kernel) to 1e-6, and its sums/s lies
    within BENCH_RATE of phase 4's CUDA-event rate; K1, K1(c), K1(e), K2,
    K3, K4 and K5 each launched; the sweeps reached BENCH_SHAPES, where
    :func:`_bench_parity` then holds each of those kernels to its plain
    version. Returns (launches by kernel, the record)."""
    from qups_tpu_torch import bench, benches

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()

    def path():
        head = {}
        for prec in ("f32", "bf16pair"):
            _, (rec,) = _entry(bench.main, [], {"QUPS_BENCH_PRECISION": prec})
            head[prec] = rec
            print("phase25 bench " + json.dumps(rec))
            torch.cuda.empty_cache()
        rc, sweeps = _entry(benches.main, ["all"], {"QUPS_BENCH_BUDGET": BENCH_BUDGET})
        for rec in sweeps:
            print("phase25 benches " + json.dumps(rec))
        assert rc == 0, rc
        return head, sweeps

    (head, sweeps), launches, _ = _counted(torch, ops, path)
    assert {r["bench"] for r in sweeps} == set(benches.BENCHES), sweeps
    f32, bf = head["f32"]["detail"], head["bf16pair"]["detail"]
    assert f32["precision"] == "f32" and bf["precision"] == "bf16pair"
    assert f32["method"] == "cubic" and "linear" in f32 and "linear" in bf
    chk = abs(f32["check"] - k1_check) / k1_check
    rate4 = 1024.0 ** 2 * 256 * 256 / (k1_cubic_ms / 1e3)
    off = head["f32"]["value"] / rate4 - 1
    print(f"phase25 headline check {f32['check']!r} vs phase 4's sum|img| {k1_check!r}: rel "
          f"{chk:.3e}; {head['f32']['value']:.4e} sums/s (host clock, min of 2) vs phase 4's "
          f"{rate4:.4e} (CUDA events, mean of 3): {100 * off:+.2f} %; bf16pair check rel "
          f"{abs(bf['check'] - k1_check) / k1_check:.3e}; on {f32['device']}")
    assert chk <= 1e-6, chk
    assert abs(off) <= BENCH_RATE, off
    assert abs(bf["check"] - k1_check) / k1_check < BAND
    for name in ("das_k1", "das_k1c", "das_k1e", "das_lut_k2", "greens_freq_k3",
                 "fdbf_adjoint_k4", "greens_splat_k5"):
        assert launches.get(name, 0) >= 1, (name, launches)
    _bench_shapes_ran(sweeps, BENCH_SHAPES)
    t = time.perf_counter()
    torch.cuda.empty_cache()
    _bench_parity(torch, ops, errs)
    torch.cuda.synchronize()
    parity_s = time.perf_counter() - t
    print(f"phase25 the bench path's kernels vs their plain versions at the bench's shapes: "
          f"{parity_s:.3f} s")
    t = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("QUPS_BENCH_")}
    sub = subprocess.run([sys.executable, "-m", "qups_tpu_torch.bench"], cwd=root,
                         env={**env, "QUPS_BENCH_SIZE": "small"}, capture_output=True,
                         text=True, timeout=600)
    sub_s = time.perf_counter() - t
    out = sub.stdout.strip().splitlines()
    print(f"phase25 python -m qups_tpu_torch.bench (small): exit {sub.returncode}, "
          f"{sub_s:.3f} s; {out[-1:]}")
    assert sub.returncode == 0 and len(out) == 1, sub.stderr[-4000:]
    small = json.loads(out[0])
    assert small["detail"]["size"] == "small" and "error" not in small
    _positive(small, "bench small")
    rec = {"bench": head, "benches": sweeps, "bench_small": small, "subprocess_s": sub_s,
           "parity_s": parity_s,
           "launches": launches, "check_rel": chk, "rate_vs_phase4": off,
           "phase_s": time.perf_counter() - t_phase}
    print(f"phase25 launches on the bench path: {launches}; the phase {rec['phase_s']:.3f} s")
    return launches, rec


# the JAX-named kernel-level entry points (slice 15)
def _abba_ms(fn_a, fn_b, reps):
    """(ms of ``fn_a``, ms of ``fn_b``), each the mean of two :func:`_ms`
    readings taken in the order a, b, b, a after one warm-up of each."""
    fn_a()
    fn_b()
    a1 = _ms(fn_a, reps, warm=False)
    b1 = _ms(fn_b, reps, warm=False)
    b2 = _ms(fn_b, reps, warm=False)
    a2 = _ms(fn_a, reps, warm=False)
    return (a1 + a2) / 2, (b1 + b2) / 2


ENTRY_KERNELS = {"das_tiled": "das_k1", "prep_sharded": "das_k1", "das_lut_tiled": "das_lut_k2",
                 "das_lut_plan": "das_lut_k2", "prep_lut_sharded": "das_lut_k2",
                 "bf_adjoint_tiled": "fdbf_adjoint_k4", "freq_gemm_cuda": "greens_freq_k3",
                 "freq_gemm_cuda bf16": "greens_freq_k3b",
                 "simus_spectrum_cuda": "greens_freq_k3c"}


def phase26(torch, qt, ops, errs):
    """The counterparts of the JAX package's kernel-level entry points at the
    headline shapes, each beside the method call that launches the same
    kernel: ``das_tiled`` (K1) and ``das_lut_plan`` / ``das_lut_tiled`` (K2)
    at 1024^2 x 256 x 256, T 4096, cubic, against ``das_sum`` /
    ``das_lut_sum``; ``prep_sharded`` / ``prep_lut_sharded`` on a 2 x 2
    grid, their shards launched with ``das_sum`` / ``das_lut_sum`` and
    summed, against the unsharded image and ``das_sharded_pallas(_plan)`` on
    [cuda:0] x 4; ``bf_adjoint_tiled`` (K4) at phase 8's adjoint headline
    against ``bf_adjoint_cuda``; ``freq_gemm_cuda`` (K3, K3(b)) and
    ``simus_spectrum_cuda`` (K3(c)) at phase 11's 10^5 scatterers x 128 x 128
    against the greens and simus GEMM passes; ``self_c0``. The entry points
    run once with the launch counts zeroed just before and read just after;
    each result equals its method's bit for bit where the launch is the same
    (the shards' sums within TOL) and its plain version on every 64th pixel
    (K3: 32 bins) within the kernel's limit; entry and method are timed in
    turns (CUDA events). Returns (launches by kernel, the record)."""
    from qups_tpu_torch import bench, parallel
    from qups_tpu_torch.ops.das import delay_tables
    from qups_tpu_torch.ops.fdbf import bf_adjoint, geom_delays
    from qups_tpu_torch.ops.greens_freq import gemm_pass, host_plan, prologue
    from qups_tpu_torch.ops.simus import simus_prologue
    from qups_tpu_torch.system import self_c0

    dc, fc, gfc = ops.das_cuda, ops.fdbf_cuda, ops.greens_freq_cuda
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    n, T, N, M, fs = 1024, 4096, 256, 256, 31.25e6
    x, pi, pr, pv, nv, t0 = bench.das_problem(T=T, N=N, M=M, n=n)
    xg = torch.as_tensor(x).cuda()
    del x
    cinv = np.float32(1 / 1540.0)
    im = (n, n, 1)
    geo = dict(fs=fs, tx_model="plane", method="cubic")
    lut = dict(fs=fs, method="cubic")
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cuda")
    mesh = parallel.make_mesh([torch.device("cuda", 0)] * 4, axes=("rx", "tx"), shape=(2, 2))
    kg = dict(T=T, tx_model="plane", im_shape=im, nrx=2, ntx=2, method="cubic")
    kl = dict(fs=fs, T=T, im_shape=im, nrx=2, ntx=2, method="cubic")

    def shards_k1(a, st):
        return sum(dc.das_sum(xg[:, r * 128:(r + 1) * 128, t * 128:(t + 1) * 128], a["pi"],
                              a["pr"][r], a["pv"][t], a["nv"][t], a["t0"][t], st["cinv"],
                              im_shape=st["im_shape"], **geo) for r in range(2) for t in range(2))

    def shards_k2(a, st):
        return sum(dc.das_lut_sum(xg[:, r * 128:(r + 1) * 128, t * 128:(t + 1) * 128],
                                  a["taur"][r], a["taut"][t], a["t0"][t], im_shape=im, **lut)
                   for r in range(2) for t in range(2))

    # K4 at phase 8's adjoint headline
    V = 256
    th = np.radians(np.linspace(-20, 20, V))
    del_tx = -(pr[:, 0:1] * np.sin(th)[None, :]) / 1540.0
    g = torch.Generator(device="cuda").manual_seed(8)
    xa = torch.randn((T, N, V), generator=g, device="cuda")
    taur = geom_delays(pi, pr, cinv, "cuda")
    sel = np.arange(1024 - 32, 1024 + 32)
    adj = (xa, taur, taur, del_tx, np.ones((M, V)), t0[0], np.zeros(V), sel)
    # K3 at phase 11's cloud
    us, _, _ = _main_system(qt)
    speck = _speckle(qt, 100_000, 11)
    ps, kern, pn, pvs, kw = us._greens_problem(speck)
    plan = host_plan(kern, ps, pn, pvs, T=kw["T"], s0=kw["s0"], t0k=kw["t0k"], fs=kw["fs"],
                     cinv=kw["cinv"], fsr=kw["fsr"], rtol=0.0)
    Fg = plan["k1"] - plan["k0"]
    gf = dict(L=plan["L"], k0=plan["k0"], F=Fg, R0=kw["R0"], fsr=kw["fsr"])
    k0s, Fs = _simus_band(us, kw["T"])
    sim_args = (ps, speck.amp, pn[:, 0], np.zeros(128), pvs[:, 0], np.zeros(128),
                [us.tx.width, us.rx.width])
    sk = dict(k0=k0s, F=Fs, T=kw["T"], fs=kw["fs"], c0=1540.0)
    sl = np.float32(kw["fs"] / (kw["T"] * 1540.0))

    def simus_method():
        q1, w1, s1, q2, w2, s2 = simus_prologue(*sim_args, sl, baffle="soft", device="cuda")
        return gfc.freq_gemm(q1, w1, q2, w2, k0=k0s, F=Fs, s1=s1, s2=s2)

    def gemm_method(bf16):
        return gemm_pass(plan, ps, speck.amp, pn, R0=kw["R0"], fsr=kw["fsr"], att=0.0,
                         bf16=bf16, gemm=gfc.freq_gemm, device="cuda")

    entries = {
        "das_tiled": (lambda: ops.das_tiled(xg, pi, pr, pv, nv, t0, cinv, im_shape=im, **geo),
                      lambda: dc.das_sum(xg, pi, pr, pv, nv, t0, cinv, im_shape=im, **geo),
                      "das_sum"),
        "das_lut_tiled": (lambda: ops.das_lut_tiled(xg, tau_rx, tau_tx, t0, im_shape=im, **lut),
                          lambda: dc.das_lut_sum(xg, tau_rx, tau_tx, t0, im_shape=im, **lut),
                          "das_lut_sum"),
        "bf_adjoint_tiled": (lambda: ops.bf_adjoint_tiled(*adj, fs=fs),
                             lambda: fc.bf_adjoint_cuda(*adj, fs=fs), "bf_adjoint_cuda"),
        "freq_gemm_cuda": (lambda: ops.freq_gemm_cuda(plan["phc"], ps, speck.amp, pn, pvs,
                                                      **gf),
                           lambda: gemm_method(False), "greens_freq.gemm_pass"),
        "freq_gemm_cuda bf16": (lambda: ops.freq_gemm_cuda(plan["phc"], ps, speck.amp, pn, pvs,
                                                           precision="bf16", **gf),
                                lambda: gemm_method(True), "greens_freq.gemm_pass bf16"),
        "simus_spectrum_cuda": (lambda: ops.simus_spectrum_cuda(*sim_args, **sk), simus_method,
                                "simus_prologue + freq_gemm"),
    }

    def path():
        out = {name: e[0]() for name, e in entries.items()}
        out["das_lut_plan"] = ops.das_lut_plan(tau_rx, tau_tx, t0, T=T, N=N, M=M, im_shape=im,
                                               **lut)(xg)
        a, st = ops.prep_sharded(pi, pr, pv, nv, t0, cinv, fs=fs, **kg)
        out["prep_sharded"] = shards_k1(a, st)
        a, st = ops.prep_lut_sharded(tau_rx, tau_tx, t0, **kl)
        out["prep_lut_sharded"] = shards_k2(a, st)
        return out

    got, launches, path_s = _counted(torch, ops, path)
    want = {"das_k1": 5, "das_lut_k2": 6, "das_layout": 11, "fdbf_adjoint_k4": 1,
            "greens_freq_k3": 1, "greens_freq_k3b": 1, "greens_freq_k3c": 1}
    assert {k: launches.get(k, 0) for k in want} == want, launches
    print(f"phase26 the entry points once, counted: {path_s:.3f} s; launches {launches}")
    rec = {}
    sub = np.arange(0, n * n, 64)  # every 64th pixel
    subg = torch.as_tensor(sub, device="cuda")
    for name, (entry, method, mname) in entries.items():
        ref = method()
        same = torch.equal(got[name], ref)
        e_ms, m_ms = _abba_ms(entry, method, 1 if name.startswith(("bf_", "freq", "simus"))
                              else 3)
        kname = ENTRY_KERNELS[name]
        if name in ("das_tiled", "das_lut_tiled"):
            pl = (dc.das_sum_plain(xg, pi[sub], pr, pv, nv, t0, cinv, **geo) if name ==
                  "das_tiled" else dc.das_lut_sum_plain(xg, tau_rx[subg], tau_tx[subg], t0,
                                                        **lut))
            a, r = errs[kname].add(got[name][subg], pl, f"phase26 {name}, every 64th pixel")
            lim = TOL
        elif name == "bf_adjoint_tiled":
            pl = bf_adjoint(xa, taur[subg], taur[subg], *adj[3:], fs=fs, precision="bf16")
            a, r = errs[kname].add(got[name][subg], pl, f"phase26 {name}, every 64th pixel")
            lim = TOL_BF16
        else:  # K3: the plain version on 32 bins mid-band
            bf16 = name.endswith("bf16")
            if name == "simus_spectrum_cuda":
                q1, w1, s1, q2, w2, s2 = simus_prologue(*sim_args, sl, baffle="soft",
                                                        device="cuda")
                k0, F, dirs = k0s, Fs, dict(s1=s1, s2=s2)
            else:
                q1, w1, q2, w2 = prologue(plan["phc"], ps, speck.amp, pn, pvs, R0=kw["R0"],
                                          fsr=kw["fsr"], device="cuda")
                k0, F, dirs = plan["k0"], Fg, {}
            f0 = F // 2
            pl = gfc.freq_gemm_plain(q1, w1, q2, w2, k0=k0 + f0, F=32, bf16=bf16, **dirs)
            a, r = errs[kname].add(got[name][f0:f0 + 32], pl, f"phase26 {name}, 32 bins")
            lim = TOL_K3B if bf16 else TOL
            del q1, w1, q2, w2
        rec[name] = dict(method=mname, ms=e_ms, method_ms=m_ms, equal_to_method=same,
                         max_abs_err=a, rel=r, kernel=kname)
        print(f"phase26 {name}: {e_ms:.3f} ms vs {mname} {m_ms:.3f} ms "
              f"({100 * (e_ms / m_ms - 1):+.2f} %); equal to it bit for bit: {same}; vs plain "
              f"max_abs_err={a:.3e} rel={r:.3e} (limit {lim:.0e})")
        assert same, name
        assert r < lim, (name, r)
        del ref, pl
    # the LUT plan: built once, applied; the shard preps beside the mesh plans
    pm = ops.das_lut_plan(tau_rx, tau_tx, t0, T=T, N=N, M=M, im_shape=im, **lut)
    assert torch.equal(got["das_lut_plan"], got["das_lut_tiled"])
    e_ms, m_ms = _abba_ms(lambda: pm(xg), lambda: dc.das_lut_sum(xg, tau_rx, tau_tx, t0,
                                                                  im_shape=im, **lut), 3)
    b_ms = _ms(lambda: ops.das_lut_plan(tau_rx, tau_tx, t0, T=T, N=N, M=M, im_shape=im,
                                        **lut), 3)
    rec["das_lut_plan"] = dict(method="das_lut_sum", ms=e_ms, method_ms=m_ms, build_ms=b_ms,
                               equal_to_method=True, kernel="das_lut_k2")
    print(f"phase26 das_lut_plan: apply {e_ms:.3f} ms vs das_lut_sum {m_ms:.3f} ms "
          f"({100 * (e_ms / m_ms - 1):+.2f} %); build {b_ms:.3f} ms; equal to das_lut_tiled")
    for name, prep, shards, ref, sharded in (
            ("prep_sharded", lambda: ops.prep_sharded(pi, pr, pv, nv, t0, cinv, fs=fs, **kg),
             shards_k1, got["das_tiled"],
             lambda: parallel.das_sharded_pallas(mesh, xg, pi, pr, pv, nv, t0, cinv,
                                                 im_shape=im, **geo)),
            ("prep_lut_sharded", lambda: ops.prep_lut_sharded(tau_rx, tau_tx, t0, **kl),
             shards_k2, got["das_lut_tiled"],
             lambda: parallel.das_lut_sharded_pallas(mesh, xg, tau_rx, tau_tx, t0,
                                                     im_shape=im, **lut))):
        a, r = _vs(got[name], ref, f"phase26 {name}")
        mesh_img = sharded()
        am, rm = _vs(got[name], mesh_img, f"phase26 {name} vs the mesh")
        _, p_s = _sync_s(torch, prep)
        e_ms, m_ms = _abba_ms(lambda: shards(*prep()), sharded, 1)
        rec[name] = dict(method="the mesh call on [cuda:0] x 4", ms=e_ms, method_ms=m_ms,
                         prep_ms=p_s * 1e3, vs_single_rel=r, vs_mesh_rel=rm,
                         kernel=ENTRY_KERNELS[name])
        print(f"phase26 {name} (2 x 2) + its shards' launches, summed: {e_ms:.3f} ms vs the "
              f"mesh call {m_ms:.3f} ms ({100 * (e_ms / m_ms - 1):+.2f} %); the prep alone "
              f"{p_s * 1e3:.3f} ms; vs the single call rel {r:.3e}, vs the mesh rel {rm:.3e}")
        assert r < TOL and rm < TOL, (name, r, rm)
        del mesh_img
    assert self_c0(us) == float(us.seq.c0) == 1540.0
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase26 self_c0 {self_c0(us)!r}; the phase {rec['phase_s']:.3f} s")
    del got, xg, xa, taur, tau_rx, tau_tx
    torch.cuda.empty_cache()
    return launches, rec


def _k3_library(torch, gfc, ops, g, bf16):
    """The yardstick of K3 on the bins of ``g``: one batched PyTorch GEMM of
    the plain version's operands (built outside the timing), in bf16 on the
    real-block form [[Ar^T, -Ai^T], [Ai^T, Ar^T]] . [Br; Bi] for K3(b), in
    complex64 otherwise. Returns ms."""
    k = torch.arange(g["k0"], g["k0"] + g["F"], dtype=torch.float32, device="cuda")
    A = gfc._phasors(ops[0], ops[1], k, 0.0, g.get("s1"), bf16)  # (F, S, N)
    B = gfc._phasors(ops[2], ops[3], k, 0.0, g.get("s2"), bf16)  # (F, S, M)
    if not bf16:
        return _ms(lambda: torch.bmm(A.transpose(1, 2), B), reps=2)
    At = A.transpose(1, 2)
    L = torch.cat((torch.cat((At.real, -At.imag), 2), torch.cat((At.imag, At.real), 2)),
                  1).to(torch.bfloat16)
    R = torch.cat((B.real, B.imag), 1).to(torch.bfloat16)
    del A, B, At
    return _ms(lambda: torch.bmm(L, R), reps=2)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU",
              file=sys.stderr)
        sys.exit(1)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import qups_tpu_torch as qt
    from qups_tpu_torch import ops

    assert "jax" not in sys.modules
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ("das_k1", "das_lut_k2", "greens_freq_k3", "fdbf_adjoint_k4", "greens_splat_k5",
             "greens_freq_k3b", "greens_freq_k3c", "das_layout", "greens_finish", "das_k1b",
             "das_lut_k2b", "das_k1c", "das_k1d", "das_lut_k2c", "das_k1e", "das_lut_k2e",
             "fdbf_adjoint_k4b", "fdbf_phasor_table")
    errs = {name: Errors() for name in names}
    card = phase0(torch, ops)
    phase1(torch, ops.das_cuda, errs["das_k1"], errs["das_layout"])
    k3_ms, k3_plain_ms, k3_b, k3_lib = phase2(torch, qt, ops.greens_freq_cuda,
                                              errs["greens_freq_k3"])
    launches = phase3(torch, qt, ops, errs)
    k1_ms, k1_plain_ms, lay, k1_check = phase4(torch, ops.das_cuda, errs["das_k1"])
    phase5(torch, ops.das_cuda, errs["das_lut_k2"], errs["das_layout"])
    phase6(torch, qt, ops.fdbf_cuda, errs["fdbf_adjoint_k4"])
    pw_launches = phase7(torch, qt, ops, errs)
    (k2_ms, k2_plain_ms), k4, k2_all = phase8(torch, ops, k1_ms, errs)
    k5 = phase9(torch, qt, ops.greens_cuda, errs["greens_splat_k5"], errs["greens_finish"])
    sim_launches, k3c_path, ctl10 = phase10(torch, qt, ops, errs)
    big = phase11(torch, qt, ops.greens_freq_cuda, errs)
    phase12(torch, ops.das_cuda, errs, errs["das_layout"])
    iq_launches = phase13(torch, qt, ops, errs)
    iqh, iq_args = phase14(torch, qt, ops.das_cuda, errs)
    phase15(torch, qt, ops.das_cuda, errs)
    keep, coh = phase16(torch, qt, ops.das_cuda, k1_ms["cubic"], errs, iq_args)
    phase17(torch, qt, ops.das_cuda, errs)
    lp = phase18(torch, ops.das_cuda, k1_ms, k2_all, iqh, iq_args, keep, errs)
    del iq_args
    vol_launches, k4b, table, _ = phase19(torch, qt, ops, errs)
    eik_launches = phase20(torch, qt, ops, errs)
    print(f"K2 launches on the eikonal path (phase 20): {eik_launches}; the kernels line's "
          f"das_lut_k2 row counts the demo path's (phase 7)")
    t = time.perf_counter()
    rf, rf_k1 = phase21(torch, qt, ops)
    fw, fw_k1 = phase22(torch, qt, ops)
    print(f"phases 21-22: {time.perf_counter() - t:.3f} s; K1 launches on the refocus imaging "
          f"path (phase 21): {rf_k1}, on the full-wave path (phase 22): {fw_k1}; the kernels "
          f"line's das_k1 row counts the FSA path's (phase 3)")
    print("slice 11 record: " + json.dumps({"refocus_migration": rf, "fullwave_rays": fw}))
    io_launches, io_rec = phase23(torch, qt, ops, errs)
    print("slice 12 record: " + json.dumps({"vantage_import": io_rec}))
    mesh_launches, mesh_rec = phase24(torch, qt, ops)
    print("slice 13 record: " + json.dumps({"mesh": mesh_rec}))
    bench_launches, bench_rec = phase25(torch, ops, root, k1_ms["cubic"], k1_check, errs)
    print("slice 14 record: " + json.dumps({"bench": bench_rec}))
    entry_launches, entry_rec = phase26(torch, qt, ops, errs)
    print("slice 15 record: " + json.dumps({"entry_points": entry_rec}))
    assert "jax" not in sys.modules
    # the launches in the run of the main path each kernel is on: the FSA
    # sim->image path (phase 3) for K1 and K3, the plane-wave demo path
    # (phase 7) for K2 and K4, the simulator path (phase 10) for K5 and
    # K3's bf16 and directivity variants
    # the bounds of K1, K2 and K5, which no PyTorch call computes alone. A
    # cubic term of K1 and K2 costs its delay to a sample index (4 flops K1,
    # 3 K2), the tap base and fraction 3, the Catmull-Rom cubic in the
    # fraction from the stencil's coefficients 3 FMAs (6 flops) and the sum
    # 1; the coefficients cost the layout kernel 10 flops per sample,
    # counted in its own bound. K1 and K2 take I N M terms at the headline.
    # A cubic K5 deposit (one per scatterer, rx, tx) costs 42 flops: p 4
    # (the sum of the radii, a product, two sums), the weight 2 (the product
    # of the clamped radii, a division), and its 4 taps 9 each (d 2, the
    # cubic 5, the weight 1, the sum 1). A radius and its clamp cost 10 (3
    # differences, 3 products, 2 sums, a square root, a max), r1 once per
    # scatterer and rx, r2 once per scatterer and tx: 10 S (N + M).
    # The finish reads the grid's N columns once and writes the traces once;
    # its 2 K flops per output and part are far below that.
    terms = 1024.0 ** 2 * 256 * 256
    k1_b = bound(14.0 * terms, F32_FLOPS, 4.0 * 4096 * 256 * 256 + 4.0 * 1024 ** 2)
    k2_b = bound(13.0 * terms, F32_FLOPS,
                 4.0 * 4096 * 256 * 256 + 4.0 * 1024 ** 2 * 512 + 4.0 * 1024 ** 2)
    k5_b = bound(42.0 * k5["deposits"] + 10.0 * k5["radii"], F32_FLOPS, 4.0 * k5["grid"])
    fin_b = bound(k5["fin_flops"], F32_FLOPS, k5["fin_bytes"])
    for what, ms, b in (("K1 headline cubic", k1_ms["cubic"], k1_b),
                        ("K2 headline cubic", k2_ms, k2_b),
                        ("K5 main-path grid, cubic", k5["k5"][0], k5_b),
                        ("finish kernel, main-path grid, complex", k5["finish"][0], fin_b)):
        _share(what, ms, b)
    # the layout kernel runs before each K1 and K2 launch: its count is
    # that of the FSA sim->image path, with K1
    # K1(c) and K1(d): the apodized and coherence imaging of the FSA path
    # (phase 3, in launches already); K2(c): the demo path's bfDAS keep_rx
    # and c0-map DAS with a dense weight (phase 7)
    # K1(e): the FSA path's DAS bf16pair, i8x4 and coherence_image bf16pair
    # (phase 3, in launches already); K2(e): the demo path's bfDAS i8x4
    # K1(b) and the layout kernel: the IQ ensemble path (phase 13) and the
    # Vantage import path (phase 23) added
    launches["das_layout"] += io_launches["das_layout"]
    launches.update(das_k1b=iq_launches["das_k1b"] + io_launches["das_k1b"],
                    das_lut_k2b=iq_launches["das_lut_k2b"],
                    das_lut_k2c=pw_launches["das_lut_k2c"],
                    das_lut_k2e=pw_launches["das_lut_k2e"],
                    das_lut_k2=pw_launches["das_lut_k2"],
                    fdbf_adjoint_k4=pw_launches["fdbf_adjoint_k4"],
                    fdbf_adjoint_k4b=vol_launches["fdbf_adjoint_k4b"],
                    fdbf_phasor_table=vol_launches["fdbf_phasor_table"],
                    greens_splat_k5=sim_launches["greens_splat_k5"],
                    greens_finish=sim_launches["greens_finish"],
                    greens_freq_k3b=sim_launches["greens_freq_k3b"],
                    greens_freq_k3c=sim_launches["greens_freq_k3c"])
    # the mesh path (phase 24): each kernel's launches on [cuda:0] x 4, added
    for name, v in mesh_launches.items():
        launches[name] = launches.get(name, 0) + v
    rows = [
        ("das_k1", "qups_tpu_torch/csrc/das.cu", "qups_tpu/ops/das_pallas.py:174",
         k1_ms["cubic"], k1_plain_ms, k1_b, None,
         "1024^2 px x 256 tx x 256 rx, T 4096, cubic; launches: the FSA path (phase 3), "
         f"and also {rf_k1} on the refocus imaging path (phase 21) and {fw_k1} on the "
         "full-wave path (phase 22)"),
        ("das_lut_k2", "qups_tpu_torch/csrc/das.cu", "qups_tpu/ops/das_pallas.py:1607",
         k2_ms, k2_plain_ms, k2_b, None, "1024^2 px x 256 tx x 256 rx, T 4096, cubic, "
         "plane-wave geometric tables"),
        ("greens_freq_k3", "qups_tpu_torch/csrc/greens_freq.cu",
         "qups_tpu/ops/greens_freq_pallas.py:41", k3_ms, k3_plain_ms, k3_b, k3_lib,
         "the main path's GEMM: 5 targets, 128 x 128 elements; library: complex64 "
         "torch.bmm of the phasors"),
        ("fdbf_adjoint_k4", "qups_tpu_torch/csrc/fdbf.cu", "qups_tpu/ops/fdbf_pallas.py:45",
         *k4["bf16"], "1024^2 px x 256 rx x 256 tx x 256 pulses, 64 bins, bf16; "
         f"f32 {k4['f32'][0]:.3f} ms vs plain {k4['f32'][1]:.3f} ms; library: the "
         "products alone, bf16 torch.bmm on the real-block operands, 4 bins scaled"),
        ("fdbf_adjoint_k4b", "qups_tpu_torch/csrc/fdbf.cu", "qups_tpu/ops/fdbf_pallas.py:45",
         *k4b, "K4(b): the volumetric path's keep '' call, 64^3 voxels x 1024 rx x 1024 tx x "
         "1024 pulses (32 x 32 matrix, FSA), 64 bins, bf16, on the wide route (phasor "
         "tables in device memory, 128-pixel blocks); keep_rx and keep_tx in phase 19's "
         "lines; plain on every 64th voxel, scaled; library: the products alone, bf16 "
         "torch.bmm on the real-block operands, 4 bins scaled; launches: the volumetric "
         "path, keep '' and keep_rx"),
        ("fdbf_phasor_table", "qups_tpu_torch/csrc/fdbf.cu",
         "qups_tpu/ops/fdbf_pallas.py:68 (phasor inside _kernel, used :105, :122)",
         *table, "K4(b)'s phasor tables: Wtx and Wrx of the volume's 64 bins, 64^3 voxels x "
         "1024 + 1024 elements, bf16 (Re, Im) pairs, each phasor built once a call; "
         "max_abs_err: bf16 entries within 2^-20 of the plain float32 phasor before their "
         "rounding, so a rounding the other way differs by one bf16 step; plain: "
         "phasor_table_plain on one bin, scaled; bound: the delays read once and the tables "
         "written once; no single PyTorch call computes it; launches: the volumetric path, "
         "keep '' (2 tables x 64 bins) and keep_rx (Wtx x 64 bins x 2 chunks of voxels)"),
        ("greens_splat_k5", "qups_tpu_torch/csrc/greens_splat.cu",
         "qups_tpu/ops/greens_pallas.py:45", *k5["k5"], k5_b, None,
         "the main path's deposit grid: 10^4 scatterers, 128 x 128 elements, cubic, bands "
         f"of 128 rows: {k5['visits']:.4e} visits ({k5['old_visits']:.4e} with tile "
         f"windows); the device plan {k5['plan_ms']:.3f} ms"),
        ("greens_freq_k3b", "qups_tpu_torch/csrc/greens_freq.cu",
         "qups_tpu/ops/greens_freq_pallas.py:41", *big["greens_freq_k3b"],
         "bf16 operands: 10^5 scatterers, 128 x 128 elements, 1025 bins; plain "
         f"timed on 32 bins and scaled; control K3(a) vs the bf16 plain version "
         f"rel {big['control']:.3e} (phase 11), {ctl10:.3e} (phase 10 traces), "
         f"limit {TOL_K3B:.0e}; library: bf16 torch.bmm on the real-block operands, 32 "
         f"bins scaled; K3(a) on this band {big['k3a'][0]:.3f} ms, its library "
         f"(complex64 torch.bmm, 32 bins scaled) {big['k3a'][1]:.3f} ms"),
        ("greens_freq_k3c", "qups_tpu_torch/csrc/greens_freq.cu",
         "qups_tpu/ops/greens_freq_pallas.py:41", *big["greens_freq_k3c"],
         f"sinc directivity: 10^5 scatterers, 128 x 128 elements, simus's bins; plain "
         f"timed on 32 bins and scaled (10^4 scatterers: {k3c_path[0]:.3f} ms vs "
         f"plain {k3c_path[1]:.3f} ms); library: complex64 torch.bmm, 32 bins scaled"),
        ("das_layout", "qups_tpu_torch/csrc/das.cu", "qups_tpu/ops/das_pallas.py:2017",
         *lay, None, "the traces K1 and K2 read: 4096 x 256 x 256 float32 into the cubic "
         "stencil (the TPU path builds its layout in XLA, das_pallas.py:2015-2023, with "
         "no pallas_call); plain: trace_layout_plain; launches: the FSA path (phase 3) and "
         "the Vantage import path (phase 23)"),
        ("das_k1b", "qups_tpu_torch/csrc/das.cu (das_iq.cu)",
         "qups_tpu/ops/das_pallas.py:174 (fmod :898-910, frames :1386-1393)",
         *iqh["das_k1b"], None, "K1(b): the headline in IQ, 1024^2 px x 256 tx x 256 rx x "
         "4 frames, T' 1024 complex64, fmod 5 MHz, cubic, the 4 frames in one call (run as "
         "4 one-frame calls on each frame's own layout, one chunk each; layout kernel "
         "included); bound: "
         f"{_iq_term_flops('cubic', False, 4)} flop per term; plain timed on every 64th "
         "pixel and scaled; launches: the IQ ensemble path (phase 13) and the Vantage "
         "import path (phase 23: DAS RF and IQ, 4 frames each)"),
        ("das_lut_k2b", "qups_tpu_torch/csrc/das.cu (das_iq.cu)",
         "qups_tpu/ops/das_pallas.py:1607 (fmod :898-910, frames :1386-1393)",
         *iqh["das_lut_k2b"], None, "K2(b): as K1(b) on plane-wave geometric tables; bound: "
         f"{_iq_term_flops('cubic', True, 4)} flop per term (+ 2 GiB of tables)"),
        ("das_k1c", "qups_tpu_torch/csrc/das.cu (das_keep.cu, das_keep_iq.cu)",
         "qups_tpu/ops/das_pallas.py:174 (keep modes :940-1060)", *keep["das_k1c"], None,
         "K1(c): keep_rx at the headline, 1024^2 px x 256 tx x 256 rx, T 4096, cubic, real "
         "(1 GiB out; das_keep_kernel's keep_rx variant, its sums in registers); keep_tx, "
         "keep_rx and keep_tx on one IQ frame with fmod and the coherence reductions in "
         "phase 16's lines "
         f"(cohfac {coh['cohfac'][1]:.3f} ms, slsc {coh['slsc'][1]:.3f} ms after the "
         "keep_rx call); plain on every 64th pixel, scaled; launches: phase 3's keep_rx, "
         "keep_tx and two coherence_image calls"),
        ("das_k1d", "qups_tpu_torch/csrc/das.cu (das_keep.cu, das_keep_iq.cu)",
         "qups_tpu/ops/das_pallas.py:102-155 (_rx_apod_weight, _tx_apod_weight)",
         *keep["das_k1d"], None, "K1(d): the summed headline with aperture_growth + "
         "acceptance_angle + tx_parallelogram evaluated in the kernel; plain: "
         "fused_weights + das on every 64th pixel, scaled; launches: phase 3's Fused and "
         "dense apodization"),
        ("das_lut_k2c", "qups_tpu_torch/csrc/das.cu (das_keep.cu, das_keep_iq.cu)",
         "qups_tpu/ops/das_pallas.py:1607 (keep modes :940-1060)", *keep["das_lut_k2c"], None,
         "K2(c): keep_rx at the headline on the plane-wave tables (+ 2 GiB of tables); plain "
         "on every 64th pixel, scaled; launches: phase 7's bfDAS keep_rx and c0-map DAS with "
         "a dense weight"),
        ("das_k1e", "qups_tpu_torch/csrc/das.cu (das_bf16.cu, das_i8.cu, das_keep_bf16.cu, "
         "das_keep_i8.cu, das_keep_acc16.cu and their _iq twins; real cubic traces: das.cu's "
         "float32 variants on the narrow units' layout of float32 coefficients)",
         "qups_tpu/ops/das_pallas.py:174 (precisions: _pack_pairs :1346, _pack_quads :1323, "
         "_quad_mix :1309, bf16 :2628, acc16 :2592)", *lp["das_k1e"], None,
         "K1(e): the headline, 1024^2 px x 256 tx x 256 rx, T 4096, cubic, real, in bf16pair "
         "(entry form f32c: the float32 Catmull-Rom coefficients of the bf16 taps, 16-byte "
         "entries, read by the float32 term; bound "
         f"{_lp_term_ops('bf16pair', 'cubic', False):.6g} flop per term + "
         f"{_lp_layout_ops('cubic', 1):.0f} per tap base, the least the function needs: the "
         "cubic's coefficients depend on the taps alone); the other samplers and widths, "
         "i8x4, the layout in each form, the IQ headline in bf16pair and i8x4, keep_rx in "
         "i8x4, bf16pair and with QUPS_DAS_ACC16 in phase 18's lines; plain on every 64th "
         "pixel, scaled; launches: phase 3's DAS bf16pair, i8x4 and coherence_image "
         "bf16pair"),
        ("das_lut_k2e", "qups_tpu_torch/csrc/das.cu (das_bf16.cu, das_i8.cu, das_keep_bf16.cu, "
         "das_keep_i8.cu and their _iq twins; real cubic traces: das.cu's float32 variants on "
         "the narrow units' layout of float32 coefficients)",
         "qups_tpu/ops/das_pallas.py:1607 (precisions: das_lut_plan :1906-1910, per-call "
         "scale :2076-2083)", *lp["das_lut_k2e"], None,
         "K2(e): as K1(e) on the plane-wave geometric tables (+ 2 GiB of tables); launches: "
         "phase 7's bfDAS i8x4"),
        ("greens_finish", "qups_tpu_torch/csrc/greens_finish.cu",
         "qups_tpu/ops/greens_pallas.py:380", *k5["finish"], fin_b, None,
         "the pulse convolution and row shift of the main path's grid into (T, N, M) "
         "complex64 traces (the TPU path runs it in XLA, greens_pallas.py:400-413, with "
         "no pallas_call); plain: finish_plain (convd direct, then a gather)"),
    ]
    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[name], "max_abs_err": errs[name].abs,
        "max_rel_err": errs[name].rel, "worst_check": errs[name].where,
        "ms": ms, "plain_ms": pms, "bound_ms": b[0], "bound_by": b[1],
        "library_ms": lib, "ms_at": at + (
            f"; launches also {mesh_launches[name]} on the mesh path (phase 24, four shards "
            "of the card)" if name in mesh_launches else "") + (
            f"; launches also {bench_launches[name]} on the bench path (phase 25, "
            "qups_tpu_torch.bench and .benches; held to the plain version there at the "
            "bench's shapes)" if bench_launches.get(name) else "") + (
            f"; launches also {entry_launches[name]} on the JAX-named entry points (phase 26)"
            if entry_launches.get(name) else ""),
        "entry_points": [dict(name=e, ms=v["ms"], method=v["method"],
                              method_ms=v["method_ms"]) for e, v in entry_rec.items()
                         if isinstance(v, dict) and v["kernel"] == name]}
        for name, src, rep, ms, pms, b, lib, at in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
