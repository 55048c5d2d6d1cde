"""K5: the time-domain Green's-function splat, hand-written CUDA for Hopper.

Port of :mod:`qups_tpu.ops.greens_pallas`. Replaces the TPU kernel
``qups_tpu/ops/greens_pallas.py::_splat_kernel`` (launched by
``_splat_tiled``, public entry ``greens_tiled``, which
``UltrasoundSystem.greens(impl='pallas')`` calls). The simulation is the
splat + convolve factorization of :mod:`qups_tpu_torch.ops.greens`: every
scatterer deposits the weights of a splat basis ``B`` (the linear tent, or
Catmull-Rom) at its fractional two-way delay row, then one convolution with
the pulse kernel along the deposit axis makes the traces.

* :func:`plan_tiled_device` is the plan of :func:`greens_tiled`, in torch on
  the device the traces go to: scatterers range-sorted by delay, a
  per-receiver row offset ``ofs[n]`` (the median delay to that element, which
  aligns the channels' echo hyperbolas), the deposit grid ``(M, Gtime,
  Npad)``, and per ``(m, band of rows, group of 32 receivers)`` a window of
  the sorted scatterers outside which a scatterer deposits exactly zero into
  that band of those receivers (:func:`band_windows`). Only a few scalars
  come back to the host.
* :func:`plan_tiled` is the same plan in numpy, as the JAX package computes
  it, with its windows per 8-row tile (:func:`_plan_scat_windows`): the
  oracle that the tests hold the device plan and the JAX package against.
* :func:`splat` fills the deposit grid: on CUDA tensors it launches K5
  (``csrc/greens_splat.cu``), on CPU tensors it runs :func:`splat_plain`.
  ``LAUNCHES`` counts the kernel launches.
* :func:`finish` convolves the grid with the kernel and undoes the row
  offset, ``x[t, n, m] = sum_k kern[k] grid[m, t + P0 - ofs[n] - k, n]``: on
  CUDA tensors in one pass by the finish kernel (``csrc/greens_finish.cu``,
  counted by ``FINISH_LAUNCHES``), on CPU tensors by :func:`finish_plain`.

Every deposit row ``j = 8 t + r`` of tile ``t`` gets, from scatterer ``s``,
receiver ``n`` and transmit ``m``,

    w B((p - 8t) - r),   p = (cinv_fs (r1 + r2) + pconst) - ofs[n],
    w = a_s / (max(r1, R0) max(r2, R0))  (w = a_s when R0 <= 0),

in the TPU kernel's order of operations.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _nvcc
from .conv import convd
from .interp import interp1
from ..utils.backend import default_device, is_cuda
from ..utils.profiling import annotate

LAUNCHES = 0  # K5 launches in this process
FINISH_LAUNCHES = 0  # launches of the finish kernel

SLAB = 131072  # scatterers per host slab (traces add linearly)
BASES = ("linear", "cubic")
BAND = 128  # rows per band of K5's windows: R of csrc/greens_splat.cu
GROUP = 32  # receivers per window: one warp's lanes in K5
PLAIN_TERMS = 1 << 22  # (scatterer, m, n) terms live at once in splat_plain
WINDOW_TERMS = 1 << 24  # (m, group, scatterer) rows live at once in band_windows


def build():
    """Build (if needed) and load ``csrc/greens_splat.cu``; return ``(entry
    point, nvcc log)``. Raises ``RuntimeError`` with nvcc's output on
    failure."""
    lib, log = _nvcc.load("greens_splat")
    fn = lib.greens_splat_k5
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, log


def build_finish():
    """Build (if needed) and load ``csrc/greens_finish.cu``; return ``(entry
    point, nvcc log)``."""
    lib, log = _nvcc.load("greens_finish")
    fn = lib.greens_finish
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, log


def _plan_scat_windows(sort_u, sort_U, a2, ntiles, CS, Q: int = 4):
    """Chunk windows per (m, tile) from sorted per-scatterer deposit-row
    intervals. ``sort_u/sort_U`` (S,) are the rx-wise min/max of the
    ofs-shifted one-way deposit rows (sorted order); ``a2`` (S, M) the
    per-tx additive term. Returns (lo_chunk, n_chunk) each (M, ntiles).

    ``Q``: window starts are quantized DOWN to multiples of Q chunks (ends
    rounded up); out-of-window scatterers deposit exactly zero, so widening
    is always safe. The same code as the JAX package's."""
    S, M = a2.shape
    lo_chunk = np.zeros((M, ntiles), np.int32)
    n_chunk = np.zeros((M, ntiles), np.int32)
    tq = np.arange(ntiles)
    for m in range(M):
        t0s = np.floor((sort_u + a2[:, m]) / 8.0).astype(np.int64) - 1
        t1s = np.ceil((sort_U + a2[:, m]) / 8.0).astype(np.int64) + 1
        # first scatterer that can reach tile t: running max of t1
        D = np.maximum.accumulate(t1s)
        losc = np.searchsorted(D, tq, side="left")
        # last scatterer that can reach tile t: running min (from the right)
        E = np.minimum.accumulate(t0s[::-1])[::-1]
        hisc = np.searchsorted(E, tq, side="right")
        SB = -(-S // CS)  # total chunks
        lo_c = np.minimum(losc // CS, max(0, SB - 1))
        hi_c = -(-np.maximum(hisc, losc) // CS)
        lo_c = (lo_c // Q) * Q
        # widen to the quantum but never past the last chunk
        hi_c = np.minimum(-(-hi_c // Q) * Q, SB)
        lo_chunk[m] = lo_c
        n_chunk[m] = np.maximum(0, hi_c - lo_c)
    return lo_chunk, n_chunk


def band_windows(u, U, a2, *, Gtime: int, band: int, basis: str):
    """K5's windows: ``(lo, hi)``, each (M, nbands, G) int32, the range
    ``[lo, hi)`` of sorted scatterers that can deposit into band ``b`` (rows
    ``[b band, (b + 1) band)``) of transmit ``m`` for the receivers of group
    ``g``. ``u, U`` (S, G) float64 are the lowest and highest deposit row of
    each sorted scatterer over the group's receivers before the transmit
    term, ``a2`` (S, M) float32 the transmit term in rows.

    A scatterer whose rows span ``[lo_p, hi_p]`` touches a band only where
    ``(lo_p - SUP, hi_p + SUP)`` meets it (SUP the basis's half-width, 1
    linear, 2 cubic); one row more on each side covers the float32 rounding
    of the kernel's rows. The first scatterer that can reach a band is where
    the running maximum of the high rows first reaches it, the last where the
    running minimum from the right of the low rows first passes it
    (``torch.searchsorted``); windows are only ever wider than needed, and a
    scatterer outside one deposits exactly zero there."""
    S, G = u.shape
    M = a2.shape[1]
    dev = u.device
    reach = (2 if basis == "cubic" else 1) + 1
    nb = -(-Gtime // band)
    b0 = torch.arange(nb, device=dev, dtype=torch.int32) * band
    lo = torch.empty((M, nb, G), dtype=torch.int32, device=dev)
    hi = torch.empty_like(lo)
    ut, Ut = u.T[None], U.T[None]  # (1, G, S)
    mc = max(1, WINDOW_TERMS // max(1, G * S))
    for m0 in range(0, M, mc):
        a = a2[:, m0:m0 + mc].T.double()[:, None, :]  # (mc, 1, S)
        lo_r = torch.floor(ut + a).to(torch.int32) - reach  # (mc, G, S)
        hi_r = torch.ceil(Ut + a).to(torch.int32) + reach
        D = torch.cummax(hi_r, -1).values
        E = torch.flip(torch.cummin(torch.flip(lo_r, [-1]), -1).values, [-1])
        q = b0.expand(D.shape[0], G, nb).contiguous()
        first = torch.searchsorted(D, q, side="left", out_int32=True)
        last = torch.searchsorted(E, q + (band - 1), side="right", out_int32=True)
        lo[m0:m0 + mc] = first.transpose(1, 2)
        hi[m0:m0 + mc] = torch.maximum(first, last).transpose(1, 2)
    return lo, hi


def visits(plan) -> int:
    """The (scatterer, m, n) visits K5 makes on a plan of
    :func:`plan_tiled_device`: the windows' lengths times the lanes."""
    return int((plan["hi"] - plan["lo"]).sum()) * GROUP


def _basis(d: torch.Tensor, basis: str) -> torch.Tensor:
    """The splat basis at row distance ``d``, as the TPU kernel writes it."""
    ad = torch.abs(d)
    if basis == "linear":
        return torch.clamp(1.0 - ad, min=0.0)
    inner = ((1.5 * ad - 2.5) * ad) * ad + 1.0
    outer = ((-0.5 * ad + 2.5) * ad - 4.0) * ad + 2.0
    return torch.where(ad <= 1.0, inner,
                       torch.where(ad < 2.0, outer, torch.zeros_like(ad)))


def _check(lo, hi, scat, pn, ofs, pv, Gtime, basis):
    if basis not in BASES:
        raise ValueError(f"unknown splat basis {basis!r}; expected {BASES}")
    if scat.ndim != 2 or scat.shape[1] != 4 or pn.ndim != 2 or pn.shape[0] != 3 \
            or pn.shape[1] % GROUP or pv.ndim != 2 or pv.shape[0] != 3 \
            or ofs.shape != (pn.shape[1],) or lo.shape != hi.shape \
            or tuple(lo.shape) != (pv.shape[1], -(-Gtime // BAND), pn.shape[1] // GROUP):
        raise ValueError(
            "K5 takes scat (S, 4), pn (3, Npad) with Npad a multiple of 32, ofs "
            f"(Npad,), pv (3, M), lo and hi (M, ceil(Gtime / {BAND}), Npad / 32); got "
            f"{[tuple(t.shape) for t in (scat, pn, ofs, pv, lo, hi)]}, Gtime {Gtime}")


def splat_plain(lo, hi, scat, pn, ofs, pv, *, Gtime: int, cinv_fs: float,
                pconst: float, R0: float, basis: str) -> torch.Tensor:
    """The plain PyTorch version of K5: the deposit grid ``(M, Gtime, Npad)``
    float32 on the device of ``scat``, with no windows (``lo`` and ``hi``
    are checked for the kernel's signature and not used). Each
    scatterer's 2 (linear) or 4 (cubic) nonzero taps per (m, n) go into the
    grid with ``index_add_``, blocks of scatterers at a time so that about
    ``PLAIN_TERMS`` (scatterer, m, n) terms are live. A tap at row
    ``j = 8 t + r`` takes ``d = (p - 8t) - r``, the kernel's order, so every
    term is the kernel's bit for bit; only the order of the sums differs."""
    _check(lo, hi, scat, pn, ofs, pv, Gtime, basis)
    dev = scat.device
    M, Npad = pv.shape[1], pn.shape[1]
    grid = torch.zeros(M * Gtime * Npad, dtype=torch.float32, device=dev)
    cinv_fs, pconst, R0 = (float(np.float32(v)) for v in (cinv_fs, pconst, R0))
    offs = (0, 1) if basis == "linear" else (-1, 0, 1, 2)
    cell = (torch.arange(M, device=dev)[:, None] * (Gtime * Npad)
            + torch.arange(Npad, device=dev)[None, :])  # (M, Npad)
    B = max(1, PLAIN_TERMS // max(1, M * Npad))
    for b0 in range(0, scat.shape[0], B):
        sc = scat[b0:b0 + B]
        x, y, z, a = (sc[:, i:i + 1] for i in range(4))  # (B, 1)
        dx, dy, dz = x - pn[0][None], y - pn[1][None], z - pn[2][None]
        r1 = torch.sqrt(dx * dx + dy * dy + dz * dz)  # (B, Npad)
        ex, ey, ez = x - pv[0][None], y - pv[1][None], z - pv[2][None]
        r2 = torch.sqrt(ex * ex + ey * ey + ez * ez)  # (B, M)
        p = (cinv_fs * (r1[:, None, :] + r2[:, :, None]) + pconst) \
            - ofs[None, None, :]  # (B, M, Npad)
        if R0 > 0:
            w = a[:, :, None] / (torch.clamp(r1, min=R0)[:, None, :]
                                 * torch.clamp(r2, min=R0)[:, :, None])
        else:
            w = a[:, :, None].expand(p.shape)
        j0 = torch.floor(p).to(torch.int64)
        for o in offs:
            j = j0 + o
            tb = torch.div(j, 8, rounding_mode="floor") * 8
            d = (p - tb.to(torch.float32)) - (j - tb).to(torch.float32)
            v = w * _basis(d, basis)
            ok = (j >= 0) & (j < Gtime)
            idx = cell[None] + j * Npad
            grid.index_add_(0, idx[ok], v[ok])
    return grid.reshape(M, Gtime, Npad)


def splat(lo, hi, scat, pn, ofs, pv, *, Gtime: int, cinv_fs: float,
          pconst: float, R0: float, basis: str) -> torch.Tensor:
    """The deposit grid ``(M, Gtime, Npad)`` float32: K5 on CUDA tensors,
    :func:`splat_plain` on CPU tensors.

    ``lo, hi``: (M, ceil(Gtime / BAND), Npad / 32) int32, the window
    ``[lo, hi)`` of sorted scatterers of each (m, band of ``BAND`` rows,
    group of 32 receivers), as :func:`band_windows` gives them; ``scat``:
    (S, 4) float32 range-sorted ``[x, y, z, amplitude]``; ``pn``: (3, Npad)
    receiver rows; ``ofs``: (Npad,) float32 row offsets; ``pv``: (3, M)
    transmitters; ``cinv_fs``, ``pconst``,
    ``R0``: the row scale, the constant row shift and the 1/r clamp, taken
    as float32; ``basis``: 'linear' or 'cubic'."""
    global LAUNCHES
    if not is_cuda(scat):
        return splat_plain(lo, hi, scat, pn, ofs, pv, Gtime=Gtime, cinv_fs=cinv_fs,
                           pconst=pconst, R0=R0, basis=basis)
    _check(lo, hi, scat, pn, ofs, pv, Gtime, basis)
    dev = scat.device
    ts = (scat, pn, ofs, pv)
    if any(t.dtype != torch.float32 or t.device != dev for t in ts) \
            or any(t.dtype != torch.int32 or t.device != dev for t in (lo, hi)):
        raise ValueError("K5 takes float32 geometry and int32 windows on one device")
    M, nb, G = lo.shape
    Npad = pn.shape[1]
    if M * nb >= 2**31 or G > 65535 or Gtime >= 2**30:
        raise ValueError(f"K5's launch takes M x bands < 2^31, Npad <= {65535 * GROUP} "
                         f"and Gtime < 2^30 (M {M}, bands {nb}, Npad {Npad}, Gtime {Gtime})")
    out = torch.empty((M, Gtime, Npad), dtype=torch.float32, device=dev)
    fn, _ = build()
    lo, hi, scat, pn, ofs, pv = (t.contiguous() for t in (lo, hi, scat, pn, ofs, pv))
    if scat.data_ptr() % 16:  # the kernel reads scatterers as float4
        scat = scat.clone()
    rc = fn(scat.data_ptr(), pn.data_ptr(), ofs.data_ptr(), pv.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), out.data_ptr(), Npad, M, Gtime, nb,
            float(cinv_fs), float(pconst), float(R0),
            int(basis == "cubic"), *_nvcc.stream_args(dev))
    if rc != 0:
        raise RuntimeError(f"K5 launch failed with cudaError {rc}")
    LAUNCHES += 1
    return out


def _shifts(P0: int, ofs, dev) -> torch.Tensor:
    """``P0 - ofs[n]``, int64 on ``dev``."""
    return P0 - torch.as_tensor(ofs, device=dev).to(torch.int64)


def finish_plain(grid: torch.Tensor, kern: torch.Tensor, *, T: int, P0: int,
                 ofs) -> torch.Tensor:
    """The plain version of the finish kernel: traces ``(T, N, M)`` from the
    deposit grid ``(M, Gtime, Npad)`` and a kernel ``(K,)``, real or complex
    (its parts one after the other): the full convolution along the deposit
    axis, then ``x[t, n, m] = full[m, t + P0 - ofs[n], n]`` (zero outside),
    gathered in one indexing op. ``ofs`` (N,) int64, numpy or a tensor. The
    convolution is the port's ``convd`` (a direct multiply-add, or an FFT
    for K > 64), not cuDNN, so no TF32 enters on a CUDA device."""
    if kern.is_complex():
        return torch.complex(finish_plain(grid, kern.real.contiguous(), T=T, P0=P0, ofs=ofs),
                             finish_plain(grid, kern.imag.contiguous(), T=T, P0=P0, ofs=ofs))
    dev = grid.device
    sh = _shifts(P0, ofs, dev)
    N = sh.shape[0]
    K = kern.shape[0]
    full = convd(grid[:, :, :N], kern.reshape(1, K, 1), axis=1, shape="full")
    Gf = full.shape[1]
    rows = torch.arange(T, device=dev)[:, None] + sh[None, :]  # (T, N)
    ok = (rows >= 0) & (rows < Gf)
    x = full[:, rows.clamp(0, Gf - 1), torch.arange(N, device=dev)[None, :]]
    x = torch.where(ok[None], x, torch.zeros((), dtype=x.dtype, device=dev))
    return x.permute(1, 2, 0)  # (T, N, M)


def finish(grid: torch.Tensor, kern: torch.Tensor, *, T: int, P0: int,
           ofs) -> torch.Tensor:
    """Traces ``(T, N, M)``, ``x[t, n, m] = sum_k kern[k] grid[m, t + P0 -
    ofs[n] - k, n]`` (grid rows outside ``[0, Gtime)`` are zero), float32
    for a real kernel ``(K,)`` and complex64 for a complex one: on CUDA
    tensors one launch of the finish kernel, which reads the grid once for
    both parts of a complex kernel and sums the taps in the plain version's
    order; on CPU tensors :func:`finish_plain`."""
    global FINISH_LAUNCHES
    if not is_cuda(grid):
        return finish_plain(grid, kern, T=T, P0=P0, ofs=ofs)
    dev = grid.device
    if grid.dtype != torch.float32 or grid.ndim != 3 or kern.ndim != 1 \
            or kern.dtype not in (torch.float32, torch.complex64) or kern.device != dev:
        raise ValueError("the finish kernel takes a float32 grid (M, Gtime, Npad) and a "
                         "float32 or complex64 kernel (K,) on its device")
    M, Gtime, Npad = grid.shape
    sh = _shifts(P0, ofs, dev)
    N, K = sh.shape[0], kern.shape[0]
    if not 0 < N <= Npad or K == 0 or T < 0:
        raise ValueError(f"finish: N {N} receivers of a grid of {Npad}, K {K}, T {T}")
    if -(-N // 32) > 65535 or -(-T // 16) * -(-M // 8) >= 2**31 or T + Gtime >= 2**30:
        raise ValueError(f"the finish kernel's launch cannot cover T {T}, N {N}, M {M}, "
                         f"Gtime {Gtime}")
    cplx = kern.is_complex()
    out = torch.empty((T, N, M), dtype=kern.dtype, device=dev)
    if T == 0 or M == 0:
        return out
    kr = kern.real.contiguous() if cplx else kern.contiguous()
    ki = kern.imag.contiguous() if cplx else kr
    grid, sh = grid.contiguous(), sh.to(torch.int32).contiguous()
    fn, _ = build_finish()
    rc = fn(grid.data_ptr(), kr.data_ptr(), ki.data_ptr(), sh.data_ptr(), out.data_ptr(),
            T, N, M, Gtime, Npad, K, int(cplx), *_nvcc.stream_args(dev))
    if rc != 0:
        raise RuntimeError(f"finish kernel launch failed with cudaError {rc}")
    FINISH_LAUNCHES += 1
    return out


def _setup(kern, pn, pv, fsr: float, method: str):
    """The host set-up both plans share: the kernel resampled to the output
    rate, sub-element arrays (N, En, 3), (M, Em, 3) float32, their centers
    and the sub-element radius in rows' units of length."""
    kern = np.asarray(kern)
    kern = kern.astype(np.complex64 if np.iscomplexobj(kern) else np.float32)
    pn = np.asarray(pn, np.float32)
    pv = np.asarray(pv, np.float32)
    if pn.ndim == 2:
        pn = pn[:, None, :]
    if pv.ndim == 2:
        pv = pv[:, None, :]
    if fsr != 1.0:  # resample the kernel to the output rate (host, small)
        Kn = int(np.ceil(kern.shape[0] / fsr))
        kern = interp1(torch.as_tensor(kern),
                       torch.arange(Kn, dtype=torch.float32) * fsr,
                       method=method).numpy()
    # sub-elements only widen the bounds: by their geometric radius
    cn = pn.mean(axis=1)  # (N, 3)
    cm = pv.mean(axis=1)  # (M, 3)
    sub_r1 = float(np.max(np.linalg.norm(pn - cn[:, None, :], axis=-1))) if pn.shape[1] > 1 else 0.0
    sub_r2 = float(np.max(np.linalg.norm(pv - cm[:, None, :], axis=-1))) if pv.shape[1] > 1 else 0.0
    return kern, pn, pv, cn, cm, sub_r1 + sub_r2


def _bounds(u_min, U_max, a2_min, a2_max, ofs_min, ofs_max, *, K, T, tshift_rows, method):
    """``(P0, Gtime)`` of the deposit grid from the plan's extreme rows, or
    ``None`` when no deposit reaches the output window."""
    # support margin of the splat basis; deposits whose kernel support
    # cannot reach [0, T) are dropped
    marg = 2.0 if method == "linear" else 3.0
    dep_lo = u_min + a2_min + tshift_rows
    dep_hi = U_max + a2_max + tshift_rows
    need_lo = -(K + marg + 2) - float(ofs_max)
    need_hi = T + marg + 2 - float(ofs_min)
    p_lo = max(dep_lo, need_lo)
    p_hi = min(dep_hi, need_hi)
    if p_hi < p_lo:  # nothing lands in the output window
        return None
    P0 = int(np.ceil(-p_lo + marg + 1))
    Gtime = int(np.ceil(p_hi + P0 + marg + 2))
    return P0, -(-Gtime // 8) * 8


def _rows(pn, Npad: int) -> np.ndarray:
    """Receiver rows (En, 3, Npad) float32; pads replicate the last element,
    so radii stay finite, and the finish crops their columns."""
    N, En = pn.shape[:2]
    rows = np.empty((En, 3, Npad), np.float32)
    rows[:, :, :N] = pn.transpose(1, 2, 0)
    rows[:, :, N:] = pn[-1][:, :, None]
    return rows


def plan_tiled(kern, ps, amp, pn, pv, *, T: int, s0: float, t0k: float,
               fs: float, cinv, R0: float, fsr: float = 1.0,
               method: str = "linear", CS: int = 256):
    """The plan of :func:`greens_tiled` in numpy, as the JAX package computes
    it (the tests' oracle): the kernel resampled to the output rate, the
    range sort, the scatterer packing, the row offsets and the chunk windows
    per 8-row tile. ``ps`` (S, 3), ``amp`` (S,) real, ``pn`` (N, En, 3),
    ``pv`` (M, Em, 3). Returns ``None`` when no deposit reaches the output
    window, else a dict: ``kern`` (K,), ``lo``, ``nc`` (M, ntiles) int32,
    ``scat`` (Spad, 4) float32, ``pn`` (En, 3, Npad) and ``pv`` (Em, 3, M)
    float32 sub-element rows, ``ofs_pad`` (Npad,) float32, ``ofs`` (N,)
    int64, ``P0``, and ``st``: ``Gtime``, ``CS``, ``cinv_fs``, ``pconst``,
    ``R0`` and ``basis``."""
    kern, pn, pv, cn, cm, sub_r = _setup(kern, pn, pv, fsr, method)
    ps = np.asarray(ps, np.float32)
    amp = np.asarray(amp, np.float32)
    N, S = pn.shape[0], ps.shape[0]
    cinv = float(np.asarray(cinv).reshape(()))
    K = kern.shape[0]

    # one-way rx delay rows (S, N) from element centers
    r1c = np.linalg.norm(ps[:, None, :] - cn[None], axis=-1)  # (S, N)
    a1 = cinv * fs * r1c  # rows
    # per-rx alignment offset: median deposit row for that channel
    ofs = np.round(np.median(a1, axis=0)).astype(np.int64)  # (N,)
    a1s = a1 - ofs[None, :]
    pad_rows = cinv * fs * sub_r
    u = a1s.min(axis=1) - pad_rows  # (S,)
    U = a1s.max(axis=1) + pad_rows
    r2c = np.linalg.norm(ps[:, None, :] - cm[None], axis=-1)  # (S, M)
    a2r = cinv * fs * r2c
    tshift_rows = (t0k - s0) * fs
    b = _bounds(u.min(), U.max(), a2r.min(), a2r.max(), ofs.min(), ofs.max(), K=K, T=T,
                tshift_rows=tshift_rows, method=method)
    if b is None:
        return None
    P0, Gtime = b
    ntiles = Gtime // 8

    # sort scatterers by the m-independent delay center
    order = np.argsort((u + U) / 2 + a2r.mean(axis=1))
    ps_s = ps[order]
    u_s = (u + tshift_rows + P0)[order]
    U_s = (U + tshift_rows + P0)[order]

    # pack scatterers (Spad, 4) [x, y, z, amp]; pads replicate the last
    # position with zero amplitude
    Spad = -(-S // CS) * CS
    scat = np.zeros((Spad, 4), np.float32)
    scat[:S, :3] = ps_s
    scat[:S, 3] = amp[order]
    scat[S:, :3] = ps_s[-1]

    Npad = -(-N // 128) * 128
    ofs_pad = np.empty(Npad, np.float32)
    ofs_pad[:N] = ofs
    ofs_pad[N:] = ofs[-1]
    # exact windows (Q=1): the kernel streams each window itself
    lo, nc = _plan_scat_windows(u_s, U_s, a2r[order], ntiles, CS, Q=1)
    return dict(kern=kern, lo=lo, nc=nc, scat=scat, pn=_rows(pn, Npad),
                pv=np.ascontiguousarray(pv.transpose(1, 2, 0)), ofs_pad=ofs_pad,
                ofs=ofs, P0=P0,
                st=dict(Gtime=Gtime, CS=CS, cinv_fs=cinv * fs,
                        pconst=float(tshift_rows + P0), R0=float(R0), basis=method))


def _radii(P: torch.Tensor, c: np.ndarray) -> torch.Tensor:
    """``|P[s] - c[j]|`` (S, J) float32 as ``np.linalg.norm`` rounds it,
    ``sqrt((dx^2 + dy^2) + dz^2)`` correctly rounded (through float64: the
    CPU's float32 sqrt is not)."""
    c = torch.as_tensor(c, device=P.device)
    d = [P[:, i:i + 1] - c[None, :, i] for i in range(3)]
    return torch.sqrt(((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]).double()).float()


def _median0(a: torch.Tensor) -> torch.Tensor:
    """``np.median(a, axis=0)`` of float32 ``a`` (S, N): for an even S the
    float32 mean of the two middle values, as numpy takes it
    (``torch.median`` returns the lower one)."""
    v = torch.sort(a, dim=0).values
    S = a.shape[0]
    return v[S // 2] if S % 2 else (v[S // 2 - 1] + v[S // 2]) / 2


def plan_tiled_device(kern, ps, amp, pn, pv, *, T: int, s0: float, t0k: float,
                      fs: float, cinv, R0: float, fsr: float = 1.0,
                      method: str = "linear", device=None):
    """The plan of :func:`greens_tiled` computed on ``device`` (default: the
    CUDA device): what :func:`plan_tiled` computes, with K5's windows per
    (m, band of ``BAND`` rows, group of 32 receivers) from
    :func:`band_windows` in place of its tile windows, and the scatterers
    unpadded (K5's windows end at S). Arguments as :func:`plan_tiled` but
    ``CS``; ``ps`` (S, 3) and ``amp`` (S,) go up to the device
    once, and only the plan's extreme rows (six scalars, one download) come
    back, for ``P0``, ``Gtime`` and the empty-window test.

    Returns ``None`` when no deposit reaches the output window, else a dict:
    ``kern`` (K,) numpy, ``lo``, ``hi`` (M, nbands, Npad / 32) int32,
    ``scat`` (S, 4) float32, ``pn`` (En, 3, Npad), ``pv`` (Em, 3, M),
    ``ofs_pad`` (Npad,) float32, ``ofs`` (N,) int64 (tensors on ``device``),
    ``P0``, and ``st``, the keyword arguments of :func:`splat`.

    It rounds as the numpy plan does: the radii as ``np.linalg.norm``, the
    median as ``np.median``, the row bounds in float64 (numpy promotes the
    float32 rows minus the int64 offsets to float64). Only the sort key's
    mean over transmits is summed in float64 where numpy sums float32, so
    scatterers whose keys tie to a float32 rounding may sort the other way;
    every order gives the same grid up to the order of its sums."""
    dev = default_device(device)
    kern, pn, pv, cn, cm, sub_r = _setup(kern, pn, pv, fsr, method)
    N, M, S = pn.shape[0], pv.shape[0], np.shape(ps)[0]
    Npad = -(-N // 128) * 128
    # every upload first: a copy from host memory waits for the queue
    P, amp, rows, pvr = (torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
                         for a in (ps, amp, _rows(pn, Npad), pv.transpose(1, 2, 0)))
    cfs = float(np.asarray(cinv).reshape(())) * fs
    a1 = cfs * _radii(P, cn)  # (S, N) rows
    ofs = torch.round(_median0(a1)).to(torch.int64)  # (N,)
    a1s = a1.double() - ofs[None, :]
    pad_rows = cfs * sub_r
    u = a1s.amin(1) - pad_rows  # (S,)
    U = a1s.amax(1) + pad_rows
    a2r = cfs * _radii(P, cm)  # (S, M)
    tshift_rows = (t0k - s0) * fs
    ext = torch.stack([u.min(), U.max(), a2r.min().double(), a2r.max().double(),
                       ofs.min().double(), ofs.max().double()]).tolist()
    b = _bounds(*ext, K=kern.shape[0], T=T, tshift_rows=tshift_rows, method=method)
    if b is None:
        return None
    P0, Gtime = b

    order = torch.argsort((u + U) / 2 + a2r.double().mean(1), stable=True)
    scat = torch.cat((P[order], amp[order, None]), 1)

    ofs_pad = torch.cat((ofs, ofs[-1:].expand(Npad - N))).float()
    # each group's lowest and highest row: the pad lanes replicate the last
    # receiver, its rows and its offset
    a1p = torch.cat((a1s, a1s[:, -1:].expand(S, Npad - N)), 1)[order]
    a1p = a1p.view(S, Npad // GROUP, GROUP) + (tshift_rows + P0)
    lo, hi = band_windows(a1p.amin(-1) - pad_rows, a1p.amax(-1) + pad_rows, a2r[order],
                          Gtime=Gtime, band=BAND, basis=method)
    return dict(kern=kern, lo=lo, hi=hi, scat=scat, pn=rows, pv=pvr,
                ofs_pad=ofs_pad, ofs=ofs, P0=P0,
                st=dict(Gtime=Gtime, cinv_fs=cfs,
                        pconst=float(tshift_rows + P0), R0=float(R0), basis=method))


def greens_tiled(kern, ps, amp, pn, pv, *, T: int, s0: float, t0k: float,
                 fs: float, cinv, R0: float, fsr: float = 1.0,
                 method: str = "linear", CS: int = 256, kernel: str = "auto",
                 device=None) -> torch.Tensor:
    """Green's-function FSA simulation through the splat kernel K5, on
    ``device`` (default: the CUDA device).

    Same contract as :func:`qups_tpu_torch.ops.greens.greens_splat`:
    ``kern`` (K,) sampled at ``fsr * fs``, real or complex (the deposit grid
    does not depend on the kernel, so a complex kernel costs one splat pass
    and one finish that reads the grid once); ``ps`` (S, 3) scatterer
    positions; ``amp`` (S,) real amplitudes; ``pn`` (N, En, 3) rx and ``pv``
    (M, Em, 3) tx sub-element positions. ``method``: 'linear' or 'cubic',
    the splat basis; for ``fsr != 1`` the kernel is first resampled with
    that interpolator. ``CS``: the JAX package's scatterer chunk, taken for
    its signature; K5's windows end at the last scatterer, so nothing is
    padded to it. Clouds of more than ``SLAB`` scatterers go in slabs whose
    traces add.

    The plan (:func:`plan_tiled_device`) runs on ``device``. ``kernel``:
    'auto' runs K5 and the finish kernel on a CUDA device and their plain
    versions on the CPU; 'cuda' requires the kernels; 'plain' runs the plain
    versions on any device.

    Returns (T, N, M) float32 on ``device``, complex64 for a complex kernel
    (also when no deposit reaches the output window: the JAX package
    returns float32 zeros there).
    """
    if method not in BASES:
        raise ValueError("greens_tiled supports linear/cubic splat only")
    if kernel not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown kernel {kernel!r}")
    device = default_device(device)
    if kernel == "cuda" and device.type != "cuda":
        raise ValueError("kernel='cuda' needs a CUDA device")
    if np.iscomplexobj(np.asarray(amp)):
        raise ValueError("greens_tiled needs real amplitudes; split re/im passes "
                         "for complex")
    ps = np.asarray(ps, np.float32)
    kw = dict(T=T, s0=s0, t0k=t0k, fs=fs, cinv=cinv, R0=R0, fsr=fsr, method=method)
    if ps.shape[0] > SLAB:  # slabs of the scatterer cloud; traces add
        amp = np.asarray(amp, np.float32)
        acc = None
        for i0 in range(0, ps.shape[0], SLAB):
            part = greens_tiled(kern, ps[i0:i0 + SLAB], amp[i0:i0 + SLAB], pn, pv,
                                kernel=kernel, device=device, **kw)
            acc = part if acc is None else acc + part
        return acc
    with annotate("qups.greens_tiled.plan"):
        plan = plan_tiled_device(kern, ps, amp, pn, pv, device=device, **kw)
    if plan is None:
        return torch.zeros((T, np.shape(pn)[0], np.shape(pv)[0]),
                           dtype=torch.complex64 if np.iscomplexobj(kern)
                           else torch.float32, device=device)
    fill, fin = (splat_plain, finish_plain) if kernel == "plain" else (splat, finish)
    win = (plan["lo"], plan["hi"], plan["scat"])
    # up before the splat: a copy from host memory waits for the queue
    kern = torch.as_tensor(plan["kern"], device=device)
    # accumulate the deposit grid over sub-element pairs, then convolve once
    with annotate("qups.greens_tiled.splat"):
        grid = None
        for pnk in plan["pn"]:
            for pvk in plan["pv"]:
                g = fill(*win, pnk, plan["ofs_pad"], pvk, **plan["st"])
                grid = g if grid is None else grid + g
    with annotate("qups.greens_tiled.finish"):
        return fin(grid, kern, T=T, P0=plan["P0"], ofs=plan["ofs"])
