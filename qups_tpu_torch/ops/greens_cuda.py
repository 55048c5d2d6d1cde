"""K5: the time-domain Green's-function splat, hand-written CUDA for Hopper.

Port of :mod:`qups_tpu.ops.greens_pallas`. Replaces the TPU kernel
``qups_tpu/ops/greens_pallas.py::_splat_kernel`` (launched by
``_splat_tiled``, public entry ``greens_tiled``, which
``UltrasoundSystem.greens(impl='pallas')`` calls). The simulation is the
splat + convolve factorization of :mod:`qups_tpu_torch.ops.greens`: every
scatterer deposits the weights of a splat basis ``B`` (the linear tent, or
Catmull-Rom) at its fractional two-way delay row, then one convolution with
the pulse kernel along the deposit axis makes the traces.

* :func:`plan_tiled` is the host plan of :func:`greens_tiled`, numpy as in
  the JAX package: scatterers range-sorted by delay, a per-receiver row
  offset ``ofs[n]`` (the median delay to that element, which aligns the
  channels' echo hyperbolas), the deposit grid ``(M, Gtime, Npad)`` in
  8-row tiles, and per ``(m, tile)`` a window of scatterer chunks
  (:func:`_plan_scat_windows`) outside which a scatterer deposits exactly
  zero into that tile.
* :func:`splat` fills the deposit grid: on CUDA tensors it launches K5
  (``csrc/greens_splat.cu``), on CPU tensors it runs :func:`splat_plain`.
  ``LAUNCHES`` counts the kernel launches.
* :func:`finish` convolves the grid with the kernel and undoes the row
  offset: ``x[t, n, m] = full[m, t + P0 - ofs[n], n]``.

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

LAUNCHES = 0  # K5 launches in this process

SLAB = 131072  # scatterers per host slab (traces add linearly)
BASES = ("linear", "cubic")
PLAIN_TERMS = 1 << 22  # (scatterer, m, n) terms live at once in splat_plain


def build():
    """Build (if needed) and load ``csrc/greens_splat.cu``; return ``(entry
    point, nvcc log)``. Raises ``RuntimeError`` with nvcc's output on
    failure."""
    lib, log = _nvcc.load("greens_splat")
    fn = lib.greens_splat_k5
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
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


def _basis(d: torch.Tensor, basis: str) -> torch.Tensor:
    """The splat basis at row distance ``d``, as the TPU kernel writes it."""
    ad = torch.abs(d)
    if basis == "linear":
        return torch.clamp(1.0 - ad, min=0.0)
    inner = ((1.5 * ad - 2.5) * ad) * ad + 1.0
    outer = ((-0.5 * ad + 2.5) * ad - 4.0) * ad + 2.0
    return torch.where(ad <= 1.0, inner,
                       torch.where(ad < 2.0, outer, torch.zeros_like(ad)))


def _check(lo, nc, scat, pn, ofs, pv, basis):
    if basis not in BASES:
        raise ValueError(f"unknown splat basis {basis!r}; expected {BASES}")
    if scat.ndim != 2 or scat.shape[1] != 4 or pn.ndim != 2 or pn.shape[0] != 3 \
            or pv.ndim != 2 or pv.shape[0] != 3 or ofs.shape != (pn.shape[1],) \
            or lo.shape != nc.shape or lo.ndim != 2 or lo.shape[0] != pv.shape[1]:
        raise ValueError(
            "K5 takes scat (Spad, 4), pn (3, Npad), ofs (Npad,), pv (3, M), "
            f"lo and nc (M, ntiles); got {[tuple(t.shape) for t in (scat, pn, ofs, pv, lo, nc)]}")


def splat_plain(lo, nc, scat, pn, ofs, pv, *, Gtime: int, CS: int,
                cinv_fs: float, pconst: float, R0: float,
                basis: str) -> torch.Tensor:
    """The plain PyTorch version of K5: the deposit grid ``(M, Gtime, Npad)``
    float32 on the device of ``scat``, with no windows (``lo``, ``nc`` and
    ``CS`` are accepted for the kernel's signature and not used). Each
    scatterer's 2 (linear) or 4 (cubic) nonzero taps per (m, n) go into the
    grid with ``index_add_``, blocks of scatterers at a time so that about
    ``PLAIN_TERMS`` (scatterer, m, n) terms are live. A tap at row
    ``j = 8 t + r`` takes ``d = (p - 8t) - r``, the kernel's order, so every
    term is the kernel's bit for bit; only the order of the sums differs."""
    _check(lo, nc, scat, pn, ofs, pv, basis)
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


def splat(lo, nc, scat, pn, ofs, pv, *, Gtime: int, CS: int, cinv_fs: float,
          pconst: float, R0: float, basis: str) -> torch.Tensor:
    """The deposit grid ``(M, Gtime, Npad)`` float32: K5 on CUDA tensors,
    :func:`splat_plain` on CPU tensors.

    ``lo, nc``: (M, ntiles) int32 first chunk and chunk count of each
    (m, 8-row tile) window, ``Gtime = 8 ntiles``; ``scat``: (Spad, 4)
    float32 range-sorted ``[x, y, z, amplitude]``, ``Spad`` a multiple of
    ``CS``; ``pn``: (3, Npad) receiver rows, ``Npad`` a multiple of 128;
    ``ofs``: (Npad,) float32 row offsets; ``pv``: (3, M) transmitters;
    ``cinv_fs``, ``pconst``, ``R0``: the row scale, the constant row shift
    and the 1/r clamp, taken as float32; ``basis``: 'linear' or 'cubic'."""
    global LAUNCHES
    if not is_cuda(scat):
        return splat_plain(lo, nc, scat, pn, ofs, pv, Gtime=Gtime, CS=CS,
                           cinv_fs=cinv_fs, pconst=pconst, R0=R0, basis=basis)
    _check(lo, nc, scat, pn, ofs, pv, basis)
    dev = scat.device
    ts = (scat, pn, ofs, pv)
    if any(t.dtype != torch.float32 or t.device != dev for t in ts) \
            or any(t.dtype != torch.int32 or t.device != dev for t in (lo, nc)):
        raise ValueError("K5 takes float32 geometry and int32 windows on one device")
    M, ntiles = lo.shape
    Spad, Npad = scat.shape[0], pn.shape[1]
    if Gtime != 8 * ntiles or Npad % 128 or Spad % CS or not 0 < CS <= 2048:
        raise ValueError(f"K5 needs Gtime = 8 ntiles, Npad % 128 == 0 and Spad "
                         f"a multiple of CS <= 2048 (Gtime {Gtime}, ntiles {ntiles}, "
                         f"Npad {Npad}, Spad {Spad}, CS {CS})")
    if M * Gtime * Npad >= 2**31 or M >= 65536:
        raise ValueError("K5's grid must hold fewer than 2^31 cells and M < 65536")
    out = torch.empty((M, Gtime, Npad), dtype=torch.float32, device=dev)
    fn, _ = build()
    lo, nc, scat, pn, ofs, pv = (t.contiguous() for t in (lo, nc, scat, pn, ofs, pv))
    if scat.data_ptr() % 16:  # the kernel reads scatterers as float4
        scat = scat.clone()
    rc = fn(scat.data_ptr(), pn.data_ptr(), ofs.data_ptr(), pv.data_ptr(),
            lo.data_ptr(), nc.data_ptr(), out.data_ptr(), Spad, Npad, M, ntiles,
            CS, float(cinv_fs), float(pconst), float(R0),
            int(basis == "cubic"), *_nvcc.stream_args(dev))
    if rc != 0:
        raise RuntimeError(f"K5 launch failed with cudaError {rc}")
    LAUNCHES += 1
    return out


def finish(grid: torch.Tensor, kern: torch.Tensor, *, T: int, P0: int,
           ofs: np.ndarray) -> torch.Tensor:
    """Traces ``(T, N, M)`` from the deposit grid ``(M, Gtime, Npad)`` and a
    real kernel ``(K,)``: the full convolution along the deposit axis, then
    ``x[t, n, m] = full[m, t + P0 - ofs[n], n]`` (zero outside), gathered in
    one indexing op. The convolution is the port's ``convd`` (a direct
    multiply-add, or an FFT for K > 64), not cuDNN, so no TF32 enters on a
    CUDA device."""
    dev = grid.device
    N = len(ofs)
    K = kern.shape[0]
    full = convd(grid[:, :, :N], kern.reshape(1, K, 1), axis=1, shape="full")
    Gf = full.shape[1]
    sh = torch.as_tensor(P0 - np.asarray(ofs, np.int64), device=dev)
    rows = torch.arange(T, device=dev)[:, None] + sh[None, :]  # (T, N)
    ok = (rows >= 0) & (rows < Gf)
    x = full[:, rows.clamp(0, Gf - 1), torch.arange(N, device=dev)[None, :]]
    x = torch.where(ok[None], x, torch.zeros((), dtype=x.dtype, device=dev))
    return x.permute(1, 2, 0)  # (T, N, M)


def plan_tiled(kern, ps, amp, pn, pv, *, T: int, s0: float, t0k: float,
               fs: float, cinv, R0: float, fsr: float = 1.0,
               method: str = "linear", CS: int = 256):
    """The host plan of :func:`greens_tiled` (numpy, as the JAX package's):
    the kernel resampled to the output rate, the range sort, the scatterer
    packing, the row offsets and the chunk windows. ``ps`` (S, 3), ``amp``
    (S,) real, ``pn`` (N, En, 3), ``pv`` (M, Em, 3). Returns ``None`` when
    no deposit reaches the output window, else a dict: ``kern`` (K,),
    ``lo``, ``nc`` (M, ntiles) int32, ``scat`` (Spad, 4) float32, ``pn``
    (En, 3, Npad) and ``pv`` (Em, 3, M) float32 sub-element rows, ``ofs_pad``
    (Npad,) float32, ``ofs`` (N,) int64, ``P0``, and ``st``, the keyword
    arguments of :func:`splat`."""
    kern = np.asarray(kern)
    kern = kern.astype(np.complex64 if np.iscomplexobj(kern) else np.float32)
    ps = np.asarray(ps, np.float32)
    amp = np.asarray(amp, np.float32)
    pn = np.asarray(pn, np.float32)
    pv = np.asarray(pv, np.float32)
    if pn.ndim == 2:
        pn = pn[:, None, :]
    if pv.ndim == 2:
        pv = pv[:, None, :]
    N, En = pn.shape[:2]
    M, Em = pv.shape[:2]
    S = ps.shape[0]
    cinv = float(np.asarray(cinv).reshape(()))

    if fsr != 1.0:  # resample the kernel to the output rate (host, small)
        Kn = int(np.ceil(kern.shape[0] / fsr))
        kern = interp1(torch.as_tensor(kern),
                       torch.arange(Kn, dtype=torch.float32) * fsr,
                       method=method).numpy()
    K = kern.shape[0]

    # one-way rx delay rows (S, N) from element centers; sub-elements only
    # widen the bounds below
    cn = pn.mean(axis=1)  # (N, 3)
    cm = pv.mean(axis=1)  # (M, 3)
    r1c = np.linalg.norm(ps[:, None, :] - cn[None], axis=-1)  # (S, N)
    a1 = cinv * fs * r1c  # rows
    # per-rx alignment offset: median deposit row for that channel
    ofs = np.round(np.median(a1, axis=0)).astype(np.int64)  # (N,)
    a1s = a1 - ofs[None, :]
    # widen by the sub-element geometric radius
    sub_r1 = float(np.max(np.linalg.norm(pn - cn[:, None, :], axis=-1))) if En > 1 else 0.0
    sub_r2 = float(np.max(np.linalg.norm(pv - cm[:, None, :], axis=-1))) if Em > 1 else 0.0
    pad_rows = cinv * fs * (sub_r1 + sub_r2)
    u = a1s.min(axis=1) - pad_rows  # (S,)
    U = a1s.max(axis=1) + pad_rows
    r2c = np.linalg.norm(ps[:, None, :] - cm[None], axis=-1)  # (S, M)
    a2r = cinv * fs * r2c
    tshift_rows = (t0k - s0) * fs

    # support margin of the splat basis; deposits whose kernel support
    # cannot reach [0, T) are dropped
    marg = 2.0 if method == "linear" else 3.0
    dep_lo = u.min() + a2r.min() + tshift_rows
    dep_hi = U.max() + a2r.max() + tshift_rows
    need_lo = -(K + marg + 2) - float(ofs.max())
    need_hi = T + marg + 2 - float(ofs.min())
    p_lo = max(dep_lo, need_lo)
    p_hi = min(dep_hi, need_hi)
    if p_hi < p_lo:  # nothing lands in the output window
        return None
    P0 = int(np.ceil(-p_lo + marg + 1))
    Gtime = int(np.ceil(p_hi + P0 + marg + 2))
    Gtime = -(-Gtime // 8) * 8
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

    # rx lanes padded to a multiple of 128; pads replicate the last element
    # so radii stay finite, and finish crops their columns
    Npad = -(-N // 128) * 128
    ofs_pad = np.empty(Npad, np.float32)
    ofs_pad[:N] = ofs
    ofs_pad[N:] = ofs[-1]
    rows = np.empty((En, 3, Npad), np.float32)
    rows[:, :, :N] = pn.transpose(1, 2, 0)
    rows[:, :, N:] = pn[-1][:, :, None]
    # exact windows (Q=1): the kernel streams each window itself
    lo, nc = _plan_scat_windows(u_s, U_s, a2r[order], ntiles, CS, Q=1)
    return dict(kern=kern, lo=lo, nc=nc, scat=scat, pn=rows,
                pv=np.ascontiguousarray(pv.transpose(1, 2, 0)), ofs_pad=ofs_pad,
                ofs=ofs, P0=P0,
                st=dict(Gtime=Gtime, CS=CS, cinv_fs=cinv * fs,
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
    and two finishes); ``ps`` (S, 3) scatterer positions; ``amp`` (S,) real
    amplitudes; ``pn`` (N, En, 3) rx and ``pv`` (M, Em, 3) tx sub-element
    positions. ``method``: 'linear' or 'cubic', the splat basis; for
    ``fsr != 1`` the kernel is first resampled with that interpolator.
    ``CS``: scatterers per chunk of the windows. Clouds of more than
    ``SLAB`` scatterers go in slabs whose traces add.

    ``kernel``: 'auto' runs K5 on a CUDA device and the plain splat on the
    CPU; 'cuda' requires K5; 'plain' runs the plain splat on any device.

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
    kw = dict(T=T, s0=s0, t0k=t0k, fs=fs, cinv=cinv, R0=R0, fsr=fsr,
              method=method, CS=CS)
    if ps.shape[0] > SLAB:  # slabs of the scatterer cloud; traces add
        amp = np.asarray(amp, np.float32)
        acc = None
        for i0 in range(0, ps.shape[0], SLAB):
            part = greens_tiled(kern, ps[i0:i0 + SLAB], amp[i0:i0 + SLAB], pn, pv,
                                kernel=kernel, device=device, **kw)
            acc = part if acc is None else acc + part
        return acc
    plan = plan_tiled(kern, ps, amp, pn, pv, **kw)
    cplx = np.iscomplexobj(kern)
    if plan is None:
        return torch.zeros((T, np.shape(pn)[0], np.shape(pv)[0]),
                           dtype=torch.complex64 if cplx else torch.float32,
                           device=device)

    def dev_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    fill = splat_plain if kernel == "plain" else splat
    lo, nc, scat, ofs = (dev_t(plan[k]) for k in ("lo", "nc", "scat", "ofs_pad"))
    # accumulate the deposit grid over sub-element pairs, then convolve once
    grid = None
    for pnk in plan["pn"]:
        pnk = dev_t(pnk)
        for pvk in plan["pv"]:
            g = fill(lo, nc, scat, pnk, ofs, dev_t(pvk), **plan["st"])
            grid = g if grid is None else grid + g
    fin = dict(T=T, P0=plan["P0"], ofs=plan["ofs"])
    kern = plan["kern"]
    if cplx:
        return torch.complex(finish(grid, dev_t(kern.real), **fin),
                             finish(grid, dev_t(kern.imag), **fin))
    return finish(grid, dev_t(kern), **fin)
