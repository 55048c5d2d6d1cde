"""Frequency-domain beamforming: transmit synthesis, the adjoint
beamformer, REFoCUS decoding and Stolt migration, plain PyTorch.

Port of the parts of :mod:`qups_tpu.ops.fdbf` and of the host/XLA glue of
:mod:`qups_tpu.ops.fdbf_pallas` that the plane-wave imaging path runs:

* :func:`spectral_level`, :func:`geom_delays`, :func:`select_fbins`;
* :func:`focus_tx_freq`, the per-bin transmit GEMM of ``focusTx`` (XLA code
  in the JAX package, so ``torch.fft`` and ``torch.einsum`` here);
* :func:`prep_spectra` and :func:`tx_spectra`, the adjoint's spectra (the
  counterparts of ``fdbf_pallas._prep_spectra`` and ``_pack``);
* :func:`bf_adjoint`, the plain version of kernel K4
  (:mod:`qups_tpu_torch.ops.fdbf_cuda`): a Python loop over the selected
  bins. Its phasors are built as ``2 pi frac(f_k tau)``, as the TPU kernel
  builds them, so that K4 and this function build the same angle;
* :func:`refocus_op`, :func:`refocus_apply` and :func:`refocus`, the REFoCUS
  decode of synthesized transmits back to FSA (per bin, the whitened inverse
  of the encoding by ``torch.linalg``, then one transmit GEMM per bin);
* :func:`stolt_migration`, Stolt f-k migration of plane-wave data.

These four are XLA code in the JAX package (no ``pallas_call``), so they are
``torch.fft``, ``torch.linalg`` and ``einsum`` here. Each runs on ``device``
(default: the CUDA device; it raises without one) and takes trailing frame
dims, which the JAX functions do not; each frame equals the JAX output on
that frame alone.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils.backend import as_f32, default_device
from .interp import expand_trailing, interp1

_TWO_PI = 6.283185307179586
PRECISIONS = ("bf16", "f32")


def spectral_level(x: torch.Tensor) -> torch.Tensor:
    """Per-bin spectral level in dB, the max over all traces: (T,) float32
    on the device of ``x (T, ...)``."""
    T = x.shape[0]
    mag = torch.fft.fft(x, dim=0).abs().reshape(T, -1).amax(dim=1)
    return 20.0 * torch.log10(mag + 1e-30)


def geom_delays(pi, pos, cinv, device=None) -> torch.Tensor:
    """Geometric delay table ``|pi - pos| * cinv`` (I, E), float32, built on
    ``device`` (default: the CUDA device) from pixels (I, 3) and element
    positions (E, 3): only the small position arrays cross from the host. A
    float64 host table of size (1e6, 256) would cost seconds of host work and
    GBs of upload per call."""
    device = default_device(device)
    pi, pos = as_f32(pi, device), as_f32(pos, device)
    d = pi[:, None, :] - pos[None]
    return torch.sqrt((d * d).sum(-1)) * float(np.float32(cinv))


def select_fbins(x, fs: float, fthresh_db: float = -math.inf,
                 max_bins: Optional[int] = None) -> np.ndarray:
    """Positive-frequency bins within ``fthresh_db`` of the spectral peak,
    as int32 host indices. The spectral level is computed on the device of
    ``x``; one (T,) vector comes back to the host."""
    x = torch.as_tensor(x)
    lev = spectral_level(x).cpu().numpy().astype(np.float64)
    lev = lev - lev.max()
    f = np.fft.fftfreq(x.shape[0]) * fs
    sel = np.where((lev >= fthresh_db) & (f >= 0) & (f < fs / 2))[0]
    if max_bins is not None and sel.size > max_bins:
        keep = np.argsort(lev[sel])[::-1][:max_bins]
        sel = np.sort(sel[keep])
    return sel.astype(np.int32)


def _cexp(th: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(th), torch.sin(th))


def focus_tx_freq(x: torch.Tensor, t2, w, *, fs: float) -> torch.Tensor:
    """Frequency-domain transmit synthesis
    ``y[t, n, m'] = sum_m w[m, m'] x(t + t2[m, m'], n, m)`` as one transmit
    GEMM per bin, ``Y_k = X_k H_k`` with ``H_k = w e^{+2 i pi f_k t2}``
    (band-limited interpolation). ``x (T, N, M, *F)`` real or complex,
    already zero-padded so that the shifted support stays in [0, T);
    ``t2, w (M, M')``. Returns ``(T, N, M', *F)``, real when ``x`` is."""
    dev = x.device
    T = x.shape[0]
    t2, w = as_f32(t2, dev), as_f32(w, dev)
    cplx = x.is_complex()
    if cplx:
        f = torch.fft.fftfreq(T, device=dev) * fs
        X = torch.fft.fft(x, dim=0)
    else:
        f = torch.fft.rfftfreq(T, device=dev) * fs
        X = torch.fft.rfft(x, dim=0)
    H = w[None] * _cexp((2 * np.pi) * f[:, None, None] * t2[None])  # (K, M, M')
    Y = torch.einsum("knm...,kmp->knp...", X, H.to(X.dtype))
    if cplx:
        return torch.fft.ifft(Y, dim=0)
    return torch.fft.irfft(Y, n=T, dim=0)


def fvalues(sel: np.ndarray, T: int, fs: float, device) -> torch.Tensor:
    """Bin frequencies ``sel * (fs / T)`` [Hz], float32 on ``device``."""
    return torch.as_tensor(np.asarray(sel, np.int64), device=device).to(
        torch.float32) * float(np.float32(fs / T))


def prep_spectra(x: torch.Tensor, t0, t0_off, sel: np.ndarray, *, fs: float,
                 fmod: float = 0.0) -> torch.Tensor:
    """Channel spectra at the selected bins, ``X_k (K, N, V)`` complex64:
    optional remodulation at ``fmod``, FFT over time, the bin gather, and
    the phase correction ``e^{-2 i pi f_k (t0 - t0_off)}`` per pulse."""
    dev = x.device
    T, V = x.shape[0], x.shape[2]
    t0 = as_f32(t0, dev).reshape(-1).expand(V)
    t0o = as_f32(t0_off, dev).reshape(-1).expand(V)
    xr = x
    if fmod:
        t = torch.arange(T, dtype=torch.float32, device=dev)[:, None, None] / fs
        xr = x * _cexp((2 * np.pi * fmod) * (t + t0[None, None, :]))
    X = torch.fft.fft(xr, dim=0)
    idx = torch.as_tensor(np.asarray(sel, np.int64), device=dev)
    fk = fvalues(sel, T, fs, dev)[:, None, None]
    return (X.index_select(0, idx).to(torch.complex64)
            * _cexp((-2 * np.pi) * fk * (t0 - t0o)[None, None, :]))


def tx_spectra(del_tx, apod_tx, fk: torch.Tensor) -> torch.Tensor:
    """Per-bin transmit spectra ``S_k = apod e^{+2 i pi f_k del_tx}``
    (K, M, V) complex64 on the device of ``fk``."""
    dev = fk.device
    d, a = as_f32(del_tx, dev), as_f32(apod_tx, dev)
    return a[None] * _cexp((2 * np.pi) * fk[:, None, None] * d[None])


def phasor(fk: torch.Tensor, tau: torch.Tensor, sign: float) -> torch.Tensor:
    """``e^{sign 2 i pi f_k tau}`` with the angle built as
    ``2 pi frac(f_k tau)``, as K4 (and the TPU kernel) build it."""
    u = fk * tau
    th = (u - torch.floor(u)) * _TWO_PI
    return torch.complex(torch.cos(th), sign * torch.sin(th))


def round_operand(z: torch.Tensor, precision: str) -> torch.Tensor:
    """Round both parts of ``z`` to bfloat16 (``'bf16'``), back in float32."""
    if precision == "f32":
        return z
    return torch.complex(z.real.to(torch.bfloat16).float(),
                         z.imag.to(torch.bfloat16).float())


def cmatmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """Complex product ``a @ b`` of a dot of K4: its operands rounded to
    bfloat16 for ``'bf16'``, the products summed in float32 (real GEMMs, so
    that no TF32 or reduced-precision path enters)."""
    a, b = round_operand(a, precision), round_operand(b, precision)
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)


def keep_mode(keep_rx: bool, keep_tx: bool) -> str:
    if keep_rx and keep_tx:
        raise ValueError("keep_rx and keep_tx are mutually exclusive here")
    return "rx" if keep_rx else ("tx" if keep_tx else "")


def adjoint_spectra(x, del_tx, apod_tx, t0, t0_off, fbins, *, fs: float,
                    fmod: float = 0.0):
    """The host/XLA glue shared by K4 and its plain version: the selected
    bins without the padding (entries < 0), their frequencies ``fk (K,)``,
    the channel spectra ``X_k (K, N, V)`` and the transmit spectra
    ``S_k (K, M, V)``; ``None`` for an empty bin set."""
    sel = np.asarray(fbins, np.int64).reshape(-1)
    sel = sel[sel >= 0]
    if sel.size == 0:
        return None
    fk = fvalues(sel, x.shape[0], fs, x.device)
    Xk = prep_spectra(x, t0, t0_off, sel, fs=fs, fmod=fmod)
    return sel, fk, Xk, tx_spectra(del_tx, apod_tx, fk)


def bf_adjoint(x: torch.Tensor, tau_rx, tau_tx, del_tx, apod_tx, t0, t0_off,
               fbins, *, fs: float, fmod: float = 0.0, keep_rx: bool = False,
               keep_tx: bool = False, precision: str = "f32") -> torch.Tensor:
    """Frequency-domain adjoint beamformer, the plain version of K4. For
    each selected DFT bin k (frequency f_k = k fs / T):

        A(i, v)  = sum_m e^{-2 i pi f_k tau_tx[i, m]} S_k[m, v]
        Ahat     = A / ||A(i, :)||
        y(i, v)  = sum_n e^{+2 i pi f_k tau_rx[i, n]} X_k[n, v]
        b(i)    += sum_v y(i, v) conj(Ahat(i, v))

    (keep_rx keeps n: ``b(i, n) += e^{..tau_rx} sum_v X_k[n, v]
    conj(Ahat)``; keep_tx keeps v). ``x (T, N, V)``; ``tau_rx (I, N)``,
    ``tau_tx (I, M)`` [s]; ``del_tx, apod_tx (M, V)``; ``t0`` scalar or
    (V,); ``t0_off (V,)``; ``fbins`` int bin indices, entries < 0 are
    padding and skipped. ``precision``: 'f32', or 'bf16' (the operands of
    the three dots rounded to bfloat16, sums in float32, as the TPU kernel's
    dots). Returns complex64 (I,), (I, N) or (I, V) on the device of ``x``.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    keep = keep_mode(keep_rx, keep_tx)
    spec = adjoint_spectra(x, del_tx, apod_tx, t0, t0_off, fbins, fs=fs,
                           fmod=fmod)
    if spec is None:
        I = np.shape(tau_rx)[0]
        N, V = x.shape[1], x.shape[2]
        shape = (I, N) if keep == "rx" else ((I, V) if keep == "tx" else (I,))
        return torch.zeros(shape, dtype=torch.complex64, device=x.device)
    _, fk, Xk, Sk = spec
    return adjoint_sum(fk, Xk, Sk, tau_rx, tau_tx, keep=keep, precision=precision)


def adjoint_sum(fk: torch.Tensor, Xk: torch.Tensor, Sk: torch.Tensor, tau_rx, tau_tx, *,
                keep: str, precision: str) -> torch.Tensor:
    """The bin loop of :func:`bf_adjoint` from its spectra (``fk``, ``X_k``,
    ``S_k`` of :func:`adjoint_spectra`) for the pixels of ``tau_rx (I, N)``,
    ``tau_tx (I, M)``, on the device of ``Xk``. Each pixel's sum depends on
    its own table rows only."""
    dev = Xk.device
    N, V = Xk.shape[1], Xk.shape[2]
    tau_rx, tau_tx = as_f32(tau_rx, dev), as_f32(tau_tx, dev)
    I = tau_rx.shape[0]
    shape = (I, N) if keep == "rx" else ((I, V) if keep == "tx" else (I,))
    out = torch.zeros(shape, dtype=torch.complex64, device=dev)
    for k in range(fk.shape[0]):
        A = cmatmul(phasor(fk[k], tau_tx, -1.0), Sk[k], precision)  # (I, V)
        nrm = torch.sqrt((A.real * A.real + A.imag * A.imag).sum(1, keepdim=True))
        Ah = A * (1.0 / torch.where(nrm == 0, torch.ones_like(nrm), nrm))
        Wrx = phasor(fk[k], tau_rx, 1.0)  # (I, N)
        if keep == "rx":
            out += Wrx * cmatmul(Ah.conj(), Xk[k].T, precision)
        else:
            y = cmatmul(Wrx, Xk[k], precision) * Ah.conj()
            out += y if keep == "tx" else y.sum(1)
    return out


# --------------------------------------------------------------- REFoCUS
def fftfreq32(T: int, fs: float) -> np.ndarray:
    """``fftfreq(T) * fs`` in float32, rounded as the JAX package rounds it
    (the integer bins over ``T``, then the product with ``fs``)."""
    n = np.arange(T)
    k = np.where(n < (T + 1) // 2, n, n - T).astype(np.float32)
    return (k / np.float32(T)) * np.float32(fs)


def nan_to_num_(z: torch.Tensor) -> torch.Tensor:
    """``jnp.nan_to_num`` of a complex tensor, in place, on each part: NaN
    to 0, +-inf to the largest finite float32 of its sign."""
    torch.view_as_real(z).nan_to_num_()
    return z


def refocus_op(tau, apd, *, T: int, fs: float, gamma: Optional[float] = None,
               method: str = "tikhonov", f=None, device=None) -> torch.Tensor:
    """The data-independent REFoCUS decode operator ``Hi (K, M, V)``
    complex64 on ``device`` (default: the CUDA device): per frequency, the
    whitened inverse of the encoding ``H[v, m] = apd[m, v] exp(+2 i pi f
    tau[m, v])`` of the delays and apodization ``tau, apd (M, V)``
    (``UltrasoundSystem.m:3696-3719``). ``method``: 'tikhonov'
    ``(H^H H + gamma w I) \\ H^H``, 'adjoint' ``w H^H`` or 'pinv'
    ``w pinv(H)``, with ``w = 1 / ||H||_2^2`` per bin and ``gamma``
    (default ``10 (M / 10)^2``). ``f``: optional frequencies (K,) [Hz] in
    place of ``fftfreq(T) * fs``. NaN and inf are cleaned as
    ``jnp.nan_to_num`` cleans them.

    The spectral norm is the largest singular value of each bin's ``H``
    (:func:`spectral_norm`, from the Gram matrix), as the JAX package's
    ``matrix_norm(H, ord=2)``. Tikhonov with ``gamma == 0`` needs no norm and computes none;
    it then differs from the JAX package only at a bin whose encoding has a
    norm below 5e-20, which JAX's NaN turns into zeros. The solve is LU
    (``torch.linalg.solve_ex``, which does not wait on the card to check
    for a singular system: a singular bin gives what LAPACK gives, cleaned
    as above)."""
    if method not in ("tikhonov", "adjoint", "pinv"):
        raise ValueError(method)
    dev = default_device(device)
    M = np.shape(tau)[0]
    if gamma is None:
        gamma = 10.0 * (M / 10.0) ** 2
    f = fftfreq32(T, fs) if f is None else np.asarray(f, np.float32).reshape(-1)
    f = torch.as_tensor(f, device=dev)
    tauT, aT = as_f32(tau, dev).T, as_f32(apd, dev).T  # (V, M)
    H = aT[None] * _cexp((2 * np.pi) * f[:, None, None] * tauT[None])  # (K, V, M)
    A = torch.matmul(H.conj().transpose(1, 2), H) if method == "tikhonov" else None
    w = None if method == "tikhonov" and gamma == 0 else \
        1.0 / torch.clamp(spectral_norm(H, A), min=1e-30) ** 2  # (K,)
    if method == "tikhonov":  # A = H^H H (K, M, M)
        if gamma != 0:
            A.diagonal(dim1=1, dim2=2).add_((gamma * w)[:, None])
        Hi = torch.linalg.solve_ex(A, H.conj().transpose(1, 2))[0]  # (K, M, V)
    elif method == "adjoint":
        Hi = H.conj().transpose(1, 2) * w[:, None, None]
    else:
        rtol = 10 * max(H.shape[1:]) * float(np.finfo(np.float32).eps)
        Hi = torch.linalg.pinv(H, rtol=rtol) * w[:, None, None]
    return nan_to_num_(Hi.contiguous())


def spectral_norm(H: torch.Tensor, gram: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``||H_k||_2`` of each matrix of ``H (K, V, M)``, its largest singular
    value: the square root of the largest eigenvalue of the smaller Gram
    matrix (``H^H H`` or ``H H^H``; ``gram``, if given, is ``H^H H``), by
    ``torch.linalg.eigvalsh``. This is exact and holds for rank-deficient
    bins (a plane-wave encoding at f = 0 has rank 1), where cuSOLVER's
    batched ``gesvda`` stops with an error; torch's default SVD on a CUDA
    device runs a Jacobi SVD per bin whose stopping tolerance leaves the
    norm ~2e-4 off."""
    V, M = H.shape[1], H.shape[2]
    if V >= M:
        G = gram if gram is not None else torch.matmul(H.conj().transpose(1, 2), H)
    else:
        G = torch.matmul(H, H.conj().transpose(1, 2))
    return torch.sqrt(torch.linalg.eigvalsh(G)[:, -1].clamp(min=0))


def refocus_apply(x, Hi: torch.Tensor, t0, *, fs: float, device=None):
    """Apply a :func:`refocus_op` operator to ``x (T, N, V, *F)`` on
    ``device`` (default: the CUDA device): FFT over time, the phase of each
    pulse's ``t0``, the per-bin transmit GEMM ``Y_k = X_k Hi_k^T``, the
    phase of the least ``t0``, inverse FFT (``UltrasoundSystem.m:3736-3767``).
    Returns ``(y (T, N, M, *F) complex64, t0min)``."""
    dev = default_device(device)
    x = torch.as_tensor(x).to(dev)
    T, nd = x.shape[0], x.ndim
    V = Hi.shape[2]
    f = torch.as_tensor(fftfreq32(T, fs), device=dev)
    t0 = np.asarray(t0, np.float32).reshape(-1)
    t0v = torch.as_tensor(np.broadcast_to(t0, (V,)).copy(), device=dev)
    X = torch.fft.fft(x, dim=0)
    X = X * expand_trailing(_cexp((-2 * np.pi) * f[:, None, None] * t0v[None, None, :]), nd)
    Y = torch.einsum("kmv,knv...->knm...", Hi.to(dev), X)
    t0min = float(t0.min())
    Y = Y * expand_trailing(_cexp((2 * np.pi) * f[:, None, None] * t0min), nd)
    return torch.fft.ifft(Y, dim=0), t0min


def refocus(x, tau, apd, t0, *, fs: float, gamma: Optional[float] = None,
            method: str = "tikhonov", device=None):
    """REFoCUS: decode synthesized-transmit data ``x (T, N, V, *F)`` back to
    FSA (``UltrasoundSystem.m:3696-3767``): :func:`refocus_op` of the
    element delays and apodization ``tau, apd (M, V)``, then
    :func:`refocus_apply`, on ``device`` (default: the CUDA device).
    Returns ``(y (T, N, M, *F), t0min)``; the output time axis is the
    input's, started at the least ``t0``.

    Example:
        import numpy as np, torch
        from qups_tpu_torch.ops.fdbf import refocus
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.standard_normal((64, 3, 4)).astype(np.float32))
        had = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]], float)
        y, _ = refocus(x, np.zeros((4, 4)), had, 0.0, fs=20e6, gamma=0.0, device="cpu")
        enc = torch.einsum("tnm,mv->tnv", y.real, torch.as_tensor(had, dtype=torch.float32))
        assert float((enc - x).abs().max()) < 1e-4 * float(x.abs().max())
    """
    T = np.shape(x)[0]
    Hi = refocus_op(np.asarray(tau, np.float32), np.asarray(apd, np.float32), T=int(T),
                    fs=fs, gamma=gamma, method=method, device=device)
    return refocus_apply(x, Hi, t0, fs=fs, device=device)


# --------------------------------------------------------- Stolt migration
def stolt_migration(x, t0, del_tx, angles_deg, *, fs: float, c0: float, pitch: float,
                    fmod: float = 0.0, keep_tx: bool = False, method: str = "cubic",
                    jacobian: bool = True, nfft=None, gamma=None,
                    device=None) -> torch.Tensor:
    """Stolt f-k migration of plane-wave data on a linear array
    (``UltrasoundSystem.m:4740-4860``) on ``device`` (default: the CUDA
    device): the 2-D FFT (t, x) -> (f, kx) at sizes ``nfft = (F, K)``
    (default ``(T, N)``); the exploding-reflector remap
    ``f -> cs sign(f) sqrt(kx^2 + f^2 / cs^2)``, ``cs = c0 / sqrt(2)``, by
    :func:`~qups_tpu_torch.ops.interp.interp1` (``method``) of the spectrum
    at the fractional bin, with the optional jacobian; Garcia's lateral
    alignment ``gamma = sin(th) / (2 - cos(th))`` per transmit (or the
    given ``gamma (M,)``); the inverse FFTs.

    ``x (T, N, M, *F)``; ``t0`` scalar or (M,); ``del_tx (N, M)`` the
    sequence delays; ``angles_deg`` (M,). Returns the complex64 image
    ``(T, N, M', *F)`` on the (z = c0 t / 2, x = element) grid, ``M' = M``
    with ``keep_tx``, else 1. ``out='ri'`` of the JAX function is TPU-only
    and not ported."""
    dev = default_device(device)
    x = torch.as_tensor(x).to(dev)
    T, N, M = x.shape[:3]
    nd = x.ndim
    F, K = nfft if nfft is not None else (T, N)
    # the remap and time grids are float32 host arithmetic in the JAX
    # package's order: the remap is steep in float32 (the spectrum turns by
    # radians a bin), and torch on a CUDA device divides by a scalar as a
    # product with its reciprocal, which would move the bins by roundings
    f32 = np.float32
    cs = f32(c0 / np.sqrt(2.0))
    f = ((np.arange(F) - F // 2) / F * fs).astype(f32)  # centered
    kx = ((np.arange(K) - K // 2) / K / pitch).astype(f32)
    t0h = np.broadcast_to(np.asarray(t0, f32).reshape(-1), (M,))[None, None, :]  # (1, 1, M)
    fkz = cs * np.sign(f[:, None, None]) * np.sqrt(
        kx[None, :, None] * kx[None, :, None] + (f[:, None, None] / cs) ** 2)  # (F, K, 1)
    kkz = (fkz - f[0]) * f32(F) / f32(fs)  # 0-based fractional bin index
    t = np.arange(T, dtype=f32)[:, None, None] / f32(fs) + t0h
    tb = np.arange(F, dtype=f32)[:, None, None] / f32(fs) + t0h
    fj = torch.as_tensor(f, device=dev)[:, None, None]
    kxj = torch.as_tensor(kx, device=dev)[None, :, None]
    t0 = torch.as_tensor(t0h.copy(), device=dev)
    dl = as_f32(del_tx, dev)[None]  # (1, N, M)
    t = torch.as_tensor(t, device=dev)

    xr = x * expand_trailing(_cexp((2 * np.pi * fmod) * t), nd)
    Xf = torch.fft.fftshift(torch.fft.fft(xr, n=F, dim=0), dim=0)
    Xf = Xf * expand_trailing(_cexp((-2 * np.pi) * fj * t0), nd)
    Xf = Xf * expand_trailing(_cexp((-2 * np.pi) * fj * dl), nd)
    Xk = torch.fft.fftshift(torch.fft.fft(Xf, n=K, dim=1), dim=1)
    del xr, Xf

    y = interp1(Xk, torch.as_tensor(kkz, device=dev).expand(F, K, M), method=method)
    del Xk
    if jacobian:
        y = y * expand_trailing(torch.as_tensor(f[:, None, None] / cs, device=dev), nd)
        den = expand_trailing(torch.as_tensor(fkz + f32(1e-30), device=dev), nd)
        y = torch.complex(y.real / den, y.imag / den)  # each part over the real divisor
    y = y * expand_trailing(_cexp((2 * np.pi) * fj * t0), nd)
    b = torch.fft.ifft(torch.fft.ifftshift(y, dim=0), n=F, dim=0)
    del y
    if gamma is None:
        th = np.radians(np.asarray(angles_deg, np.float64))
        gamma = (np.sin(th) / (2 - np.cos(th))).astype(np.float32)  # (M,)
    g = as_f32(gamma, dev).reshape(-1)[None, None, :]
    zax = c0 / 2 * torch.as_tensor(tb, device=dev)  # (F, 1, M)
    b = b * expand_trailing(_cexp((2 * np.pi) * kxj * g * zax), nd)
    b = torch.fft.ifft(torch.fft.ifftshift(b, dim=1), n=K, dim=1)
    b = b[:T, :N]
    if not keep_tx:
        b = b.sum(dim=2, keepdim=True)
    return b
