"""Frequency-domain beamforming: transmit synthesis and the adjoint
beamformer, plain PyTorch.

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
  builds them, so that K4 and this function build the same angle.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils.backend import as_f32, default_device

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
    dev = x.device
    N, V = x.shape[1], x.shape[2]
    tau_rx, tau_tx = as_f32(tau_rx, dev), as_f32(tau_tx, dev)
    I = tau_rx.shape[0]
    shape = (I, N) if keep == "rx" else ((I, V) if keep == "tx" else (I,))
    out = torch.zeros(shape, dtype=torch.complex64, device=dev)
    spec = adjoint_spectra(x, del_tx, apod_tx, t0, t0_off, fbins, fs=fs,
                           fmod=fmod)
    if spec is None:
        return out
    _, fk, Xk, Sk = spec
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
