"""Frequency-domain point-scatterer simulator with element directivity.

Port of :mod:`qups_tpu.ops.simus`, the native analog of the MUST/SIMUS
interop: single-scattering synthesis in the frequency domain with far-field
element directivity,

    X(f; n, e) = P(f) sum_s a_s D(f, th_es) D(f, th_sn)
                 e^{-2i pi f (r_es + r_sn) / c} / (r_es r_sn)

with ``D(f, th) = sinc(w f sin(th) / c) [cos(th)]`` the rectangular-element
directivity (hard / soft baffle). Per frequency bin this is the complex
``(S, N)^T x (S, E)`` GEMM of kernel K3 with its directivity option, K3(c)
(:func:`qups_tpu_torch.ops.greens_freq_cuda.freq_gemm` with ``s1, s2``),
as the JAX package's fused engine ``simus_spectrum_pallas`` runs it: the
phase slope per unit bin is ``q = sl r`` and the sinc slope ``s = width sl
sin(th)``, with ``sl = fs / (T c0)``, and each bin's angle is
``2 pi frac(k q)``. The selected bins go in contiguous runs; the traces are
the inverse rfft of the runs' spectra times the pulse spectrum.
"""
from __future__ import annotations

import numpy as np
import torch

from . import greens_freq_cuda
from .greens_freq import PRECISIONS, alpha_np_per_bin
from ..utils.backend import as_f32, default_device


def simus_prologue(ps, amp, pn, nn_az, pv, nv_az, widths, sl, *,
                   baffle: str, device):
    """Device-side geometry, as ``qups_tpu.ops.greens_freq_pallas.
    _simus_prologue``: per side the phase slope ``q = sl r`` (S, E, 1), the
    bin-independent weight (1/r, the obliquity ``max(cos th, 0)`` for the
    soft baffle, the amplitudes on the transmit side) (S, E, 1), and the sinc
    slope ``s = width sl sin(th)`` (S, E). Returns ``(q1, w1, s1, q2, w2,
    s2)``, receive side first, float32 on ``device``."""
    ps = as_f32(ps, device)
    amp = as_f32(amp, device)
    widths = as_f32(widths, device)
    sl = torch.tensor(np.float32(sl), device=device)

    def geom(pe, az):
        pe, az = as_f32(pe, device), as_f32(az, device)
        d = ps[:, None, :] - pe[None, :, :]  # (S, E, 3)
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        ca, sa = torch.cos(az), torch.sin(az)
        lat = d[..., 0] * ca[None, :] - d[..., 2] * sa[None, :]
        ax = d[..., 2] * ca[None, :] + d[..., 0] * sa[None, :]
        rr = torch.clamp(r, min=1e-12)
        return r, lat / rr, ax / rr

    r_tx, sth_tx, cth_tx = geom(pv, nv_az)
    r_rx, sth_rx, cth_rx = geom(pn, nn_az)
    w_tx = amp[:, None] / torch.clamp(r_tx, min=1e-6)
    w_rx = 1.0 / torch.clamp(r_rx, min=1e-6)
    if baffle == "soft":
        w_tx = w_tx * torch.clamp(cth_tx, min=0.0)
        w_rx = w_rx * torch.clamp(cth_rx, min=0.0)
    elif baffle != "hard":
        raise ValueError(f"unknown baffle {baffle!r}; expected 'soft' or 'hard'")
    return ((sl * r_rx)[..., None], w_rx[..., None], (widths[1] * sl) * sth_rx,
            (sl * r_tx)[..., None], w_tx[..., None], (widths[0] * sl) * sth_tx)


def _bin_runs(bin_idx, merge_gap: int = 32):
    """Split sorted selected bin indices into contiguous runs; gaps up to
    ``merge_gap`` bins are absorbed (they carry zero spectrum). Returns
    [(k0, k1), ...]."""
    runs = []
    k0 = k = int(bin_idx[0])
    for b in bin_idx[1:]:
        b = int(b)
        if b - k > merge_gap:
            runs.append((k0, k + 1))
            k0 = b
        k = b
    runs.append((k0, k + 1))
    return runs


def _simus_synth(Xs, specs, *, T: int, k0s) -> torch.Tensor:
    """The rfft spectrum from the runs' geometry spectra ``Xs`` (F, N, E)
    times their pulse spectra ``specs`` (F,), then real traces (T, N, E)."""
    shape = tuple(Xs[0].shape[1:])
    full = torch.zeros((T // 2 + 1,) + shape, dtype=torch.complex64,
                       device=Xs[0].device)
    for X, sp, k0 in zip(Xs, specs, k0s):
        full[k0:k0 + X.shape[0]] = X * sp[:, None, None]
    return torch.fft.irfft(full, n=T, dim=0)


def simus_fsa(ps, amp, pn, nn_az, pv, nv_az, widths, spec, bin_idx, *,
              T: int, fs: float, c0: float, baffle: str = "soft",
              precision: str = "highest", alpha0: float = 0.0,
              kernel: str = "auto", device=None) -> torch.Tensor:
    """Frequency-domain FSA synthesis with element directivity.

    Args:
      ps (S, 3): scatterer positions; amp (S,): real amplitudes.
      pn (N, 3): rx element centers; nn_az (N,): element azimuths [rad].
      pv (E, 3): tx element centers; nv_az (E,): azimuths [rad].
      widths (2,): (tx width, rx width) element widths [m].
      spec (F0,): complex pulse spectrum at the selected bins (with the
        start-time phase ramp).
      bin_idx (F0,): rfft bin indices of the selected frequencies.
      T: output samples; fs: sampling rate; c0: sound speed.
      baffle: 'soft' multiplies the obliquity cos(th); 'hard' omits it.
      precision: 'highest' | 'default' (float32) or 'bf16' (the GEMM
        operands rounded to bfloat16, float32 sums).
      alpha0: frequency-linear absorption [dB/cm/MHz] over both legs.
      kernel: 'auto' runs K3 on a CUDA device and its plain version on the
        CPU; 'cuda' requires K3; 'plain' runs the plain version anywhere.
      device: where the traces are computed and returned (default: the
        CUDA device).

    Returns: real (T, N, E) float32 FSA traces on ``device``.
    """
    if kernel not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected {PRECISIONS}")
    device = default_device(device)
    if kernel == "cuda" and device.type != "cuda":
        raise ValueError("kernel='cuda' needs a CUDA device")
    bin_idx = np.asarray(bin_idx, np.int64)
    order = np.argsort(bin_idx)
    bin_idx = bin_idx[order]
    spec = np.asarray(spec, np.complex64)[order]
    if bin_idx.size == 0:
        return torch.zeros((T, np.shape(pn)[0], np.shape(pv)[0]), dtype=torch.float32,
                           device=device)
    sl = np.float32(fs / (T * c0))  # phase slope (/ 2 pi) and sinc slope per bin
    q1, w1, s1, q2, w2, s2 = simus_prologue(ps, amp, pn, nn_az, pv, nv_az, widths,
                                            sl, baffle=baffle, device=device)
    # q = sl r, so the per-bin decay exp(-att r) is exp(-(att / sl) q)
    att = alpha_np_per_bin(alpha0, fs, T) / float(sl) if alpha0 else 0.0
    gemm = greens_freq_cuda.freq_gemm_plain if kernel == "plain" \
        else greens_freq_cuda.freq_gemm
    Xs, specs, k0s = [], [], []
    for k0, k1 in _bin_runs(bin_idx):
        sel = (bin_idx >= k0) & (bin_idx < k1)
        spec_h = np.zeros(k1 - k0, np.complex64)
        spec_h[bin_idx[sel] - k0] = spec[sel]
        specs.append(torch.as_tensor(spec_h, device=device))
        Xs.append(gemm(q1, w1, q2, w2, k0=int(k0), F=int(k1 - k0), att=att,
                       s1=s1, s2=s2, bf16=precision == "bf16"))
        k0s.append(int(k0))
    return _simus_synth(Xs, specs, T=T, k0s=k0s)
