"""Point-scatterer echoes, plain PyTorch in float64: the Green's-function
simulation of full synthetic-aperture data and the synthesis of plane-wave
transmits from it, in the band-limited (Fourier) semantics the
configuration states.

Pulse. Each element's impulse response is the complex Gaussian pulse

    g(t) = exp(-t^2 q) exp(2j pi fc t),  q = pi^2 bw^2 fc^2 / (-2 ln 10^(bwr/20))

(bw the fractional band, bwr = -6 dB), cut where its envelope falls to
-80 dB, |t| <= tc. The echo kernel is the transmit and the receive response
convolved as a plain sum on the grid k / fs (no dt factor),
``h(t) = sum_k g(t - k/fs) g(k/fs)``, supported on [-2 tc, 2 tc], sampled at
``floor(-2 tc fs) / fs ... ceil(2 tc fs) / fs`` and placed at ``t0k = -2 tc``.

Echoes. For scatterers s (amplitude a_s), receive element n, transmit
element m, with r1 = |p_s - e_n|, r2 = |p_s - e_m|, R0 one wavelength:

    x[j, n, m] = sum_s a_s / (max(r1, R0) max(r2, R0))
                 * h_L(j + (s0 - t0k) fs - (r1 + r2) fs / c0)

on samples j = 0 .. T - 1 from ``s0``, where ``h_L`` is the L-periodic
band-limited interpolant of h's samples (each bin of an L-point real FFT
delayed by its phase ramp; real and imaginary parts of h apart). The
window (s0, T) and the FFT length L (a power of two past the last echo, so
that nothing wraps into the window) follow from the bounding boxes of the
scatterers and the elements.

Plane waves. With tau[m, w] = (e_m . u_w) / c0 the delay of element m in
plane wave w (direction u_w), shifted so its least whole-sample part is 0,
``nmin = floor(min tau fs)``, ``pad = ceil(max tau fs) - nmin``:

    y[., n, w] = sum_m x(. - tau[m, w] + nmin / fs, n, m)

band-limited on the traces zero-padded by ``pad`` samples (their own FFT
length T + pad), starting at ``t0 = float32(s0) + float32(nmin / fs)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2 * math.pi


def gauspuls(fc: float, bw: float, bwr: float = -6.0, tpr: float = -80.0):
    """(g(t) as a function of float64 arrays, tc)."""
    q = (4 * math.pi ** 2 * (-(bw ** 2) * fc ** 2 / (8 * math.log(10 ** (bwr / 20))))) / 2
    tc = math.sqrt(-math.log(10 ** (tpr / 20)) / q)

    def g(t):
        t = np.asarray(t, np.float64)
        v = np.exp(-t * t * q) * np.exp(2j * math.pi * fc * t)
        tol = 1e-9 * (2 * tc) + 1e-300
        return np.where((-tc - tol <= t) & (t <= tc + tol), v, 0.0)

    return g, tc


def echo_kernel(fc: float, bw: float, fs: float):
    """(h's samples (K,) complex128, t0k)."""
    g, tc = gauspuls(fc, bw)
    k = np.arange(math.floor(-2 * tc * fs), math.ceil(2 * tc * fs) + 1) / fs
    t = np.arange(math.floor(-2 * tc * fs), math.ceil(2 * tc * fs) + 1) / fs
    h = np.sum(g(t[:, None] - k[None, :]) * g(k)[None, :], axis=-1)
    return h, -2 * tc


def box_bounds(pa: np.ndarray, pb: np.ndarray):
    """(least, largest) distance between the bounding boxes of two point
    sets (P, 3): bounds of every pairwise distance."""
    pa, pb = np.asarray(pa, np.float64), np.asarray(pb, np.float64)
    alo, ahi, blo, bhi = pa.min(0), pa.max(0), pb.min(0), pb.max(0)
    gap = np.maximum(0.0, np.maximum(blo - ahi, alo - bhi))
    span = np.maximum(bhi - alo, ahi - blo)
    return float(np.linalg.norm(gap)), float(np.linalg.norm(span))


def window(ps, ele, fc: float, bw: float, fs: float, c0: float):
    """The traces' window: (T, s0, h, t0k, L)."""
    h, t0k = echo_kernel(fc, bw, fs)
    lo, hi = box_bounds(ps, ele)
    dur = -2 * t0k
    n0 = math.floor((2 * lo / c0 + t0k - dur) * fs)
    T = math.ceil((2 * hi / c0 - t0k) * fs) - n0 + 1
    s0 = n0 / fs
    lo32, hi32 = box_bounds(np.float32(ps), np.float32(ele))
    dc = (t0k - s0) * fs
    dmin = (1.0 / c0) * (2 * lo32) * fs + dc
    dmax = (1.0 / c0) * (2 * hi32) * fs + dc
    L = int(max(T, dmax + len(h) + 8, T - min(0.0, dmin) + 8))
    return T, s0, h, t0k, 1 << int(math.ceil(math.log2(max(2, L))))


def fsa_echoes(ps, amp, ele, *, fc: float, bw: float, fs: float, c0: float, R0: float,
               device="cpu", bins_a_block: int = 16):
    """The full synthetic-aperture echoes (T, N, N) complex128 of scatterers
    ``ps`` (S, 3) with amplitudes ``amp`` (S,) on elements ``ele`` (N, 3),
    and their start time s0."""
    T, s0, h, t0k, L = window(ps, ele, fc, bw, fs, c0)
    dc = (t0k - s0) * fs
    kb = np.arange(L // 2 + 1)
    ramp = np.exp(-2j * math.pi * kb * dc / L)
    Kr = torch.as_tensor(np.fft.rfft(h.real, n=L) * ramp, device=device)
    Ki = torch.as_tensor(np.fft.rfft(h.imag, n=L) * ramp, device=device)
    p = torch.as_tensor(np.asarray(ps, np.float64), device=device)
    e = torch.as_tensor(np.asarray(ele, np.float64), device=device)
    r = torch.sqrt(((p[:, None, :] - e[None, :, :]) ** 2).sum(-1))  # (S, N)
    w = 1.0 / torch.clamp(r, min=R0)
    a = torch.as_tensor(np.asarray(amp, np.float64), device=device)
    cyc = r * (fs / (c0 * L))  # cycles a bin
    G = torch.empty((L // 2 + 1, e.shape[0], e.shape[0]), dtype=torch.complex128,
                    device=device)
    for k0 in range(0, L // 2 + 1, bins_a_block):
        k = torch.arange(k0, min(k0 + bins_a_block, L // 2 + 1), device=device,
                         dtype=torch.float64)
        ph = torch.polar(w[None].expand(len(k), -1, -1).contiguous(),
                         -TWO_PI * k[:, None, None] * cyc[None])  # (B, S, N)
        G[k0:k0 + len(k)] = torch.bmm(ph.transpose(1, 2), ph * a[None, :, None])
    x = torch.complex(torch.fft.irfft(G * Kr[:, None, None], n=L, dim=0)[:T],
                      torch.fft.irfft(G * Ki[:, None, None], n=L, dim=0)[:T])
    return x, s0


def plane_wave_synthesis(x: torch.Tensor, s0: float, ele, dirs, *, fs: float, c0: float):
    """Plane waves ``dirs`` (W, 3) from FSA echoes ``x`` (T, N, N) starting
    at s0: (y (T + pad, N, W) complex128, t0 float32)."""
    tau = np.asarray(ele, np.float64) @ np.asarray(dirs, np.float64).T / c0  # (M, W)
    nmin = math.floor(tau.min() * fs)
    pad = math.ceil(tau.max() * fs) - nmin
    t2 = -(tau - nmin / fs)
    T2 = x.shape[0] + pad
    xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    f = torch.as_tensor(np.fft.fftfreq(T2) * fs, device=x.device)
    H = torch.exp(1j * TWO_PI * f[:, None, None] * torch.as_tensor(t2, device=x.device)[None])
    Y = torch.bmm(torch.fft.fft(xp, dim=0), H)  # (T2, N, W)
    return torch.fft.ifft(Y, dim=0), float(np.float32(s0) + np.float32(nmin / fs))
