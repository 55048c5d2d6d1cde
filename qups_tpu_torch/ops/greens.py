"""Green's-function point-scatterer simulation, plain PyTorch.

Port of :mod:`qups_tpu.ops.greens`. The FSA response is

    x[t, n, m] = sum_s  a_s / (r1' r2' fsr) * wv(t - tau_snm - t0k + s0)

with ``r1 = |p_s - p_rx[n]|``, ``r2 = |p_s - p_tx[m]|``,
``tau_snm = cinv (r1 + r2)``, loss radii clamped at ``R0``, and ``wv`` the
sampled tx pulse (x) tx impulse (x) rx impulse kernel.

* :func:`greens_splat`: each scatterer deposits its sampler weights into
  the (T, N, M) grid (``index_add_``, one block of scatterers at a time),
  then one FFT convolution with the kernel along time.
* :func:`greens_dense`: the direct form, for every output sample the
  kernel interpolated and summed over scatterers. The parity oracle.

In the JAX package both are XLA code, not Pallas kernels, so plain torch is
the faithful port. Everything runs on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from .conv import convd
from .interp import _taps, interp1
from ..utils.backend import as_f32, default_device


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _kern(kern, device) -> torch.Tensor:
    k = np.asarray(kern)
    return torch.as_tensor(k.astype(np.complex64 if np.iscomplexobj(k) else np.float32),
                           device=device)


def greens_splat(kern, ps, amp, pn, pv, *, T: int, s0: float, t0k: float,
                 fs: float, cinv, R0: float, fsr: float = 1.0,
                 method: str = "cubic", block: int = 32, device=None):
    """Scatter-splat + convolve Green's-function FSA simulation.

    Args:
      kern: sampled waveform kernel (K,) at rate ``fsr * fs``, real or
        complex.
      ps: scatterer positions (S, 3); amp: scatterer amplitudes (S,).
      pn: receive (sub)element positions (N, E, 3).
      pv: transmit (sub)element positions (M, E, 3).
      T: output sample count; s0: output start time; t0k: kernel start
        time; fs: output sampling rate; cinv: 1/c0.
      R0: minimum distance for the 1/r loss (0 disables the loss).
      fsr: kernel rate / output rate; for fsr != 1 the kernel is first
        resampled to the output rate.
      method: sampler whose weights are splatted.
      block: scatterers per step (a memory knob).
      device: where the simulated traces live (default: the CUDA device).

    Returns: FSA data (T, N, M), complex64 if ``kern`` or ``amp`` is complex.
    """
    device = default_device(device)
    kern = _kern(kern, device)
    ps = as_f32(ps, device)
    amp_np = np.asarray(amp)
    cplx = kern.is_complex() or np.iscomplexobj(amp_np)
    amp = torch.as_tensor(amp_np.astype(np.complex64 if cplx else np.float32),
                          device=device)
    pn = as_f32(pn, device)
    pv = as_f32(pv, device)
    N, En = pn.shape[:2]
    M, Em = pv.shape[:2]
    S = ps.shape[0]

    if fsr != 1.0:
        Kn = int(np.ceil(kern.shape[0] / fsr))
        kern = interp1(kern, torch.arange(Kn, dtype=torch.float32,
                                          device=device) * fsr, method=method)
    K = kern.shape[0]

    # The grid holds kernel-START weights at index ti + K, padded by K bins
    # on each side; scatterers wholly out of range are masked to zero. It
    # is kept as real (G*N*M, 2) pairs when complex, so the scatter-add is
    # a real index_add_.
    G = T + 2 * K
    grid = torch.zeros((G * N * M, 2) if cplx else (G * N * M,),
                       dtype=torch.float32, device=device)
    nm = (torch.arange(N, device=device)[:, None] * M
          + torch.arange(M, device=device)[None, :])  # (N, M) flat offsets
    for s0b in range(0, S, block):
        psk, ak = ps[s0b:s0b + block], amp[s0b:s0b + block]
        r1 = _norm3(psk[:, None, None, :] - pn[None])  # (B, N, En)
        r2 = _norm3(psk[:, None, None, :] - pv[None])  # (B, M, Em)
        if R0 > 0:
            a1 = 1.0 / torch.clamp(r1, min=R0)
            a2 = 1.0 / torch.clamp(r2, min=R0)
        else:
            a1 = torch.ones_like(r1)
            a2 = torch.ones_like(r2)
        for en in range(En):
            for em in range(Em):
                tau = cinv * (r1[:, :, en, None] + r2[:, None, :, em])  # (B,N,M)
                ti = (tau + t0k - s0) * fs  # fractional output index of kern[0]
                w = ak[:, None, None] * a1[:, :, en, None] * a2[:, None, :, em] / fsr
                w = torch.where((ti > -K - 4) & (ti < T + 4), w,
                                torch.zeros_like(w))
                b, offs, ws, _ = _taps(ti + K, method, G)
                for k, wk in zip(offs, ws):
                    idx = torch.clamp(b + k, 0, G - 1) * (N * M) + nm
                    val = w * wk
                    grid.index_add_(0, idx.reshape(-1),
                                    torch.view_as_real(val).reshape(-1, 2)
                                    if cplx else val.reshape(-1))
    grid = (torch.view_as_complex(grid) if cplx else grid).reshape(G, N, M)
    # convolve along time; x[t] = sum_g grid[g] kern[t + K - g]
    full = convd(grid, kern.reshape(-1, 1, 1), axis=0, shape="full",
                 method="fft" if K > 64 else "direct")
    return full[K:K + T]


def greens_dense(kern, ps, amp, pn, pv, *, T: int, s0: float, t0k: float,
                 fs: float, cinv, R0: float, fsr: float = 1.0,
                 method: str = "cubic", device=None):
    """Direct (oracle) Green's-function simulation: for each output sample,
    rx n and tx m, the sum over scatterers of the kernel sampled at
    ``fsr * (s - (cinv (r1 + r2) + t0k - s0) fs)``. O(T*S*N*M): for tests
    and small sizes. ``device``: default the CUDA device."""
    device = default_device(device)
    kern = _kern(kern, device)
    ps = as_f32(ps, device)
    amp = np.asarray(amp)
    pn = as_f32(pn, device)
    pv = as_f32(pv, device)
    N, En = pn.shape[:2]
    M, Em = pv.shape[:2]
    cplx = kern.is_complex()
    out = torch.zeros((T, N, M), dtype=torch.complex64 if cplx else torch.float32,
                      device=device)
    svec = torch.arange(T, dtype=torch.float32, device=device)
    for p, a in zip(ps, amp):
        for en in range(En):
            for em in range(Em):
                r1 = _norm3(p - pn[:, en, :])  # (N,)
                r2 = _norm3(p - pv[:, em, :])  # (M,)
                tau = cinv * (r1[:, None] + r2[None, :])  # (N, M)
                ti = svec[:, None, None] - (tau + t0k - s0)[None] * fs
                v = interp1(kern, (fsr * ti).reshape(-1), method=method)
                if R0 > 0:
                    att = a.item() / (torch.clamp(r1[:, None], min=R0)
                                      * torch.clamp(r2[None, :], min=R0))
                else:
                    att = a.item() * torch.ones((N, M), device=device)
                out = out + v.reshape(T, N, M) * (att[None] / fsr)
    return out
