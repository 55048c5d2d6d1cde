"""The analytic signal and the downmix, plain PyTorch in float64.

    analytic(x) = ifft(fft(x) * h),  h = 1, 2, ..., 2, (1), 0, ..., 0
    downmix(z)  = z * exp(-2j pi fc t),  t = t0 + n / fs

along the time axis (axis 0). The time axis and the phase ``-2 pi fc t``
are float32 operations, as the configurations state; the exponential and
the product are complex128.
"""
from __future__ import annotations

import math

import torch


def analytic(x: torch.Tensor) -> torch.Tensor:
    """The analytic signal of real traces ``x`` (T, ...) along axis 0,
    complex128."""
    T = x.shape[0]
    h = torch.zeros(T, dtype=torch.float64, device=x.device)
    h[0] = 1.0
    if T % 2 == 0:
        h[T // 2] = 1.0
        h[1:T // 2] = 2.0
    else:
        h[1:(T + 1) // 2] = 2.0
    X = torch.fft.fft(x.double(), dim=0)
    return torch.fft.ifft(X * h.reshape((-1,) + (1,) * (x.ndim - 1)), dim=0)


def downmix(z: torch.Tensor, fc: float, t0: float, fs: float) -> torch.Tensor:
    """``z`` (T, ...) times exp(-2j pi fc t) on its time axis."""
    n = torch.arange(z.shape[0], dtype=torch.float32, device=z.device)
    t = torch.tensor(float(t0), dtype=torch.float32, device=z.device) + n / fs
    th = (-2 * math.pi * fc * t).double()
    return z * torch.polar(torch.ones_like(th), th).reshape((-1,) + (1,) * (z.ndim - 1))
