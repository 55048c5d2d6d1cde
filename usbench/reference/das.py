"""Delay-and-sum at chosen pixels, plain PyTorch.

For pixel p, plane wave m (direction n_m, through the origin) and receive
element e at r_e, on traces that start at t0 and are sampled at fs:

    tau  = (1 / c0) * ((p . n_m) + |p - r_e|) - t0          [s]
    t    = tau * fs                                          [samples]
    y_p += exp(2j pi fmod tau) * x_{e,m}(t)

with ``x(t)`` the Catmull-Rom cubic through the four samples around t
(the sample index clamped to the trace), and 0 for t outside [0, T - 1].
The dot product and the norm are summed left to right over (x, y, z), and
every step of tau, t and the phase ``float32(2 pi fmod) * tau`` is a
float32 operation, as the configurations state; the cubic's weights, the
taps, the rotation and the sums are float64 (complex128).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .geometry import elements, pixel_positions, plane_waves


def catmull_rom(u: torch.Tensor):
    """The four Catmull-Rom weights of fraction ``u`` (float64), for the
    samples at floor(t) - 1 ... floor(t) + 2."""
    return (0.5 * u * (-1.0 + u * (2.0 - u)),
            0.5 * (2.0 + u * u * (-5.0 + 3.0 * u)),
            0.5 * u * (1.0 + u * (4.0 - 3.0 * u)),
            0.5 * u * u * (u - 1.0))


def das_at(taps: Callable[[int], torch.Tensor], pix: np.ndarray, ele: np.ndarray,
           dirs: np.ndarray, *, T: int, t0: float, c0: float, fs: float, fmod: float = 0.0,
           device="cpu") -> torch.Tensor:
    """The summed image at pixels ``pix`` (K, 3): (K, F) float64, or
    complex128 where the traces are complex or ``fmod != 0``.

    ``taps(m)`` returns transmit m's traces (T, N, F) as float64 or
    complex128 on ``device``; ``ele`` (N, 3), ``dirs`` (M, 3) float32."""
    f32 = dict(dtype=torch.float32, device=device)
    p = torch.as_tensor(np.asarray(pix, np.float32), **f32)
    e = torch.as_tensor(np.asarray(ele, np.float32), **f32)
    d = torch.as_tensor(np.asarray(dirs, np.float32), **f32)
    cinv = torch.tensor(1.0, **f32) / torch.tensor(float(c0), **f32)
    t0v = torch.tensor(float(t0), **f32)
    fsv = torch.tensor(float(fs), **f32)
    w = torch.tensor(float(np.float32(2 * math.pi * fmod)), **f32)
    dx, dy, dz = (p[:, None, k] - e[None, :, k] for k in range(3))
    dr = torch.sqrt((dx * dx + dy * dy) + dz * dz)  # (K, N)
    n_idx = torch.arange(e.shape[0], device=device)[None, :]
    out = None
    for m in range(d.shape[0]):
        x = taps(m)  # (T, N, F)
        dv = (p[:, 0] * d[m, 0] + p[:, 1] * d[m, 1]) + p[:, 2] * d[m, 2]  # (K,)
        tau = cinv * (dv[:, None] + dr) - t0v
        t = tau * fsv
        valid = (t >= 0) & (t <= T - 1)
        base = torch.floor(t)
        u = (t - base).double()
        b = base.long() - 1
        v = None
        for k, wk in enumerate(catmull_rom(u)):
            s = x[torch.clamp(b + k, 0, T - 1), n_idx]  # (K, N, F)
            v = s * wk[..., None] if v is None else v + s * wk[..., None]
        v = torch.where(valid[..., None], v, torch.zeros((), dtype=v.dtype, device=device))
        if fmod != 0.0:
            ph = (w * tau).double()
            v = v * torch.polar(torch.ones_like(ph), ph)[..., None]
        s = v.sum(1)
        out = s if out is None else out + s
    return out


def das_image(cfg: dict, x: torch.Tensor, idx: np.ndarray, *, t0: float, fmod: float = 0.0,
              prep: Callable = None, taps: Callable = None) -> np.ndarray:
    """The summed image (K, F) of a configuration's traces ``x`` (T, N, M[,
    F]), starting at ``t0``, at flat pixel indices ``idx``: each transmit's
    traces through ``prep`` (default: to float64 / complex128), then
    ``taps`` (a control's rounding), on ``x``'s device."""
    T, N = x.shape[:2]

    def tx(m: int) -> torch.Tensor:
        xm = x[:, :, m].reshape(T, N, -1)
        if prep is None:
            xm = xm.to(torch.complex128 if xm.is_complex() else torch.float64)
        else:
            xm = prep(xm)
        return xm if taps is None else taps(xm)

    with torch.no_grad():
        out = das_at(tx, pixel_positions(cfg, idx), elements(cfg), plane_waves(cfg), T=T,
                     t0=t0, c0=float(cfg["c0"]), fs=float(cfg["fs"]), fmod=fmod,
                     device=x.device)
    return out.cpu().numpy()
