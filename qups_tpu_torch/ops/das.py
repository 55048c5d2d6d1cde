"""Delay-and-sum beamforming, plain PyTorch.

Port of :mod:`qups_tpu.ops.das` (``tx_distance``, ``delay_tables``,
``das``, ``das_lut``). Per pixel i, transmit m, receiver n:

    rv  = pi - pv[m]
    dv  = { dot(rv, nv[m])                      plane waves
          { |rv|                                diverging waves
          { copysign(|rv|, dot(rv, nv[m]))      virtual source
    dr  = |pi - pr[n]|
    tau = cinv * (dv + dr) - t0[m]
    y  += apod(i,n,m) * exp(2j pi fmod tau) * x(tau * fs; n, m)

``das`` is a Python loop over transmits with O(I*N) memory live, on the
device of ``x``; ``das_lut`` is the same loop with the delays read from
tables, ``tau = (tau_tx[i, m] + tau_rx[i, n]) - t0[m]``, and is the plain
version of the K2 kernel (``das_cuda.das_lut_sum``). ``das`` is the plain
version of the K1 kernel
(:mod:`qups_tpu_torch.ops.das_cuda`): the CPU path, and the oracle the
kernel is held to on the card. The dot products and norms are written out
term by term in a fixed order, the same order the kernel uses, so that the
two compute bit-identical delays (the nearest sampler and the validity
edges flip a whole sample on a one-ulp difference).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .interp import expand_trailing, interp1
from ..utils.backend import as_f32, default_device

TX_MODELS = ("plane", "virtual", "diverging")


def _dot3(ax, ay, az, b):
    return ax * b[0] + ay * b[1] + az * b[2]


def tx_distance(pi: torch.Tensor, pv: torch.Tensor, nv: torch.Tensor,
                tx_model: str) -> torch.Tensor:
    """Transmit path length dv (I,) for pixels ``pi (I, 3)`` and one virtual
    source ``pv (3,)`` with normal ``nv (3,)``."""
    rx, ry, rz = pi[:, 0] - pv[0], pi[:, 1] - pv[1], pi[:, 2] - pv[2]
    if tx_model == "plane":
        return _dot3(rx, ry, rz, nv)
    r = torch.sqrt(rx * rx + ry * ry + rz * rz)
    if tx_model == "diverging":
        return r
    if tx_model == "virtual":
        return torch.copysign(r, _dot3(rx, ry, rz, nv))
    raise ValueError(f"unknown tx model {tx_model!r}; expected {TX_MODELS}")


def rx_distance(pi: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """Receive path length dr (I, N) for pixels ``pi (I, 3)`` and
    receivers ``pr (N, 3)``."""
    dx = pi[:, None, 0] - pr[None, :, 0]
    dy = pi[:, None, 1] - pr[None, :, 1]
    dz = pi[:, None, 2] - pr[None, :, 2]
    return torch.sqrt(dx * dx + dy * dy + dz * dz)


def delay_tables(pi, pr, pv, nv, c0: float, tx_model: str = "virtual",
                 device=None):
    """Separable geometric delays ``tau_rx (I, N)`` and ``tau_tx (I, M)`` in
    seconds (no t0 applied), float32 on ``device`` (default: the CUDA
    device)."""
    device = default_device(device)
    pi, pr, pv, nv = (as_f32(a, device) for a in (pi, pr, pv, nv))
    dr = rx_distance(pi, pr)
    dv = torch.stack([tx_distance(pi, pv[m], nv[m], tx_model)
                      for m in range(pv.shape[0])], dim=1)
    return dr / c0, dv / c0


def _lift5(a) -> torch.Tensor:
    """Lift an apodization array to 5 dims ``(I1', I2', I3', N', M')`` by
    appending trailing singletons."""
    if a.ndim > 5:
        raise ValueError(f"apodization must be at most 5-D, got {tuple(a.shape)}")
    return a.reshape(tuple(a.shape) + (1,) * (5 - a.ndim))


def das(x: torch.Tensor, pi, pr, pv, nv, t0, cinv, *, fs: float, apod=(),
        fmod: float = 0.0, tx_model: str = "virtual", keep_rx: bool = False,
        keep_tx: bool = False, method: str = "cubic",
        im_shape: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Delay-and-sum beamform on the device of ``x``.

    Args:
      x: channel data ``(T, N, M, *F)``, real or complex.
      pi: pixel positions ``(I, 3)``.
      pr: receiver positions ``(N, 3)``.
      pv: virtual transmit source positions ``(M, 3)``.
      nv: virtual transmit normals / plane-wave directions ``(M, 3)``.
      t0: data start time per transmit, scalar or ``(M,)``.
      cinv: inverse sound speed, scalar or ``(I,)`` per pixel.
      fs: sampling frequency of ``x``.
      apod: tuple of apodization arrays, each left-aligned broadcastable to
        ``(I1, I2, I3, N, M)`` with ``im_shape = (I1, I2, I3)``
        (default ``(I, 1, 1)``).
      fmod: remodulation frequency for IQ data.
      tx_model: 'plane' | 'virtual' | 'diverging'.
      keep_rx / keep_tx: keep the rx / tx axis instead of summing it.
      method: sampler, one of ``interp.METHODS``.

    Returns:
      image ``(I, N', M', *F)`` with ``N' = N if keep_rx else 1`` and
      ``M' = M if keep_tx else 1``.
    """
    dev = x.device
    pi, pr, pv, nv = (as_f32(a, dev) for a in (pi, pr, pv, nv))
    M = x.shape[2]
    t0 = as_f32(t0, dev).reshape(-1).expand(M)
    cinv = as_f32(cinv, dev)
    if cinv.ndim == 1:  # per-pixel map (I,) -> broadcast over rx
        cinv = cinv[:, None]
    dr = rx_distance(pi, pr)  # tx-independent: once

    def tau(m):
        dv = tx_distance(pi, pv[m], nv[m], tx_model)  # (I,)
        return cinv * (dv[:, None] + dr) - t0[m]      # (I, N)

    return _sum_transmits(x, tau, pi.shape[0], fs=fs, apod=apod, fmod=fmod,
                          keep_rx=keep_rx, keep_tx=keep_tx, method=method,
                          im_shape=im_shape)


def _sum_transmits(x: torch.Tensor, tau, I: int, *, fs: float, apod, fmod,
                   keep_rx, keep_tx, method, im_shape) -> torch.Tensor:
    """The transmit loop shared by :func:`das` and :func:`das_lut`:
    ``tau(m)`` gives the (I, N) delays [s] of transmit m; sample at
    ``tau * fs`` (fs rounded to float32), remodulate, apodize, and sum or
    keep the rx / tx axes. Returns (I, N', M', *F)."""
    dev = x.device
    T, N, M = x.shape[:3]
    F = tuple(x.shape[3:])
    fs = float(np.float32(fs))
    im_shape = tuple(im_shape or (I, 1, 1))
    if int(np.prod(im_shape)) != I:
        raise ValueError(f"im_shape {im_shape} does not hold {I} pixels")
    apod = tuple(_lift5(torch.as_tensor(a, device=dev))
                 for a in (apod if isinstance(apod, (tuple, list)) else (apod,)))
    apod_m = tuple(a for a in apod if a.shape[4] == M)
    apod_c = tuple(a[..., 0] for a in apod if a.shape[4] != M)

    cplx = x.is_complex() or fmod != 0.0
    out_dtype = torch.complex64 if cplx else x.dtype

    parts, acc = [], None
    for m in range(M):
        tau_m = tau(m)
        v = interp1(x[:, :, m], tau_m * fs, method=method)  # (I, N, *F)
        if cplx:
            v = v.to(out_dtype)
        if fmod != 0.0:
            ph = (2 * math.pi * fmod) * tau_m
            v = v * expand_trailing(torch.polar(torch.ones_like(ph), ph), v.ndim)
        if apod_m or apod_c:
            v5 = v.reshape(im_shape + tuple(v.shape[1:]))
            for a in tuple(a[..., m] for a in apod_m) + apod_c:
                v5 = v5 * expand_trailing(a, v5.ndim)
            v = v5.reshape(v.shape)
        if not keep_rx:
            v = v.sum(dim=1, keepdim=True)  # (I, 1, *F)
        if keep_tx:
            parts.append(v)
        else:
            acc = v if acc is None else acc + v
    if keep_tx:
        return torch.stack(parts, dim=2)  # (I, N', M, *F)
    if acc is None:
        acc = torch.zeros((I, N if keep_rx else 1) + F, dtype=out_dtype, device=dev)
    return acc[:, :, None]  # (I, N', 1, *F)


def das_lut(x: torch.Tensor, tau_rx, tau_tx, t0, *, fs: float, apod=(),
            fmod: float = 0.0, keep_rx: bool = False, keep_tx: bool = False,
            method: str = "cubic",
            im_shape: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Delay-and-sum from delay tables ("bring your own delays"), the port
    of :func:`qups_tpu.ops.das.das_lut` and the plain version of kernel K2
    (:func:`qups_tpu_torch.ops.das_cuda.das_lut_sum`). Per pixel i,
    transmit m, receiver n:

        tau = (tau_tx[i, m] + tau_rx[i, n]) - t0[m],   ti = tau * fs

    with ``fs`` rounded to float32, in exactly this order, so that K2 and
    this function take the same sample. ``tau_rx (I, N)``, ``tau_tx (I, M)``
    in seconds; the other arguments and the result as :func:`das`.
    """
    dev = x.device
    tau_rx, tau_tx = as_f32(tau_rx, dev), as_f32(tau_tx, dev)
    t0 = as_f32(t0, dev).reshape(-1).expand(x.shape[2])
    return _sum_transmits(
        x, lambda m: (tau_tx[:, m, None] + tau_rx) - t0[m], tau_rx.shape[0],
        fs=fs, apod=apod, fmod=fmod, keep_rx=keep_rx, keep_tx=keep_tx,
        method=method, im_shape=im_shape)
