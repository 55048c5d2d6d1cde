"""Fractional-delay sampling along the time axis.

Port of :mod:`qups_tpu.ops.interp`: the sampler core (``_lanczos_w``,
``_taps``, ``expand_trailing``, ``_gather_time``, ``interp1``), the
weighted sums (``wsinterpd``, ``wsinterpd2``), the Fourier interpolant
``interpf`` and the band-limited ``fft_upsample`` of ``method='cubic2x'``.
The sampler's semantics are the contract that the DAS kernel
(``csrc/das.cu``) follows:

* the valid domain is ``0 <= tau <= T-1``, both ends included; outside it
  the sample is the extrapolation value;
* edge taps are clamp-replicated to ``[0, T-1]``;
* nearest rounds half to even (``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

METHODS = ("nearest", "linear", "cubic", "lanczos3")


def _lanczos_w(u: torch.Tensor) -> torch.Tensor:
    """3-lobe (a=2) Lanczos window ``2 sin(pi u) sin(pi u / 2) / (pi u)^2``."""
    one = torch.ones_like(u)
    safe = torch.where(u == 0, one, u)
    w = 2.0 * torch.sin(math.pi * safe) * torch.sin(math.pi * safe / 2) \
        / (math.pi * safe) ** 2
    return torch.where(u == 0, one, w)


def _taps(tau: torch.Tensor, method: str, T: int):
    """Return (base_index, offsets, weights, valid) for a sampler at
    fractional indices ``tau``."""
    valid = (0 <= tau) & (tau <= T - 1)
    if method == "nearest":
        b = torch.round(tau).long()
        return b, (0,), (torch.ones_like(tau),), valid
    i0f = torch.floor(tau)
    u = tau - i0f
    i0 = i0f.long()
    if method == "linear":
        return i0, (0, 1), (1 - u, u), valid
    if method == "cubic":
        # Catmull-Rom weights, including the 1/2 factor
        a0 = 0.5 * (u * (-1.0 + u * (2.0 - u)))
        a1 = 0.5 * (2.0 + u * u * (-5.0 + 3.0 * u))
        a2 = 0.5 * (u * (1.0 + u * (4.0 - 3.0 * u)))
        a3 = 0.5 * (u * u * (u - 1.0))
        return i0 - 1, (0, 1, 2, 3), (a0, a1, a2, a3), valid
    if method == "lanczos3":
        return i0 - 1, (0, 1, 2, 3), (_lanczos_w(u + 1), _lanczos_w(u),
                                      _lanczos_w(u - 1), _lanczos_w(u - 2)), valid
    raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")


def expand_trailing(a: torch.Tensor, nd: int) -> torch.Tensor:
    """Pad shape with trailing singleton dims to ``nd`` dims (left-aligned
    broadcasting: implicit trailing 1s)."""
    if a.ndim >= nd:
        return a
    return a.reshape(tuple(a.shape) + (1,) * (nd - a.ndim))


def bshape_left(*shapes) -> Tuple[int, ...]:
    """Broadcast shapes with left-aligned rules (pad on the right)."""
    nd = max(len(s) for s in shapes)
    padded = [tuple(s) + (1,) * (nd - len(s)) for s in shapes]
    return tuple(np.broadcast_shapes(*padded))


def _gather_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y[i, *D] = x[idx[i, *D], *D], gathering along axis 0 of ``x``.

    ``x``: (T, *B); ``idx``: (I, *C) with C left-aligned broadcastable
    against B. Returns (I, *broadcast(C, B)).
    """
    D = bshape_left(tuple(idx.shape[1:]), tuple(x.shape[1:]))
    xe = expand_trailing(x, 1 + len(D)).expand((x.shape[0],) + D)
    idxb = expand_trailing(idx, 1 + len(D)).expand((idx.shape[0],) + D)
    return torch.gather(xe, 0, idxb)


def interp1(x: torch.Tensor, tau, method: str = "cubic", extrap=0.0):
    """Sample ``x`` along its first axis at fractional indices ``tau``.

    ``x``: (T, *B); ``tau``: (I, *C) where C broadcasts against B with
    left-aligned (trailing-singleton) rules. Returns ``(I, *broadcast(C, B))``
    on the device of ``x``.
    """
    tau = torch.as_tensor(tau, device=x.device)
    if tau.ndim == 0:
        tau = tau[None]
    T = x.shape[0]
    b, offs, ws, valid = _taps(tau, method, T)
    acc = None
    for k, w in zip(offs, ws):
        v = _gather_time(x, torch.clamp(b + k, 0, T - 1))
        w = expand_trailing(w, v.ndim)
        wv = w.to(v.real.dtype) if v.is_complex() else w.to(v.dtype)
        acc = v * wv if acc is None else acc + v * wv
    validb = expand_trailing(valid, acc.ndim).expand(acc.shape)
    return torch.where(validb, acc,
                       torch.tensor(extrap, dtype=acc.dtype, device=acc.device))


def interpd(x: torch.Tensor, tau, method: str = "cubic", extrap=0.0):
    """Broadcasted 1-D interpolation: ``x`` (T, *B), ``tau`` (*C) of
    fractional time indices; output ``broadcast(C, B)``. The port of
    :func:`qups_tpu.ops.interp.interpd`.

    Example:
        import numpy as np, torch
        from qups_tpu_torch.ops.interp import interpd
        x = torch.sin(torch.linspace(0, 6.28, 64))[:, None]
        y = interpd(x, torch.tensor([[10.5], [20.25]]), method="cubic")
        assert y.shape == (2, 1)
        assert abs(float(y[0, 0]) - np.sin(10.5 * 6.28 / 63)) < 1e-3
    """
    return interp1(x, tau, method=method, extrap=extrap)


def interpf(x: torch.Tensor, tau, extrap=None, chunk: int = 2048):
    """Frequency-domain (Fourier) interpolation, the port of
    :func:`qups_tpu.ops.interp.interpf`: the trigonometric interpolant of
    ``x (T, *B)`` at fractional indices ``tau (I, *C)`` (C left-aligned
    broadcastable against B), ``y = sum_k X[k] exp(2i pi f_k tau) / T``,
    by blocks of ``chunk`` leading indices. Real ``x`` gives the real part.
    ``extrap`` is accepted for the signature and, as there, unused.

    Example:
        import numpy as np, torch
        from qups_tpu_torch.ops.interp import interpf
        t = torch.arange(32, dtype=torch.float32)
        x = torch.cos(2 * np.pi * 3 * t / 32)[:, None]
        y = interpf(x, torch.tensor([[2.5]]))
        assert abs(float(y) - np.cos(2 * np.pi * 3 * 2.5 / 32)) < 1e-5
    """
    tau = torch.as_tensor(tau, device=x.device)
    if tau.ndim == 0:
        tau = tau[None]
    X = torch.fft.fft(x, dim=0)
    T, B = x.shape[0], tuple(x.shape[1:])
    f = torch.fft.fftfreq(T, device=x.device)  # cycles per sample

    def blk(tb):
        D = bshape_left(tuple(tb.shape[1:]), B)
        taue = expand_trailing(tb, 1 + len(D)).expand((tb.shape[0],) + D)
        Xe = expand_trailing(X, 1 + len(D)).expand((T,) + D)
        th = 2 * math.pi * taue[..., None] * f  # (i, *D, T)
        y = (torch.polar(torch.ones_like(th), th) * torch.movedim(Xe, 0, -1)[None]
             ).sum(-1) / T
        return y if x.is_complex() else y.real

    if not chunk or tau.shape[0] <= chunk:
        return blk(tau)
    return torch.cat([blk(tau[i:i + chunk]) for i in range(0, tau.shape[0], chunk)])


def fft_upsample(x: torch.Tensor, r: int = 2, axis: int = 0) -> torch.Tensor:
    """Band-limited ``r``-times upsampling along ``axis`` by zero-padding the
    spectrum (the Nyquist bin split in two for an even length), the port of
    :func:`qups_tpu.ops.interp.fft_upsample`: output sample ``n`` is the
    trigonometric interpolant of ``x`` at ``n / r``. The trace step of the
    ``cubic2x`` DAS sampler. Integer input gives floating output (the JAX
    package casts back to the input's type).

    Example:
        import numpy as np, torch
        from qups_tpu_torch.ops.interp import fft_upsample
        t = torch.arange(64) / 64.0
        y = fft_upsample(torch.sin(2 * np.pi * 5 * t), 2)
        t2 = torch.arange(128) / 128.0
        assert float((y - torch.sin(2 * np.pi * 5 * t2)).abs().max()) < 1e-5
    """
    r = int(r)
    if r == 1:
        return x
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.get_default_dtype())
    x = torch.movedim(x, axis, 0)
    T = x.shape[0]
    if x.is_complex():
        X = torch.fft.fft(x, dim=0)
        zeros = lambda n: X.new_zeros((n,) + tuple(X.shape[1:]))  # noqa: E731
        if T % 2 == 0:  # split the Nyquist bin across +/- f_N
            hi = T // 2
            nyq = X[hi:hi + 1] * 0.5
            Xp = torch.cat([X[:hi], nyq, zeros(r * T - T - 1), nyq, X[hi + 1:]])
        else:
            h = (T + 1) // 2
            Xp = torch.cat([X[:h], zeros(r * T - T), X[h:]])
        y = torch.fft.ifft(Xp, dim=0) * r
    else:
        X = torch.fft.rfft(x, dim=0)
        if T % 2 == 0:
            X[-1] *= 0.5  # the Nyquist split (the conjugate half is implicit)
        Xp = torch.cat([X, X.new_zeros((r * T // 2 + 1 - X.shape[0],) + tuple(X.shape[1:]))])
        y = (torch.fft.irfft(Xp, n=r * T, dim=0) * r).to(x.dtype)
    return torch.movedim(y, 0, axis)


def _phase(omega, tau: torch.Tensor):
    """``exp(1j * omega * tau)`` as complex64, or ``None`` for omega 0."""
    if isinstance(omega, (int, float)) and omega == 0:
        return None
    th = omega * tau
    return torch.polar(torch.ones_like(th), th).to(torch.complex64)


def _sum_dims(v: torch.Tensor, sdim):
    if sdim is None:
        return v
    sdims = (sdim,) if isinstance(sdim, int) else tuple(sdim)
    return torch.sum(v, dim=sdims, keepdim=True) if sdims else v


def wsinterpd(x: torch.Tensor, tau, w=None, sdim=None, omega=0.0,
              method: str = "cubic", extrap=0.0):
    """Weighted-sum interpolation
    ``y = sum_{sdim} w * exp(1j * omega * tau) * sample(x, tau)``, the port
    of :func:`qups_tpu.ops.interp.wsinterpd`. ``x``: (T, *B); ``tau``:
    fractional indices, left-aligned broadcastable; ``w``: weights
    broadcastable to the sampled shape; ``sdim``: output dims to sum over;
    ``omega`` in radians per unit of ``tau``.

    Example:
        import torch
        from qups_tpu_torch.ops.interp import wsinterpd
        x = torch.arange(32, dtype=torch.float32)[:, None]
        y = wsinterpd(x, torch.tensor([[4.0, 6.0]]),
                      w=torch.tensor([[0.5, 0.5]]), sdim=1)
        assert abs(float(y) - 5.0) < 1e-5
    """
    tau = torch.as_tensor(tau, device=x.device)
    v = interp1(x, tau, method=method, extrap=extrap)
    ph = _phase(omega, tau)
    if ph is not None:
        v = v.to(torch.complex64) * expand_trailing(ph, v.ndim)
    if w is not None:
        w = torch.as_tensor(w, device=x.device)
        if not w.is_complex():
            w = w.to(v.real.dtype if v.is_complex() else v.dtype)
        v = v * expand_trailing(w, v.ndim)
    return _sum_dims(v, sdim)


def wsinterpd2(x: torch.Tensor, tau1, tau2, w=None, sdim=None, omega=0.0,
               method: str = "cubic", extrap=0.0):
    """Separable-delay weighted-sum interpolation: :func:`wsinterpd` at
    ``tau = tau1 + tau2``, where the two delay tensors broadcast against
    each other (left-aligned). The port of
    :func:`qups_tpu.ops.interp.wsinterpd2`: when a summed dim is singleton
    in one of the two delay tensors, it loops over that dim, so the joint
    ``tau1 + tau2`` tensor is only ever live one slice at a time.

    Example:
        import numpy as np, torch
        from qups_tpu_torch.ops.interp import wsinterpd, wsinterpd2
        x = torch.as_tensor(np.random.default_rng(0).standard_normal((32, 3, 1)),
                            dtype=torch.float32)
        t1 = torch.linspace(2, 8, 5).reshape(5, 1, 1)
        t2 = torch.linspace(0, 1, 3).reshape(1, 3, 1)
        y2 = wsinterpd2(x, t1, t2, sdim=1)
        assert torch.allclose(y2, wsinterpd(x, t1 + t2, sdim=1), atol=1e-5)
    """
    dev = x.device
    t1 = torch.as_tensor(tau1, device=dev)
    t2 = torch.as_tensor(tau2, device=dev)
    sdims = () if sdim is None else (
        (sdim,) if isinstance(sdim, int) else tuple(sdim))
    we = None if w is None else torch.as_tensor(w, device=dev)
    ndo = max(t1.ndim, t2.ndim, x.ndim, 0 if we is None else we.ndim)
    t1, t2, xe = (expand_trailing(a, ndo) for a in (t1, t2, x))
    we = None if we is None else expand_trailing(we, ndo)

    # the loop dim: the largest summed dim where the delays separate (one of
    # tau1 / tau2 singleton), as the reference picks its scan dim
    best, best_sz = None, 1
    for d in sdims:
        if d == 0 or d >= ndo:
            continue
        sz = max(t1.shape[d], t2.shape[d], xe.shape[d],
                 1 if we is None else we.shape[d])
        if sz > best_sz and (t1.shape[d] == 1 or t2.shape[d] == 1):
            best, best_sz = d, sz
    if best is None or best_sz <= 4:
        return wsinterpd(x, t1 + t2, w=w, sdim=sdim, omega=omega,
                         method=method, extrap=extrap)
    d = best
    rest = tuple(s for s in sdims if s != d)

    def at(a, j):
        return a if a is None or a.shape[d] == 1 else a.narrow(d, j, 1)

    acc = None
    for j in range(best_sz):
        y = wsinterpd(at(xe, j), at(t1, j) + at(t2, j), w=at(we, j),
                      sdim=rest if rest else None, omega=omega,
                      method=method, extrap=extrap)
        acc = y if acc is None else acc + y
    return acc
