"""Aperture-domain coherence imaging, plain PyTorch.

Port of :mod:`qups_tpu.ops.coherence`: reductions across the receive
aperture of a beamformed-but-unsummed (``keep_rx=True``) image, on the
device of their input (no TPU kernel stands behind them):

* :func:`cohfac`: coherence factor (``kern/cohfac.m``)
* :func:`slsc`: short-lag spatial coherence (``kern/slsc.m``)
* :func:`dmas`: delay-multiply-and-sum (``kern/dmas.m``)
* :func:`pcf`: phase coherence factor (``kern/pcf.m``)
* :func:`pwznxcorr`: pairwise windowed zero-normalized cross-correlation
  (``kern/pwznxcorr.m``)

Inputs are tensors or numpy arrays (moved to tensors on the CPU).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .conv import convd


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _safe(den: torch.Tensor) -> torch.Tensor:
    return torch.where(den == 0, torch.ones_like(den), den)


def cohfac(b, axis: int = -1) -> torch.Tensor:
    """Coherence factor ``|sum b|^2 / (N * sum |b|^2)`` over ``axis``.

    Example:
        import torch
        from qups_tpu_torch.ops import cohfac
        b = torch.ones((10, 32), dtype=torch.complex64)  # a coherent aperture
        assert torch.allclose(cohfac(b, axis=1), torch.ones(10), atol=1e-6)
    """
    b = _t(b)
    n = b.shape[axis]
    num = b.sum(dim=axis).abs() ** 2
    den = (b.abs() ** 2).sum(dim=axis) * n
    return num / _safe(den)


def slsc(x, axis: int = -1, lags: Union[int, Sequence[int], None] = None,
         method: str = "average", kaxis: Optional[int] = None) -> torch.Tensor:
    """Short-lag spatial coherence across the aperture ``axis``.

    ``lags``: the largest lag (an int L: lags 1..L) or a list of lags;
    default ``floor(A / 4)``. ``kaxis``: a time-kernel axis reduced with the
    aperture.

    * ``average``: normalize each channel (over ``kaxis``), then average the
      debiased correlation ``sum_{|i-j| in lags} conj(x_i) x_j / (A - |i-j|)
      / 2 / L``.
    * ``ensemble``: the z, a, b inner products over the selected lag pairs,
      then ``z / (sqrt|a| sqrt|b|)``.

    Complex input gives a complex result with a zero imaginary part, as the
    JAX package's.

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.ops import slsc
        rng = np.random.default_rng(0)
        sig = rng.standard_normal((64, 1))
        coh = torch.as_tensor(np.broadcast_to(sig, (64, 16)).copy())
        inc = torch.as_tensor(rng.standard_normal((64, 16)))
        s_c = float(slsc(coh, axis=1, lags=4).mean())
        s_i = float(slsc(inc, axis=1, lags=4).mean())
        assert s_c > 0.9 and s_c > 5 * abs(s_i)
    """
    x = _t(x)
    axis = axis % x.ndim
    A = x.shape[axis]
    if lags is None:
        lags = max(1, A // 4)
    lag_list = list(range(1, int(lags) + 1)) if np.isscalar(lags) else [int(l) for l in lags]
    L = len(lag_list)
    xm = torch.movedim(x, axis, -1)  # (..., A)
    ka = None
    if kaxis is not None:
        ka = kaxis % x.ndim
        ka = ka if ka < axis else ka - 1  # its position after the move
    if method == "average":
        nrm = (xm.abs() ** 2).sum(dim=ka, keepdim=True).sqrt() if ka is not None else xm.abs()
        xm = torch.where(nrm == 0, torch.zeros_like(xm), xm / _safe(nrm))
        z = torch.zeros(xm.shape[:-1], dtype=xm.dtype, device=xm.device)
        for l in lag_list:
            w = 1.0 / (A - l) / 2.0 / L
            c = (xm[..., : A - l].conj() * xm[..., l:]).sum(dim=-1)
            z = z + w * (c + c.conj()) if xm.is_complex() else z + 2 * w * c
        return z.sum(dim=ka) if ka is not None else z
    if method == "ensemble":
        z = a = b = 0.0
        for l in lag_list:
            xl, xr = xm[..., : A - l], xm[..., l:]
            zz = (xl.conj() * xr).sum(dim=-1)
            z = z + zz + zz.conj()
            a = a + 2 * (xl.conj() * xl).sum(dim=-1)
            b = b + 2 * (xr.conj() * xr).sum(dim=-1)
        if ka is not None:
            z, a, b = z.sum(dim=ka), a.sum(dim=ka), b.sum(dim=ka)
        ab = a.abs().sqrt() * b.abs().sqrt()
        return z / _safe(ab)
    raise ValueError(method)


def dmas(bn, axis: int = -1, lags: Union[int, Sequence[int], None] = None) -> torch.Tensor:
    """Delay-multiply-and-sum over aperture lag pairs, ``b = sum_{l in
    lags} sum_n bn[n] bn[n + l]``, then the phase-preserving rescale
    ``exp(i angle(b)) sqrt|b|`` (``sign(b) sqrt|b|`` for real input).

    Example:
        import torch
        from qups_tpu_torch.ops import dmas
        y = dmas(torch.ones((8, 16), dtype=torch.complex64), axis=1)
        assert y.shape == (8,) and bool((y.abs() > 0).all())
    """
    bn = _t(bn)
    axis = axis % bn.ndim
    N = bn.shape[axis]
    if lags is None:
        lag_list = range(1, N)
    elif np.isscalar(lags):
        lag_list = range(1, int(lags) + 1)
    else:
        lag_list = [int(l) for l in lags if 1 <= l <= N - 1]
    bm = torch.movedim(bn, axis, -1)
    b = torch.zeros(bm.shape[:-1], dtype=bm.dtype, device=bm.device)
    for l in lag_list:
        b = b + (bm[..., : N - l] * bm[..., l:]).sum(dim=-1)
    if b.is_complex():
        return torch.polar(torch.ones_like(b.real), b.angle()) * b.abs().sqrt()
    return torch.sign(b) * b.abs().sqrt()


def pcf(b, axis: int = -1, gamma: float = 1.0) -> torch.Tensor:
    """Phase coherence factor ``max(0, 1 - gamma / sigma_0 * sf)``, ``sf``
    the smaller of the phases' standard deviation across the aperture and
    that of the pi-wrapped auxiliary phases.

    Example:
        import torch
        from qups_tpu_torch.ops import pcf
        w = pcf(torch.ones((4, 16), dtype=torch.complex64), axis=1)
        assert torch.allclose(w, torch.ones(4), atol=1e-6)
    """
    b = _t(b)
    if not b.is_complex():
        raise ValueError("pcf requires complex (beamformed IQ) input")
    phi = b.angle()
    s0 = phi.std(dim=axis, correction=0)
    sa = (phi - math.pi * torch.sign(phi)).std(dim=axis, correction=0)
    sf = torch.minimum(s0, sa)
    return torch.clamp(1.0 - (gamma / math.sqrt(math.pi / 3)) * sf, min=0.0)


def pwznxcorr(x, lags: Sequence[int], W: int = None, *, taxis: int = 0, naxis: int = 1,
              stride: int = 1, zero: bool = True, norm: bool = True) -> torch.Tensor:
    """Pairwise windowed zero-normalized cross-correlation between channels
    ``n`` and ``n + stride`` at each lag ``l``:

        y[t, n, ..., l] = <xl, xr(l)>_W / sqrt(<xl, xl>_W <xr(l), xr(l)>_W)

    with sums over a length-``W`` moving window along ``taxis`` (zero-meaned
    first when ``zero``, unnormalized when not ``norm``); ``xr(l)`` is the
    second channel rolled back by ``l`` samples. Returns the result with a
    trailing lag axis.

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.ops import pwznxcorr
        base = np.random.default_rng(0).standard_normal(80).astype(np.float32)
        x = torch.as_tensor(np.stack([base, np.roll(base, 3)], axis=1))
        y = pwznxcorr(x, lags=[0, 3], W=21)
        assert float(y[40, 0, 1]) > float(y[40, 0, 0]) + 0.2
    """
    x = _t(x)
    lags = [int(l) for l in lags]
    if W is None:
        W = max(1, int(np.ceil(max(abs(np.asarray(lags))) / 2)))
    N = x.shape[naxis]
    xl = x.narrow(naxis, 0, N - stride)
    xr = x.narrow(naxis, stride, N - stride)
    wshape = [1] * x.ndim
    wshape[taxis] = W
    w = torch.ones(wshape, dtype=x.real.dtype, device=x.device)

    def winsum(v):
        return convd(v, w.to(v.dtype), axis=taxis, shape="same")

    if zero:
        xl = xl - winsum(xl) / W
    outs = []
    for l in lags:
        xrl = torch.roll(xr, -l, dims=taxis)
        if zero:
            xrl = xrl - winsum(xrl) / W
        num = winsum(xl * xrl.conj())
        if norm:
            den = (winsum(xl.abs() ** 2) * winsum(xrl.abs() ** 2)).abs().sqrt()
            outs.append(num / _safe(den))
        else:
            outs.append(num)
    return torch.stack(outs, dim=-1)
