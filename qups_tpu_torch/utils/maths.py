"""Numeric helpers, the port of :mod:`qups_tpu.utils.maths`. The tensor
helpers compute on the device of their input; arrays and numbers become
tensors on the CPU. :func:`gridded_interp`, the interpolation of the
eikonal tables and ``Medium.Sampled``, is float64 host numpy."""
from __future__ import annotations

from itertools import product

import numpy as np
import torch


def mod2db(x) -> torch.Tensor:
    """Log-compressed magnitude ``20*log10(|x|)`` of a tensor or array."""
    return 20.0 * torch.log10(torch.abs(torch.as_tensor(x)))


def db2pow(x) -> torch.Tensor:
    return 10.0 ** (torch.as_tensor(x) / 10.0)


def pow2db(x) -> torch.Tensor:
    return 10.0 * torch.log10(torch.as_tensor(x))


def nan2zero(x) -> torch.Tensor:
    """NaNs replaced by zeros."""
    x = torch.as_tensor(x)
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def rsqrt(x) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.as_tensor(x))


def isalmostn(a, b, tol=None) -> bool:
    """NaN-tolerant almost-equal, the reference's test comparator: the same
    shape, NaNs in the same places, and the other entries within ``tol``
    (default 100 eps of the wider of the two types, at least float32)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if tol is None:
        tol = 1e2 * np.finfo(np.result_type(a.dtype, b.dtype, np.float32)).eps
    if not (np.isnan(a) == np.isnan(b)).all():
        return False
    m = ~np.isnan(a)
    return bool((np.abs(a[m] - b[m]) < tol).all())


def deg2rad(x) -> torch.Tensor:
    return torch.as_tensor(x) * (np.pi / 180.0)


def rad2deg(x) -> torch.Tensor:
    return torch.as_tensor(x) * (180.0 / np.pi)


def cosd(x) -> torch.Tensor:
    return torch.cos(deg2rad(x))


def sind(x) -> torch.Tensor:
    return torch.sin(deg2rad(x))


def vecnorm(x, axis: int = 0, keepdims: bool = False) -> torch.Tensor:
    """Euclidean norm along ``axis`` (MATLAB ``vecnorm``)."""
    x = torch.as_tensor(x)
    sq = x.real ** 2 + x.imag ** 2 if x.is_complex() else x * x
    return torch.sqrt(torch.sum(sq, dim=axis, keepdim=keepdims))


def next_pow2(n: int) -> int:
    """The least power of two >= ``n`` (1 for ``n`` <= 1)."""
    n, p = int(n), 1
    while p < n:
        p <<= 1
    return p


def box_rbounds(pa, pb):
    """Conservative ``(min, max)`` Euclidean distance between two point sets
    from their axis-aligned bounding boxes: O(len(a) + len(b)) host numpy
    instead of the exact O(a*b) distance matrix. The lower bound
    under-estimates and the upper over-estimates, which is the safe
    direction for trace-window planning.

    ``pa``/``pb``: (num, 3) point arrays.
    """
    pa = np.asarray(pa, np.float64).reshape(-1, 3)
    pb = np.asarray(pb, np.float64).reshape(-1, 3)
    alo, ahi = pa.min(axis=0), pa.max(axis=0)
    blo, bhi = pb.min(axis=0), pb.max(axis=0)
    gap = np.maximum(0.0, np.maximum(blo - ahi, alo - bhi))
    span = np.maximum(bhi - alo, ahi - blo)
    return float(np.linalg.norm(gap)), float(np.linalg.norm(span))


def gridded_interp(vals, fis, method: str = "cubic"):
    """Separable gridded interpolation of an N-D host array at fractional
    indices: the ``griddedInterpolant(..., 'cubic')`` analog that samples
    the eikonal maps (``UltrasoundSystem.m:4318-4321``) and
    ``Medium.Sampled`` (``Medium.m:465``).

    ``vals``: (N1, ..., Nd) numpy array; ``fis``: list of d fractional
    index arrays (common broadcast shape Q). ``method``: 'nearest' |
    'linear' | 'cubic' (Catmull-Rom; clamp-replicated edge taps).
    Size-1 axes are constant. Returns shape Q (host numpy, float64).

    Example:
        import numpy as np
        from qups_tpu_torch.utils.maths import gridded_interp
        v = np.arange(30.0).reshape(5, 6)  # linear in both indices
        assert np.isclose(gridded_interp(v, [np.array(2.5), np.array(2.25)]), 17.25)
    """
    vals = np.asarray(vals)
    d = vals.ndim
    assert len(fis) == d, (len(fis), d)
    if method == "nearest":
        idx = tuple(
            np.clip(np.round(np.asarray(f)).astype(int), 0, n - 1)
            for f, n in zip(fis, vals.shape))
        return vals[idx]

    def taps(f, n):
        """[(index array, weight array), ...] along one axis."""
        f = np.asarray(f, np.float64)
        if n == 1:
            return [(np.zeros(f.shape, int), np.ones(f.shape))]
        i0 = np.floor(f)
        u = f - i0
        i0 = i0.astype(int)
        if method == "linear":
            pairs = [(i0, 1.0 - u), (i0 + 1, u)]
        elif method == "cubic":
            w = (0.5 * (u * (-1.0 + u * (2.0 - u))),
                 0.5 * (2.0 + u * u * (-5.0 + 3.0 * u)),
                 0.5 * (u * (1.0 + u * (4.0 - 3.0 * u))),
                 0.5 * (u * u * (u - 1.0)))
            pairs = [(i0 - 1 + k, w[k]) for k in range(4)]
        else:
            raise ValueError(f"unknown method {method!r}")
        return [(np.clip(i, 0, n - 1), wt) for i, wt in pairs]

    axes = [taps(f, n) for f, n in zip(fis, vals.shape)]
    out = 0.0
    for combo in product(*axes):
        idx = tuple(c[0] for c in combo)
        w = 1.0
        for c in combo:
            w = w * c[1]
        out = out + w * vals[idx]
    return out
