"""Ray path integrals over 2-D grids, the port of :mod:`qups_tpu.ops.rays`.

* :func:`wbilerp`: exact per-cell bilinear path-integral weights of a line
  segment crossing a 2-D grid (``src/wbilerp.cu:21-100``, ``kern/wbilerp.m``),
  the building block of ray-based travel-time tomography;
* :func:`xiaolinwu_line`: anti-aliased line pixel weights
  (``kern/xiaolinwu_k_scaled.m``);
* :func:`ray_paths`: the (nz, nx, rays) integral-weight array
  (``kern/rayPaths.m``);
* :func:`global_average_c`: the average sound speed along straight rays
  through a medium map (``kern/globalAverageC.m``).

These four are host numpy in float64, copies of the JAX package's.
:func:`ray_paths_device` and :func:`wbilerp_dense` are the device path, on
``device`` (default: the CUDA device): every ray at once, as batched torch
ops rather than a loop or ``vmap`` over rays. Each ray's crossing set has the
fixed size nx + nz + 2 and is sorted along one dim; cells come from one
batched ``torch.searchsorted``; Simpson's rule weights each segment (exact
for the bilinear integrand, which is quadratic along it); the four corner
deposits are ``index_add_`` into the (nz, nx, R) float32 weights, the layout
of the JAX package's ``out_axes=2``. The crossings and cell coordinates are
float64 (the JAX package's are float32): a cell coordinate is the
difference of two positions across the grid, which float32 would round to
a fraction of the grid's extent, not of the cell, so float64 keeps the
weights within a float32 rounding of the host's. On the CPU the deposits land in the JAX
package's order; on a CUDA device they are atomic and land in no fixed
order, which moves a weight by a few float32 roundings of the largest one.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils.backend import default_device


def wbilerp(xg: np.ndarray, zg: np.ndarray, pa: Sequence[float],
            pb: Sequence[float]):
    """Exact bilinear path-integral weights of segment ``pa -> pb`` (2-D,
    coordinates (x, z)) over the grid with axes ``xg`` (columns) and ``zg``
    (rows).

    Returns ``(iz, ix, w)`` COO arrays over GRID NODES: the line integral of
    the bilinear interpolant is ``sum_k w[k] * f[iz[k], ix[k]]`` for any
    nodal field ``f`` (weights have units of length).
    """
    xg = np.asarray(xg, np.float64)
    zg = np.asarray(zg, np.float64)
    pa = np.asarray(pa, np.float64)
    pb = np.asarray(pb, np.float64)
    d = pb - pa
    L = float(np.hypot(*d))
    if L == 0:
        return np.zeros(0, int), np.zeros(0, int), np.zeros(0)

    # parameter values of all grid-line crossings, clipped to [0, 1]
    ts = [0.0, 1.0]
    for g, p0, dd in ((xg, pa[0], d[0]), (zg, pa[1], d[1])):
        if dd != 0:
            t = (g - p0) / dd
            ts.extend(t[(t > 0) & (t < 1)])
    ts = np.unique(np.asarray(ts))

    izl, ixl, wl = [], [], []
    nx, nz = len(xg), len(zg)
    for t0, t1 in zip(ts[:-1], ts[1:]):
        tm = 0.5 * (t0 + t1)
        pm = pa + tm * d
        # owning cell
        ix = int(np.clip(np.searchsorted(xg, pm[0]) - 1, 0, nx - 2))
        iz = int(np.clip(np.searchsorted(zg, pm[1]) - 1, 0, nz - 2))
        if not (xg[0] <= pm[0] <= xg[-1] and zg[0] <= pm[1] <= zg[-1]):
            continue  # outside the grid
        dx = xg[ix + 1] - xg[ix]
        dz = zg[iz + 1] - zg[iz]
        seg = L * (t1 - t0)

        def uv(t):
            p = pa + t * d
            return ((p[0] - xg[ix]) / dx, (p[1] - zg[iz]) / dz)

        # Simpson integration (exact for the bilinear integrand, which is
        # quadratic in t along the segment)
        for (cu, cv, di, dj) in ((0, 0, 0, 0), (1, 0, 1, 0), (0, 1, 0, 1),
                                 (1, 1, 1, 1)):
            def basis(t):
                u, v = uv(t)
                bu = u if cu else (1 - u)
                bv = v if cv else (1 - v)
                return bu * bv
            w = seg * (basis(t0) + 4 * basis(0.5 * (t0 + t1)) + basis(t1)) / 6
            if w != 0:
                izl.append(iz + dj)
                ixl.append(ix + di)
                wl.append(w)
    iz = np.asarray(izl, int)
    ix = np.asarray(ixl, int)
    w = np.asarray(wl)
    # accumulate duplicate nodes
    if iz.size:
        key = iz * nx + ix
        order = np.argsort(key)
        key, iz, ix, w = key[order], iz[order], ix[order], w[order]
        uniq, start = np.unique(key, return_index=True)
        wsum = np.add.reduceat(w, start)
        iz = (uniq // nx).astype(int)
        ix = (uniq % nx).astype(int)
        w = wsum
    return iz, ix, w


def xiaolinwu_line(x0: float, y0: float, x1: float, y1: float):
    """Xiaolin Wu's anti-aliased line: integer pixel pairs with coverage
    weights (``kern/xiaolinwu_k_scaled.m`` computes the k-th pair; here all
    pairs are returned). Returns ``(px, py, w)`` arrays."""
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
    if x0 > x1:
        x0, x1, y0, y1 = x1, x0, y1, y0
    dx = x1 - x0
    grad = 1.0 if dx == 0 else (y1 - y0) / dx
    px, py, w = [], [], []

    def plot(x, y, c):
        if c <= 0:
            return
        if steep:
            px.append(int(y)); py.append(int(x))
        else:
            px.append(int(x)); py.append(int(y))
        w.append(float(c))

    def endpoint(x, y):
        xe = round(x)
        ye = y + grad * (xe - x)
        xgap = 1 - (x + 0.5 - np.floor(x + 0.5))
        plot(xe, np.floor(ye), (1 - (ye - np.floor(ye))) * xgap)
        plot(xe, np.floor(ye) + 1, (ye - np.floor(ye)) * xgap)
        return xe, ye + grad

    xs, inter = endpoint(x0, y0)
    xe, _ = endpoint(x1, y1)
    for x in range(int(xs) + 1, int(xe)):
        f = inter - np.floor(inter)
        plot(x, np.floor(inter), 1 - f)
        plot(x, np.floor(inter) + 1, f)
        inter += grad
    return np.asarray(px), np.asarray(py), np.asarray(w)


def ray_paths(xg: np.ndarray, zg: np.ndarray, pa: np.ndarray, pb: np.ndarray,
              method: str = "bilerp"):
    """Sparse ray-integral weight matrices for many rays
    (``kern/rayPaths.m``): for each ray r from ``pa[:, r]`` to ``pb[:, r]``
    (rows (x, z)), the nodal weights such that travel time =
    ``sum w * slowness``. Returns a dense ``(nz, nx, nrays)`` array (use
    sparse downstream if needed).

    Example:
        import numpy as np
        from qups_tpu_torch.ops.rays import ray_paths
        xg = np.linspace(0.0, 10e-3, 11)
        zg = np.linspace(0.0, 10e-3, 11)
        pa = np.array([[0.0], [0.0]])         # (x, z) start
        pb = np.array([[10e-3], [10e-3]])     # diagonal ray
        W = ray_paths(xg, zg, pa, pb)
        # the weights integrate the path length: sum = |pb - pa|
        assert abs(W[:, :, 0].sum() - np.hypot(10e-3, 10e-3)) < 1e-6
    """
    pa = np.atleast_2d(np.asarray(pa, np.float64))
    pb = np.atleast_2d(np.asarray(pb, np.float64))
    if pa.shape[0] != 2:
        pa = pa.T
    if pb.shape[0] != 2:
        pb = pb.T
    nr = max(pa.shape[1], pb.shape[1])
    pa = np.broadcast_to(pa, (2, nr))
    pb = np.broadcast_to(pb, (2, nr))
    W = np.zeros((len(zg), len(xg), nr))
    for r in range(nr):
        if method == "bilerp":
            iz, ix, w = wbilerp(xg, zg, pa[:, r], pb[:, r])
            W[iz, ix, r] = w
        elif method == "xiaolinwu":
            # pixel-coverage weights scaled to physical step length
            dx = xg[1] - xg[0]
            dz = zg[1] - zg[0]
            x0 = (pa[0, r] - xg[0]) / dx
            x1 = (pb[0, r] - xg[0]) / dx
            y0 = (pa[1, r] - zg[0]) / dz
            y1 = (pb[1, r] - zg[0]) / dz
            px, py, w = xiaolinwu_line(x0, y0, x1, y1)
            seg = np.hypot((pb[0, r] - pa[0, r]), (pb[1, r] - pa[1, r]))
            npix = max(abs(x1 - x0), abs(y1 - y0)) + 1
            m = (px >= 0) & (px < len(xg)) & (py >= 0) & (py < len(zg))
            W[py[m], px[m], r] += w[m] * seg / max(npix, 1)
        else:
            raise ValueError(method)
    return W


def global_average_c(cmap: np.ndarray, xg: np.ndarray, zg: np.ndarray,
                     pa: np.ndarray, pb: np.ndarray) -> np.ndarray:
    """Average sound speed along straight rays from ``pa`` to points ``pb``
    through the nodal speed map ``cmap (nz, nx)``
    (``kern/globalAverageC.m``): ``c_avg = length / integral(1/c dl)``."""
    W = ray_paths(xg, zg, pa, pb)  # (nz, nx, R)
    s = 1.0 / np.asarray(cmap, np.float64)
    t = np.einsum("zxr,zx->r", W, s)
    pa2 = np.broadcast_to(np.atleast_2d(pa).reshape(2, -1), (2, W.shape[2]))
    pb2 = np.broadcast_to(np.atleast_2d(pb).reshape(2, -1), (2, W.shape[2]))
    L = np.hypot(*(pb2 - pa2))
    return np.where(t > 0, L / np.maximum(t, 1e-300), np.nan)


def _f64(a, device) -> torch.Tensor:
    """An array or tensor as float64 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def _points(p, device) -> torch.Tensor:
    """(x, z) endpoints as a (2, R) float64 tensor."""
    p = _f64(p, device)
    p = p.reshape(1, -1) if p.ndim < 2 else p
    return p if p.shape[0] == 2 else p.T


def _deposit(W: torch.Tensor, xg: torch.Tensor, zg: torch.Tensor, pa: torch.Tensor,
             pb: torch.Tensor, r0: int) -> None:
    """Add the weights of the rays ``pa[:, r] -> pb[:, r]`` (2, Rc) into
    ``W[:, :, r0 + r]``; the grid axes and endpoints are float64."""
    nx, nz, R = xg.shape[0], zg.shape[0], W.shape[2]
    Rc = pa.shape[1]
    d = pb - pa
    L = torch.hypot(d[0], d[1])  # (Rc,)

    def crossings(g, p0, dd):  # grid-line crossing parameters (n, Rc)
        t = (g[:, None] - p0) / torch.where(dd == 0, torch.ones_like(dd), dd)
        return torch.where(dd == 0, torch.zeros_like(t), t)

    ts = torch.cat([crossings(xg, pa[0], d[0]), crossings(zg, pa[1], d[1]),
                    torch.zeros((1, Rc), dtype=d.dtype, device=d.device),
                    torch.ones((1, Rc), dtype=d.dtype, device=d.device)])
    ts = torch.sort(torch.clamp(ts, 0.0, 1.0), dim=0).values  # (nx + nz + 2, Rc)
    t0s, t1s = ts[:-1], ts[1:]
    tm = 0.5 * (t0s + t1s)
    pmx = pa[0] + tm * d[0]
    pmz = pa[1] + tm * d[1]
    ix = torch.clamp(torch.searchsorted(xg, pmx) - 1, 0, nx - 2)
    iz = torch.clamp(torch.searchsorted(zg, pmz) - 1, 0, nz - 2)
    inside = ((pmx >= xg[0]) & (pmx <= xg[-1]) & (pmz >= zg[0]) & (pmz <= zg[-1])
              & (t1s > t0s))
    dx = xg[ix + 1] - xg[ix]
    dz = zg[iz + 1] - zg[iz]
    seg = torch.where(inside, L * (t1s - t0s), torch.zeros_like(t0s))

    def uv(t):
        return (pa[0] + t * d[0] - xg[ix]) / dx, (pa[1] + t * d[1] - zg[iz]) / dz

    u0, v0 = uv(t0s)
    um, vm = uv(tm)
    u1, v1 = uv(t1s)
    r = torch.arange(r0, r0 + Rc, device=d.device)
    flat = W.view(-1)
    for cu, cv in ((0, 0), (1, 0), (0, 1), (1, 1)):
        def basis(u, v):
            return (u if cu else 1 - u) * (v if cv else 1 - v)
        # Simpson: exact for the (quadratic in t) bilinear integrand
        w = seg * (basis(u0, v0) + 4 * basis(um, vm) + basis(u1, v1)) / 6
        idx = ((iz + cv) * nx + (ix + cu)) * R + r
        flat.index_add_(0, idx.reshape(-1), w.reshape(-1).to(flat.dtype))


# rays go through the device path by chunks of about this many segments
CHUNK_SEGMENTS = 2 ** 23


def ray_paths_device(xg, zg, pa, pb, device=None) -> torch.Tensor:
    """Device :func:`ray_paths` (bilerp): the exact bilinear path-integral
    weights of the rays ``pa[:, r] -> pb[:, r]`` ((2, R) or (R, 2) (x, z)
    endpoints, either side may be one point) over the grid with axes
    ``xg`` (columns) and ``zg`` (rows), as a dense ``(nz, nx, R)`` float32
    tensor on ``device`` (default: the CUDA device). The rays go through
    by chunks of about ``CHUNK_SEGMENTS`` segments.

    Example:
        import numpy as np
        from qups_tpu_torch.ops.rays import ray_paths, ray_paths_device
        xg = np.linspace(0.0, 10e-3, 13)
        zg = np.linspace(0.0, 8e-3, 9)
        pa = np.array([[1e-3, 9e-3], [1e-3, 2e-3]])
        pb = np.array([[9e-3, 2e-3], [7e-3, 7e-3]])
        W = ray_paths_device(xg, zg, pa, pb, device="cpu")
        assert np.abs(W.numpy() - ray_paths(xg, zg, pa, pb)).max() < 1e-6
        assert np.allclose(W.sum((0, 1)).numpy(), np.hypot(*(pb - pa)), atol=1e-6)
    """
    dev = default_device(device)
    xg, zg = _f64(xg, dev), _f64(zg, dev)
    pa, pb = _points(pa, dev), _points(pb, dev)
    R = max(pa.shape[1], pb.shape[1])
    pa, pb = pa.expand(2, R), pb.expand(2, R)
    W = torch.zeros((zg.shape[0], xg.shape[0], R), dtype=torch.float32, device=dev)
    chunk = max(1, CHUNK_SEGMENTS // (xg.shape[0] + zg.shape[0] + 1))
    for r0 in range(0, R, chunk):
        _deposit(W, xg, zg, pa[:, r0:r0 + chunk], pb[:, r0:r0 + chunk], r0)
    return W


def wbilerp_dense(xg, zg, pa, pb, device=None) -> torch.Tensor:
    """Device :func:`wbilerp` of one segment ``pa -> pb`` ((x, z)) as a
    dense ``(nz, nx)`` float32 tensor on ``device`` (default: the CUDA
    device): :func:`ray_paths_device` of one ray.

    Example:
        import numpy as np
        from qups_tpu_torch.ops.rays import wbilerp, wbilerp_dense
        xg = np.linspace(0, 1e-2, 9)
        zg = np.linspace(0, 1e-2, 7)
        pa, pb = np.array([1e-3, 2e-3]), np.array([9e-3, 5e-3])
        Wd = wbilerp_dense(xg, zg, pa, pb, device="cpu").numpy()
        iz, ix, w = wbilerp(xg, zg, pa, pb)
        Wh = np.zeros((7, 9))
        Wh[iz, ix] = w
        assert abs(Wd.sum() - np.hypot(8e-3, 3e-3)) < 1e-6
        assert np.abs(Wd - Wh).max() < 1e-6
    """
    pa = np.asarray(pa) if not isinstance(pa, torch.Tensor) else pa
    pb = np.asarray(pb) if not isinstance(pb, torch.Tensor) else pb
    return ray_paths_device(xg, zg, pa.reshape(2, 1), pb.reshape(2, 1), device=device)[:, :, 0]
