"""Several devices from one process: the sharded pipelines of the port.

Port of :mod:`qups_tpu.parallel.mesh`. The JAX package shards its hot
pipelines over a ``jax.sharding.Mesh`` whose axes are the physics axes,
``frame`` (acquisitions), ``rx`` (receive channels) and ``tx`` (transmits),
and runs them as one ``shard_map`` program from one controller. The port
keeps that shape: a :class:`Mesh` is an array of ``torch.device``s with axis
names, driven by the one Python process that calls a sharded function.
Each shard's slice of the inputs goes to its device, each shard runs the
port's single-device function there (the kernels K1-K4 on a CUDA device,
their plain versions on the CPU), and the collectives become tensor
operations on the mesh's first device:

* ``psum``: the shards' partial results summed in a fixed shard order;
* an all-gather (a kept axis, frames, pixels, bins): a ``torch.cat``;
* the short-lag halo of ``post='slsc'`` (``ppermute``): the next rx shard's
  first L normalised channels, copied to this shard's device, zeros on the
  last shard.

Every function launches every shard before its first reduction, and
returns one tensor on ``mesh.devices.flat[0]``. A device may appear more
than once: ``make_mesh([torch.device("cuda", 0)] * 4)`` runs four shards on
one card, ``make_mesh([torch.device("cpu")] * 8)`` eight on the CPU.

The shard widths, the padding and the errors are the JAX package's: rx
shards of ``ceil(N / (n_rx 8)) 8`` channels in the kernel paths
(``das_sharded_pallas``, ``das_lut_sharded_pallas``), ``ceil(M / n_tx)``
transmits, ``ceil(. / n)`` frames, pixels and bins; zero traces and zero
signals, geometry, ``t0``, orientations and ``lat_tx`` replicated from the
edge; the padding cropped on return.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import fdbf_cuda
from ..ops.das import das
from ..ops.das_cuda import Fused, das_lut_sum, das_sum, prep_lut_sharded, prep_sharded
from ..ops.fdbf import (PRECISIONS as ADJ_PRECISIONS, adjoint_spectra, adjoint_sum,
                        fftfreq32, focus_tx_freq, keep_mode, refocus_apply, refocus_op,
                        stolt_migration)
from ..ops.greens import greens_splat
from ..ops.greens_freq import (attenuation, gemm_engine, gemm_pass, host_plan,
                               synthesize)
from ..sim.fdtd import batch_chunk, kspace_sim_2d, kspace_sim_3d
from ..utils.backend import as_f32, default_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices over named axes, the counterpart of ``jax.sharding.Mesh``:
    ``devices`` a numpy object array of ``torch.device``, one dimension per
    name of ``axis_names``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _factor(n: int, k: int) -> Tuple[int, ...]:
    """Factor n into k roughly-even factors (largest first)."""
    out = []
    rem = n
    for i in range(k - 1, 0, -1):
        f = 1
        for d in range(int(rem ** (1 / (i + 1))) + 1, 0, -1):
            if rem % d == 0:
                f = d
                break
        out.append(f)
        rem //= f
    out.append(rem)
    return tuple(sorted(out, reverse=True))


def make_mesh(devices: Optional[Sequence] = None,
              axes: Tuple[str, ...] = ("frame", "rx", "tx"),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """Build a device mesh over the physics axes.

    ``devices``: ``torch.device``s (or what ``torch.device`` takes), a device
    may repeat; default every visible CUDA device, raising without a card.
    ``shape``: the size of each axis; default :func:`_factor`'s split of the
    device count.

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.parallel import make_mesh
        mesh = make_mesh([torch.device("cpu")] * 8, axes=("rx", "tx"))
        assert mesh.shape == {"rx": 4, "tx": 2}
        assert int(np.prod(list(mesh.shape.values()))) == 8
    """
    if devices is None:
        default_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = _factor(n, len(axes))
    if int(np.prod(shape)) != n or len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} over axes {tuple(axes)} does not hold "
                         f"{n} devices")
    dev = np.empty(n, dtype=object)
    dev[:] = devices
    return Mesh(dev.reshape(tuple(shape)), tuple(axes))


def _check(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a qups_tpu_torch.parallel.Mesh, got {type(mesh).__name__}")
    return mesh


def _size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def _first(mesh: Mesh) -> torch.device:
    return mesh.devices.flat[0]


def _device(mesh: Mesh, **coords) -> torch.device:
    """The device at the named coordinates; index 0 on the other axes (a
    mesh axis an array is not sharded over replicates the work, which one
    process runs once)."""
    return mesh.devices[tuple(coords.get(a, 0) for a in mesh.axis_names)]


def _flat_devices(mesh: Mesh) -> list:
    """Every device of the mesh in C order: one shard each when an array
    axis shards over all mesh axes."""
    return list(mesh.devices.flat)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _rows(i: int, w: int, n: int) -> np.ndarray:
    """The indices ``[i w, (i + 1) w)`` of shard ``i`` clamped to ``n - 1``:
    a block padded by its edge."""
    return np.minimum(np.arange(i * w, (i + 1) * w), n - 1)


def _take(a, idx: np.ndarray, dim: int):
    """``a`` (numpy or a tensor) at the indices ``idx`` along ``dim``."""
    if isinstance(a, torch.Tensor):
        return a.index_select(dim, torch.as_tensor(idx, device=a.device))
    return np.take(np.asarray(a), idx, axis=dim)


def _zero_block(x: torch.Tensor, ranges, widths, dev) -> torch.Tensor:
    """The block ``x[ranges]`` on ``dev``, zero-padded at the end of each
    sharded dimension to ``widths`` (``ranges``, ``widths``: ``{dim: (start,
    stop)}``, ``{dim: width}``; stops past the end are clipped)."""
    sl = [slice(None)] * x.ndim
    shape = list(x.shape)
    short = False
    for d, (a, b) in ranges.items():
        a, b = min(a, x.shape[d]), min(b, x.shape[d])
        sl[d] = slice(a, b)
        shape[d] = widths[d]
        short = short or (b - a) < widths[d]
    blk = x[tuple(sl)].to(dev)
    if not short:
        return blk
    out = torch.zeros(shape, dtype=x.dtype, device=dev)
    out[tuple(slice(0, n) for n in blk.shape)] = blk
    return out


def _psum(parts, dev) -> torch.Tensor:
    """The sum of the shards' partial results on ``dev``, in shard order."""
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


def _gather(parts, dim: int, dev) -> torch.Tensor:
    """The shards' blocks joined along ``dim`` on ``dev``."""
    return torch.cat([p.to(dev) for p in parts], dim)


# ------------------------------------------------------------- DAS shards
@dataclasses.dataclass
class _Grid:
    """The (frame, rx, tx) shard grid of a DAS call on a mesh, and the
    shard widths."""
    mesh: Mesh
    N: int
    M: int
    F: Optional[int]
    nrx: int
    ntx: int
    nfr: int
    Nsh: int
    Msh: int
    Fsh: int

    @classmethod
    def of(cls, mesh: Mesh, N: int, M: int, F: Optional[int], rx_unit: int = 1) -> "_Grid":
        nrx, ntx = _size(mesh, "rx"), _size(mesh, "tx")
        nfr = _size(mesh, "frame") if F is not None else 1
        return cls(mesh, N, M, F, nrx, ntx, nfr, _ceil(N, nrx * rx_unit) * rx_unit,
                   _ceil(M, ntx), _ceil(F, nfr) if F is not None else 1)

    def shards(self):
        return itertools.product(range(self.nfr), range(self.nrx), range(self.ntx))

    def device(self, f: int, r: int, t: int) -> torch.device:
        return _device(self.mesh, frame=f, rx=r, tx=t)

    def block(self, x: torch.Tensor, f: int, r: int, t: int) -> torch.Tensor:
        """Shard (f, r, t)'s traces of ``x (T, N, M[, F])`` on its device,
        zero-padded to the shard widths."""
        ranges = {1: (r * self.Nsh, (r + 1) * self.Nsh), 2: (t * self.Msh, (t + 1) * self.Msh)}
        widths = {1: self.Nsh, 2: self.Msh}
        if self.F is not None:
            ranges[3], widths[3] = (f * self.Fsh, (f + 1) * self.Fsh), self.Fsh
        return _zero_block(x, ranges, widths, self.device(f, r, t))


def _frames(x, T: int, N: int, M: int) -> Tuple[torch.Tensor, tuple]:
    """Traces as a tensor ``(T, N, M[, F])``, the frame dims folded into one,
    and the frame dims."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if tuple(x.shape[:3]) != (T, N, M):
        raise ValueError(f"traces {tuple(x.shape)} do not match the plan's (T, N, M) = "
                         f"{(T, N, M)}")
    fd = tuple(x.shape[3:])
    return (x.reshape(T, N, M, -1) if fd else x), fd


def _post_lags(post, lags, N):
    """Validate/normalize the in-mesh coherence options -> lag list."""
    if post not in ("cohfac", "slsc"):
        raise ValueError(f"unknown post {post!r}")
    if post != "slsc":
        return []
    if lags is None:
        lags = max(1, N // 4)
    return list(range(1, lags + 1)) if np.isscalar(lags) \
        else [int(v) for v in lags]


def _post_reduce(post: str, lag_list, bands, *, N: int, dev) -> torch.Tensor:
    """The aperture-coherence reduction of the rx shards' kept bands
    ``(I, Nsh[, F])``, each on its own device: cohfac = coherent sum and
    power per band, summed; slsc 'average' unit-normalises each channel and
    serves the lag pairs across a band's end from a halo of the next band's
    first L channels (zeros after the last band; zero-padded channels are
    inert: magnitude 0, norm 1). Only image-sized sums reach ``dev``.
    Returns the real image (I[, F]) on ``dev``."""
    def parts(b):
        return (b.real, b.imag) if b.is_complex() else (b, None)

    if post == "cohfac":
        sums, pows = [], []
        for b in bands:
            br, bi = parts(b)
            sums.append(b.sum(1))
            pw = (br * br).sum(1)
            pows.append(pw if bi is None else pw + (bi * bi).sum(1))
        s, pw = _psum(sums, dev), _psum(pows, dev)
        num = s.real * s.real + s.imag * s.imag if s.is_complex() else s * s
        den = pw * np.float32(N)
        return num / torch.where(den == 0, torch.ones_like(den), den)
    L = max(lag_list)
    normed = []
    for b in bands:
        br, bi = parts(b)
        pw = br * br if bi is None else br * br + bi * bi
        mag = torch.sqrt(pw)
        nrm = torch.where(mag == 0, torch.ones_like(mag), mag)
        normed.append((br / nrm, None if bi is None else bi / nrm))
    Nsh = bands[0].shape[1]
    Ltot = len(lag_list)
    zs = []
    for i, (er, ei) in enumerate(normed):
        def ext(v, nxt):
            h = nxt[:, :L].to(v.device) if nxt is not None else torch.zeros_like(v[:, :L])
            return torch.cat([v, h], 1)

        last = i + 1 == len(normed)
        er_ = ext(er, None if last else normed[i + 1][0])
        ei_ = None if ei is None else ext(ei, None if last else normed[i + 1][1])
        z = torch.zeros(er.shape[:1] + er.shape[2:], dtype=torch.float32, device=er.device)
        for l in lag_list:
            w = np.float32(1.0 / (N - l) / 2.0 / Ltot)
            c = (er_[:, :Nsh] * er_[:, l:Nsh + l]).sum(1)
            if ei_ is not None:
                c = c + (ei_[:, :Nsh] * ei_[:, l:Nsh + l]).sum(1)
            z = z + (2.0 * w) * c
        zs.append(z)
    return _psum(zs, dev)


def _reduce_das(parts: dict, g: _Grid, *, keep_rx: bool, keep_tx: bool, post, lag_list,
                N: int) -> torch.Tensor:
    """The collectives of a sharded DAS: per frame shard, the tx shards
    summed (or gathered, ``keep_tx``) on the rx shard's device, then the rx
    shards summed, gathered (``keep_rx``) or reduced (``post``), then the
    frame shards gathered, on the mesh's first device. ``parts[(f, r, t)]``
    is a shard's image (I, N', M'[, F])."""
    dev = _first(g.mesh)
    frames = []
    for f in range(g.nfr):
        bands = []
        for r in range(g.nrx):
            home = g.device(f, r, 0)
            ts = [parts[f, r, t] for t in range(g.ntx)]
            bands.append(_gather(ts, 2, home) if keep_tx else _psum(ts, home))
        if post is not None:
            frames.append(_post_reduce(post, lag_list, [b[:, :, 0] for b in bands], N=N,
                                       dev=dev))
        else:
            frames.append(_gather(bands, 1, dev) if keep_rx else _psum(bands, dev))
    if g.F is None:
        return frames[0]
    return _gather(frames, 1 if post is not None else 3, dev)


def _finish(img: torch.Tensor, g: _Grid, fd: tuple, *, keep_rx, keep_tx, post) -> torch.Tensor:
    """Crop the padding of a reduced image and unfold its frames."""
    I = img.shape[0]
    if post is None:
        img = img[:, :(g.N if keep_rx else 1), :(g.M if keep_tx else 1)]
        if g.F is not None:
            img = img[:, :, :, :g.F]
        return img.reshape(img.shape[:3] + fd)
    if g.F is not None:
        img = img[:, :g.F]
    return img.reshape((I,) + fd)


def das_sharded(mesh: Mesh, x, pi, pr, pv, nv, t0, cinv, *, fs: float,
                apod=(), fmod: float = 0.0, tx_model: str = "virtual",
                keep_rx: bool = False, keep_tx: bool = False,
                method: str = "cubic", im_shape=None) -> torch.Tensor:
    """Sharded delay-and-sum over a (frame, rx, tx) mesh, each shard through
    :func:`qups_tpu_torch.ops.das.das` (plain PyTorch on its device, as the
    JAX package runs its XLA ``das`` here).

    ``x (T, N, M[, *F])`` shards N over 'rx', M over 'tx' and the frames
    (folded into one axis) over 'frame', each zero-padded to
    ``ceil(. / n)``; pixels and ``cinv`` (scalar or (I,)) replicate; ``t0``
    of M values and dense ``apod`` arrays (lifted to 5-D) shard with their N
    and M axes. The partial images are summed over rx and tx, or gathered
    with ``keep_rx`` / ``keep_tx``. Returns (I, N', M'[, *F]) on the mesh's
    first device.

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.parallel import make_mesh, das_sharded
        rng = np.random.default_rng(0)
        T, N, M = 128, 8, 4
        x = rng.standard_normal((T, N, M)).astype(np.float32)
        pi = np.stack([np.zeros(16), np.zeros(16),
                       np.linspace(10e-3, 25e-3, 16)], -1).astype(np.float32)
        pr = np.stack([np.linspace(-2e-3, 2e-3, N), np.zeros(N),
                       np.zeros(N)], -1).astype(np.float32)
        pv = np.zeros((M, 3), np.float32)
        nv = np.tile([0.0, 0.0, 1.0], (M, 1)).astype(np.float32)
        mesh = make_mesh([torch.device("cpu")] * 8, axes=("rx", "tx"))
        img = das_sharded(mesh, x, pi, pr, pv, nv,
                          np.zeros(M, np.float32), 1 / 1540.0, fs=4e6,
                          tx_model="plane", method="linear")
        assert img.shape == (16, 1, 1)
    """
    _check(mesh)
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    T, N, M = x.shape[:3]
    x, fd = _frames(x, T, N, M)
    g = _Grid.of(mesh, N, M, int(np.prod(fd)) if fd else None)
    t0 = as_f32(t0, "cpu").reshape(-1)
    apod = tuple(apod if isinstance(apod, (tuple, list)) else (apod,))
    parts = {}
    for f, r, t in g.shards():
        dev = g.device(f, r, t)
        ir, it = _rows(r, g.Nsh, N), _rows(t, g.Msh, M)
        ap = tuple(_shard_apod(a, ir, it, N, M).to(dev) for a in apod)
        parts[f, r, t] = das(g.block(x, f, r, t), pi, _take(pr, ir, 0), _take(pv, it, 0),
                             _take(nv, it, 0), t0[it] if t0.numel() == M else t0, cinv,
                             fs=fs, apod=ap, fmod=fmod, tx_model=tx_model,
                             keep_rx=keep_rx, keep_tx=keep_tx, method=method,
                             im_shape=im_shape)
    img = _reduce_das(parts, g, keep_rx=keep_rx, keep_tx=keep_tx, post=None, lag_list=(),
                      N=N)
    return _finish(img, g, fd, keep_rx=keep_rx, keep_tx=keep_tx, post=None)


def _plan_checks(name: str, precision: str, keep_rx: bool, keep_tx: bool, post, lags,
                 N: int):
    """The JAX package's refusals of a sharded kernel plan; returns
    ``(keep_rx, lag_list)`` (``post`` implies ``keep_rx``)."""
    if precision not in ("f32", "bf16pair"):
        raise ValueError(
            f"unknown precision {precision!r} for the sharded {name} plan "
            "(supported: 'f32', 'bf16pair'; 'i8x4' is single-device only: its "
            "quantization scale is per call)")
    if keep_rx and keep_tx:
        raise ValueError(f"{name} keeps at most one of rx/tx")
    if post is None:
        return keep_rx, []
    if keep_tx:
        raise ValueError("post reductions run across the rx aperture")
    return True, _post_lags(post, lags, N)


def _shard_apod(a, ir: np.ndarray, it: np.ndarray, N: int, M: int):
    """One apodization for shard (ir, it): a :class:`Fused` with a
    per-transmit ``lat_tx`` of M values takes the shard's transmits (the
    others are geometry and pass through); a dense array, lifted to 5-D,
    takes the shard's receivers and transmits on its N and M axes."""
    if isinstance(a, Fused):
        lt = a.p.get("lat_tx")
        if lt is not None and np.ndim(lt) and np.shape(lt)[0] == M:
            return Fused(a.kind, **dict(a.p, lat_tx=np.asarray(lt)[it]))
        return a
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, np.float32))
    a = a.reshape(tuple(a.shape) + (1,) * (5 - a.ndim))
    if a.shape[3] == N and N != 1:
        a = _take(a, ir, 3)
    if a.shape[4] == M and M != 1:
        a = _take(a, it, 4)
    return a


def _plan(mesh: Mesh, name: str, *, T, N, M, Fn, I, im_shape, keep_rx, keep_tx, post, lags,
          precision, per_shard, launch):
    """The common part of the sharded kernel plans: the checks, the shard
    grid (rx shards of 8-channel multiples), each shard's operands on its
    device once by ``per_shard(r, t, dev)``, and ``apply(x)``,
    which launches ``launch(xs, ops)`` on every shard and then reduces."""
    _check(mesh)
    keep_rx, lag_list = _plan_checks(name, precision, keep_rx, keep_tx, post, lags, N)
    g = _Grid.of(mesh, N, M, Fn, rx_unit=8)
    if post == "slsc" and max(lag_list) > g.Nsh:
        raise ValueError(f"slsc max lag {max(lag_list)} exceeds the rx shard width {g.Nsh} "
                         "(the halo spans one shard)")
    im_shape = tuple(im_shape) if im_shape is not None else (I, 1, 1)
    ops = {}
    for f, r, t in g.shards():
        dev = g.device(f, r, t)
        if (r, t, dev) not in ops:  # frame shards on one device share them
            ops[r, t, dev] = per_shard(r, t, dev)

    def apply(x) -> torch.Tensor:
        """Beamform traces ``(T, N, M[, *F])``, real or complex, numpy or a
        tensor on any device, through the plan."""
        x, fd = _frames(x, T, N, M)
        if (int(np.prod(fd)) if fd else None) != Fn:
            raise ValueError(f"traces of frames {fd} for a plan of Fn = {Fn}")
        # every shard's launch before the first reduction; the per-shard
        # operands are on their devices already, so the launches wait on no
        # host read (Fused tx kinds upload their lat_tx at each call)
        parts = {}
        for f, r, t in g.shards():
            dev = g.device(f, r, t)
            parts[f, r, t] = launch(g.block(x, f, r, t), ops[r, t, dev],
                                    keep_rx=keep_rx, keep_tx=keep_tx, im_shape=im_shape,
                                    precision=precision)
        img = _reduce_das(parts, g, keep_rx=keep_rx, keep_tx=keep_tx, post=post,
                          lag_list=lag_list, N=N)
        return _finish(img, g, fd, keep_rx=keep_rx, keep_tx=keep_tx, post=post)

    return apply


def das_sharded_pallas_plan(mesh: Mesh, pi, pr, pv, nv, t0, cinv, *,
                            fs: float, T: int, N: int, M: int,
                            Fn: Optional[int] = None, tx_model: str = "virtual",
                            im_shape=None, precision: str = "f32", method: str = "linear",
                            apod=(), orientations=None, lat=None,
                            keep_rx: bool = False, keep_tx: bool = False,
                            fmod: float = 0.0, post: Optional[str] = None, lags=None):
    """A reusable sharded DAS on kernel K1: each shard's operands, from
    :func:`qups_tpu_torch.ops.das_cuda.prep_sharded` on the mesh's first
    device, are copied to its device once, and ``apply(x)`` beamforms traces
    ``(T, N, M[, *F])`` (``Fn`` the product of the frame dims, or None)
    through :func:`qups_tpu_torch.ops.das_cuda.das_sum` on every shard
    (K1, K1(b) for IQ data and frames, K1(c) for the keep modes, K1(d) for
    the weights, K1(e) for 'bf16pair'; the plain version on a CPU device),
    then sums the partial images over rx and tx.
    :func:`das_sharded_pallas` is the one-shot form.

    The traces shard rx over 'rx' (shards of ``ceil(N / (n_rx 8)) 8``
    channels), tx over 'tx' and the frames over 'frame'; the pixels
    replicate. ``apod``: :class:`~qups_tpu_torch.ops.das_cuda.Fused`
    descriptors (a per-transmit ``lat_tx`` sliced with the tx shard) and
    dense arrays (their N and M axes sliced); ``orientations`` (2, N) slice
    with the rx shard. ``keep_rx`` / ``keep_tx`` (at most one) gather the
    kept axis. ``precision``: 'f32' or 'bf16pair'; 'i8x4' is refused, its
    scale being per call.

    ``post``: 'cohfac' | 'slsc' reduces over the aperture in the mesh
    (implies ``keep_rx``): each rx shard reduces its own band and only
    image-sized sums cross devices, slsc's lag pairs across a shard's end
    served by a halo of the next shard's first L channels. Returns the real
    coherence image (I[, *F]); ``lags`` as in
    :func:`qups_tpu_torch.ops.coherence.slsc` (at most the rx shard width).

    Returns (I, 1|N, 1|M[, *F]), complex64 for complex traces or ``fmod``.
    """
    _check(mesh)
    arrays, st = prep_sharded(pi, pr, pv, nv, t0, cinv, fs=fs, T=T, tx_model=tx_model,
                              im_shape=im_shape, nrx=_size(mesh, "rx"), ntx=_size(mesh, "tx"),
                              method=method, apod=apod, orientations=orientations, lat=lat,
                              device=_first(mesh))
    if (st["N"], st["M"]) != (N, M):
        raise ValueError(f"geometry of N = {st['N']}, M = {st['M']} for a plan of {(N, M)}")
    cinv = st["cinv"]

    def per_shard(r, t, dev):
        a = arrays
        return dict(pi=a["pi"].to(dev), pr=a["pr"][r].to(dev), pv=a["pv"][t].to(dev),
                    nv=a["nv"][t].to(dev), t0=a["t0"][t].to(dev),
                    lat=None if a["lat"] is None else a["lat"].to(dev),
                    ori=None if a["ori"] is None else a["ori"][r].to(dev),
                    apod=tuple(w if isinstance(w, Fused) else w.to(dev)
                               for w in a["apod"][r, t]))

    def launch(xs, o, **kw):
        return das_sum(xs, o["pi"], o["pr"], o["pv"], o["nv"], o["t0"], cinv, fs=fs,
                       tx_model=tx_model, method=method, fmod=fmod, apod=o["apod"],
                       orientations=o["ori"], lat=o["lat"], **kw)

    return _plan(mesh, "das_sharded_pallas", T=T, N=N, M=M, Fn=Fn, I=st["I"], im_shape=im_shape,
                 keep_rx=keep_rx, keep_tx=keep_tx, post=post, lags=lags,
                 precision=precision, per_shard=per_shard, launch=launch)


def das_sharded_pallas(mesh: Mesh, x, pi, pr, pv, nv, t0, cinv, *,
                       fs: float, tx_model: str = "virtual",
                       im_shape=None, precision: str = "f32", method: str = "linear",
                       apod=(), orientations=None, lat=None,
                       keep_rx: bool = False, keep_tx: bool = False,
                       fmod: float = 0.0, post: Optional[str] = None, lags=None):
    """One-shot sharded DAS on K1: :func:`das_sharded_pallas_plan` for the
    traces ``x (T, N, M[, *F])``, applied once (keep the plan to beamform
    more frames with the same geometry).

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.parallel import make_mesh, das_sharded_pallas
        rng = np.random.default_rng(0)
        T, N, M = 128, 16, 4
        x = rng.standard_normal((T, N, M)).astype(np.float32)
        pi = np.stack([np.zeros(256), np.zeros(256),
                       np.linspace(10e-3, 25e-3, 256)], -1).astype(np.float32)
        pr = np.stack([np.linspace(-2e-3, 2e-3, N), np.zeros(N),
                       np.zeros(N)], -1).astype(np.float32)
        pv = np.zeros((M, 3), np.float32)
        nv = np.tile([0.0, 0.0, 1.0], (M, 1)).astype(np.float32)
        mesh = make_mesh([torch.device("cpu")] * 4, axes=("rx", "tx"))
        cf = das_sharded_pallas(
            mesh, x, pi, pr, pv, nv, np.zeros(M, np.float32), 1 / 1540.0,
            fs=4e6, tx_model="plane", im_shape=(16, 16, 1), post="cohfac")
        assert cf.shape == (256,) and float(cf.max()) <= 1.0
    """
    T, N, M = np.shape(x)[:3]
    fd = tuple(np.shape(x)[3:])
    apply = das_sharded_pallas_plan(
        mesh, pi, pr, pv, nv, t0, cinv, fs=fs, T=T, N=N, M=M,
        Fn=int(np.prod(fd)) if fd else None, tx_model=tx_model, im_shape=im_shape,
        precision=precision, method=method, apod=apod, orientations=orientations, lat=lat,
        keep_rx=keep_rx, keep_tx=keep_tx, fmod=fmod, post=post, lags=lags)
    return apply(x)


def das_lut_sharded_pallas_plan(mesh: Mesh, tau_rx, tau_tx, t0, *,
                                fs: float, T: int, N: int, M: int,
                                Fn: Optional[int] = None, im_shape=None,
                                method: str = "linear",
                                keep_rx: bool = False, keep_tx: bool = False,
                                fmod: float = 0.0, precision: str = "f32",
                                post: Optional[str] = None, lags=None):
    """A reusable sharded LUT DAS on kernel K2: the delay tables shard with
    their axes, ``tau_rx (I, N)`` over 'rx' and ``tau_tx (I, M)`` over 'tx',
    each shard's columns (:func:`qups_tpu_torch.ops.das_cuda.prep_lut_sharded`
    on the mesh's first device) copied to its device once; ``apply(x)``
    runs :func:`qups_tpu_torch.ops.das_cuda.das_lut_sum` (K2, K2(b), K2(c),
    K2(e)) on every shard and reduces as :func:`das_sharded_pallas_plan`
    (``post`` too). :func:`das_lut_sharded_pallas` is the one-shot form."""
    _check(mesh)
    arrays, st = prep_lut_sharded(tau_rx, tau_tx, t0, fs=fs, T=T, im_shape=im_shape,
                                  nrx=_size(mesh, "rx"), ntx=_size(mesh, "tx"), method=method,
                                  device=_first(mesh))
    if (st["N"], st["M"]) != (N, M):
        raise ValueError(f"tables of N = {st['N']}, M = {st['M']} for a plan of {(N, M)}")

    def per_shard(r, t, dev):
        return dict(taur=arrays["taur"][r].to(dev), taut=arrays["taut"][t].to(dev),
                    t0=arrays["t0"][t].to(dev))

    def launch(xs, o, **kw):
        return das_lut_sum(xs, o["taur"], o["taut"], o["t0"], fs=fs, method=method, fmod=fmod,
                           **kw)

    return _plan(mesh, "das_lut_sharded_pallas", T=T, N=N, M=M, Fn=Fn, I=st["I"],
                 im_shape=im_shape, keep_rx=keep_rx, keep_tx=keep_tx, post=post, lags=lags,
                 precision=precision, per_shard=per_shard, launch=launch)


def das_lut_sharded_pallas(mesh: Mesh, x, tau_rx, tau_tx, t0, *, fs: float,
                           im_shape=None, method: str = "linear",
                           keep_rx: bool = False, keep_tx: bool = False,
                           fmod: float = 0.0, precision: str = "f32",
                           post: Optional[str] = None, lags=None):
    """One-shot sharded LUT DAS on K2 (the sharded spine of ``bfDAS``,
    ``bfDASLUT`` and ``bfEikonal``): :func:`das_lut_sharded_pallas_plan` for
    ``x (T, N, M[, *F])``, applied once."""
    T, N, M = np.shape(x)[:3]
    fd = tuple(np.shape(x)[3:])
    apply = das_lut_sharded_pallas_plan(
        mesh, tau_rx, tau_tx, t0, fs=fs, T=T, N=N, M=M, Fn=int(np.prod(fd)) if fd else None,
        im_shape=im_shape, method=method, keep_rx=keep_rx, keep_tx=keep_tx, fmod=fmod,
        precision=precision, post=post, lags=lags)
    return apply(x)


# ------------------------------------------------------------- simulators
def greens_sharded(mesh: Mesh, kern, ps, amp, pn, pv, *, T: int, s0: float,
                   t0k: float, fs: float, cinv, R0: float, fsr: float = 1.0,
                   method: str = "cubic", block: int = 32) -> torch.Tensor:
    """Sharded Green's-function FSA simulation by the scatter-add splat
    (:func:`qups_tpu_torch.ops.greens.greens_splat` on each shard's device,
    as the JAX package runs its XLA splat here, not K5).

    Scatterers shard over 'tx' (the worker axis; zero-padded to a multiple
    of ``n_tx block``), receive elements over 'rx' (padded by the edge);
    each shard splats its scatterers onto its (T, N/n_rx, M) slab, the
    scatterer partials are summed over 'tx' and the rx slabs gathered.
    Returns (T, N, M) on the mesh's first device."""
    _check(mesh)
    ps = np.asarray(ps, np.float32)
    amp = np.asarray(amp)
    pn = np.asarray(pn, np.float32)
    S, N = ps.shape[0], pn.shape[0]
    ntx, nrx = _size(mesh, "tx"), _size(mesh, "rx")
    Ssh = _ceil(S, ntx * block) * block
    Nsh = _ceil(N, nrx)
    ps = np.pad(ps, ((0, Ssh * ntx - S), (0, 0)))
    amp = np.pad(amp, (0, Ssh * ntx - S))
    parts = {}
    for r, t in itertools.product(range(nrx), range(ntx)):
        sl = slice(t * Ssh, (t + 1) * Ssh)
        parts[r, t] = greens_splat(kern, ps[sl], amp[sl], pn[_rows(r, Nsh, N)], pv, T=T,
                                   s0=s0, t0k=t0k, fs=fs, cinv=cinv, R0=R0, fsr=fsr,
                                   method=method, block=block,
                                   device=_device(mesh, rx=r, tx=t))
    dev = _first(mesh)
    slabs = [_psum([parts[r, t] for t in range(ntx)], _device(mesh, rx=r)) for r in range(nrx)]
    return _gather(slabs, 1, dev)[:, :N]


def greens_freq_sharded(mesh: Mesh, kern, ps, amp, pn, pv, *, T: int,
                        s0: float, t0k: float, fs: float, cinv, R0: float,
                        fsr: float = 1.0, rtol: float = 1e-6,
                        precision: str = "highest", engine: str = "auto",
                        alpha0: float = 0.0) -> torch.Tensor:
    """Sharded frequency-domain Green's-function simulation
    (:mod:`qups_tpu_torch.ops.greens_freq` over a mesh).

    Scatterers shard over 'tx' (the worker axis; padded with their edge
    position and zero amplitude), receive elements over 'rx' (padded by the
    edge). Each shard runs the per-bin phasor GEMM (kernel K3 on a CUDA
    device) on its (scatterer, rx) block; the partial spectra G (F, N/n_rx,
    M) are summed over 'tx' (one reduction for the whole simulation),
    gathered over 'rx', and synthesized once on the mesh's first device.
    The plan (FFT length, band, time bounds) is the unpadded cloud's.

    ``engine``: 'auto' | 'cuda' | 'plain', the shards' GEMM ('auto' is K3 on
    a CUDA device and the plain GEMM on the CPU; the JAX package's 'auto' |
    'pallas' | 'xla'). Returns (T, N, M) float32, complex64 for a complex
    kernel or amplitudes."""
    _check(mesh)
    if engine not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "cuda" and any(d.type != "cuda" for d in _flat_devices(mesh)):
        raise ValueError("engine='cuda' needs a mesh of CUDA devices")
    if precision not in ("highest", "default", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    plan = host_plan(kern, ps, pn, pv, T=T, s0=s0, t0k=t0k, fs=fs, cinv=cinv, fsr=fsr,
                     rtol=rtol)
    att = attenuation(alpha0, fs, plan)
    gemm = gemm_engine("plain" if engine == "plain" else "auto")
    psn, pnn = plan["ps"], plan["pn"]
    S, N = psn.shape[0], pnn.shape[0]
    ntx, nrx = _size(mesh, "tx"), _size(mesh, "rx")
    Ssh, Nsh = _ceil(S, ntx), _ceil(N, nrx)
    dev = _first(mesh)

    def gpass(a_real):
        a = np.pad(np.asarray(a_real, np.float32), (0, Ssh * ntx - S))
        parts = {}
        for r, t in itertools.product(range(nrx), range(ntx)):
            it = _rows(t, Ssh, S)  # edge positions, zero amplitudes
            parts[r, t] = gemm_pass(plan, psn[it], a[t * Ssh:(t + 1) * Ssh],
                                    pnn[_rows(r, Nsh, N)], R0=R0, fsr=fsr, att=att,
                                    bf16=precision == "bf16", gemm=gemm,
                                    device=_device(mesh, rx=r, tx=t))
        G = [_psum([parts[r, t] for t in range(ntx)], _device(mesh, rx=r))
             for r in range(nrx)]
        return _gather(G, 1, dev)[:, :N]

    return synthesize(gpass, plan, amp, T=T)


def fdtd_sharded(mesh: Mesh, c, rho, src_idx, src_sig_tx, *, steps: int,
                 dt: float, dx: float, c_ref: float, record_rows,
                 alpha0=None, alpha_power: float = 1.5, bona=None,
                 axis: str = "tx") -> torch.Tensor:
    """Transmit-sharded k-space PSTD simulation: the transmits shard over
    ``axis`` (zero signals pad them to a multiple of its size), and each
    shard runs its transmits as the leading batch of one stepper
    (:func:`qups_tpu_torch.sim.fdtd.kspace_sim_2d` / ``_3d``, in chunks of
    about ``sim.fdtd.BATCH_BYTES``) on its device; the maps and source
    nodes replicate, and nothing is reduced.

    Args:
      c, rho: (Nz, Nx[, Ny]) property maps (PML included).
      src_idx: (nd, Q) source node indices, the union over the transmits.
      src_sig_tx: (Mtx, steps, Q) per-transmit source signals.
      remaining args as :func:`qups_tpu_torch.sim.fdtd.kspace_sim_2d`.

    Returns (Mtx, steps, R, Nx[, Ny]) on the mesh's first device.

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.parallel import make_mesh, fdtd_sharded
        c = np.full((64, 64), 1500.0); rho = np.full((64, 64), 1000.0)
        sig = np.zeros((3, 40, 2), np.float32); sig[:, 5, :] = 1.0
        idx = np.array([[20, 20], [30, 34]])
        mesh = make_mesh([torch.device("cpu")] * 2, axes=("tx",))
        rec = fdtd_sharded(mesh, c, rho, idx, sig, steps=40, dt=4e-8,
                           dx=2e-4, c_ref=1500.0, record_rows=(40,))
        assert rec.shape == (3, 40, 1, 64)
    """
    _check(mesh)
    vol = np.ndim(c) == 3
    sig = np.asarray(src_sig_tx, np.float32)
    Mtx = sig.shape[0]
    n = _size(mesh, axis)
    Msh = _ceil(Mtx, n)
    sig = np.pad(sig, ((0, Msh * n - Mtx), (0, 0), (0, 0)))
    idx = np.asarray(src_idx)
    rows = tuple(int(r) for r in record_rows)
    kw = dict(steps=int(steps), dt=float(dt), dx=float(dx), c_ref=float(c_ref),
              record_rows=rows, alpha0=alpha0, alpha_power=float(alpha_power), bona=bona)
    shape = np.shape(c)
    chunk = batch_chunk(int(steps), len(rows) * int(np.prod(shape[1:])), idx.shape[1], shape)
    src = (idx,) if vol else (idx[0], idx[1])
    sim = kspace_sim_3d if vol else kspace_sim_2d
    parts = []
    for i in range(n):
        dev = _device(mesh, **{axis: i})
        recs = []
        for v0 in range(i * Msh, (i + 1) * Msh, chunk):
            sg = torch.as_tensor(np.ascontiguousarray(
                sig[v0:min(v0 + chunk, (i + 1) * Msh)].transpose(1, 0, 2)), device=dev)
            recs.append(sim(c, rho, *src, sg, device=dev, **kw).transpose(0, 1))
        parts.append(torch.cat(recs, 0))  # (Msh, steps, R, ...)
    return _gather(parts, 0, _first(mesh))[:Mtx]


# --------------------------------------------------- frequency-domain ops
def bf_adjoint_sharded(mesh: Mesh, x, tau_rx, tau_tx, del_tx, apod_tx,
                       t0, t0_off, fbins, *, fs: float, fmod: float = 0.0,
                       keep_rx: bool = False, keep_tx: bool = False,
                       precision: str = "bf16") -> torch.Tensor:
    """Pixel-sharded frequency-domain adjoint beamformer: the pixels
    (the rows of ``tau_rx (I, N)`` and ``tau_tx (I, M)``, zero-padded to a
    multiple of the device count) shard over every mesh axis; the channel
    and transmit spectra are computed once on the mesh's first device and
    copied to the others, and each shard runs kernel K4
    (:func:`qups_tpu_torch.ops.fdbf_cuda.adjoint_launch`; its plain version
    on a CPU device) on its rows. No reduction: the pixel blocks are
    gathered. Arguments as :func:`qups_tpu_torch.ops.fdbf.bf_adjoint`.
    Returns complex64 (I,), (I, N) or (I, V) on the mesh's first device.

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.parallel import make_mesh, bf_adjoint_sharded
        rng = np.random.default_rng(0)
        T, N, M, V, I = 64, 4, 4, 4, 24
        x = rng.standard_normal((T, N, V)).astype(np.float32)
        tau_rx = rng.uniform(0, 2e-6, (I, N)).astype(np.float32)
        tau_tx = rng.uniform(0, 2e-6, (I, M)).astype(np.float32)
        mesh = make_mesh([torch.device("cpu")] * 8, axes=("rx", "tx"))
        b = bf_adjoint_sharded(
            mesh, x, tau_rx, tau_tx, np.zeros((M, V), np.float32),
            np.eye(M, dtype=np.float32), np.zeros(V, np.float32),
            np.zeros(V, np.float32), np.arange(4, 12), fs=20e6, precision="f32")
        assert b.shape == (I,) and bool(b.abs().isfinite().all())
    """
    _check(mesh)
    if precision not in ADJ_PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {ADJ_PRECISIONS}")
    keep = keep_mode(keep_rx, keep_tx)
    dev0 = _first(mesh)
    x = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x)).to(dev0)
    N, V = x.shape[1], x.shape[2]
    I = np.shape(tau_rx)[0]
    spec = adjoint_spectra(x, del_tx, apod_tx, t0, t0_off, fbins, fs=fs, fmod=fmod)
    if spec is None:  # no bins: a zero image
        shape = (I, N) if keep == "rx" else ((I, V) if keep == "tx" else (I,))
        return torch.zeros(shape, dtype=torch.complex64, device=dev0)
    _, fk, Xk, Sk = spec
    devs = _flat_devices(mesh)
    Ish = _ceil(I, len(devs))
    cuda = dev0.type == "cuda"
    if cuda:
        ops = fdbf_cuda.adjoint_operands(fk, Xk, Sk, keep=keep, precision=precision)
    tau_rx, tau_tx = as_f32(tau_rx, dev0), as_f32(tau_tx, dev0)
    copies = {}
    parts = []
    for i, dev in enumerate(devs):
        if cuda != (dev.type == "cuda"):
            raise ValueError("a mesh mixes CUDA and other devices")
        rows = {0: (i * Ish, (i + 1) * Ish)}
        taur = _zero_block(tau_rx, rows, {0: Ish}, dev)
        taut = _zero_block(tau_tx, rows, {0: Ish}, dev)
        if dev not in copies:  # the spectra once per device
            copies[dev] = fdbf_cuda.operands_to(ops, dev) if cuda else \
                (fk.to(dev), Xk.to(dev), Sk.to(dev))
        c = copies[dev]
        parts.append(fdbf_cuda.adjoint_launch(c, taur, taut) if cuda else
                     adjoint_sum(*c, taur, taut, keep=keep, precision=precision))
    return _gather(parts, 0, dev0)[:I]


def refocus_op_sharded(mesh: Mesh, tau, apd, *, T: int, fs: float,
                       gamma=None, method: str = "tikhonov") -> torch.Tensor:
    """The REFoCUS decode operator ``Hi (T, M, V)`` with its frequency bins
    sharded over every mesh axis (the per-bin solves are independent):
    :func:`qups_tpu_torch.ops.fdbf.refocus_op` on each device's bins, the
    blocks gathered on the mesh's first device.

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.parallel import make_mesh, refocus_op_sharded
        mesh = make_mesh([torch.device("cpu")] * 4, axes=("tx",))
        Hi = refocus_op_sharded(mesh, np.zeros((4, 4)), np.eye(4), T=64, fs=8e6)
        assert Hi.shape == (64, 4, 4)
    """
    _check(mesh)
    devs = _flat_devices(mesh)
    f_all = fftfreq32(int(T), fs)
    Ksh = _ceil(int(T), len(devs))
    f_pad = np.pad(f_all, (0, Ksh * len(devs) - int(T)))
    tau = np.asarray(tau, np.float32)
    apd = np.asarray(apd, np.float32)
    parts = [refocus_op(tau, apd, T=int(T), fs=fs, gamma=gamma, method=method,
                        f=f_pad[i * Ksh:(i + 1) * Ksh], device=dev)
             for i, dev in enumerate(devs)]
    return _gather(parts, 0, _first(mesh))[:int(T)]


def refocus_sharded(mesh: Mesh, x, tau, apd, t0, *, fs: float, gamma=None,
                    method: str = "tikhonov", Hi=None):
    """REFoCUS decode over a mesh: the operator's bins shard
    (:func:`refocus_op_sharded`, unless ``Hi`` is given), then the receive
    channels of ``x (T, N, V, *F)`` shard over every mesh axis and each
    device applies the operator to its channels
    (:func:`qups_tpu_torch.ops.fdbf.refocus_apply`). Returns ``(y (T, N, M,
    *F), t0min)`` with ``y`` on the mesh's first device.

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.parallel import make_mesh, refocus_sharded
        rng = np.random.default_rng(0)
        x = rng.standard_normal((64, 8, 4)).astype(np.float32)
        mesh = make_mesh([torch.device("cpu")] * 4, axes=("tx",))
        y, t0m = refocus_sharded(mesh, x, np.zeros((4, 4)), np.ones((4, 4)),
                                 np.zeros(4), fs=8e6)
        assert y.shape == (64, 8, 4)
    """
    _check(mesh)
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    T, N = x.shape[0], x.shape[1]
    if Hi is None:
        Hi = refocus_op_sharded(mesh, tau, apd, T=T, fs=fs, gamma=gamma, method=method)
    devs = _flat_devices(mesh)
    Nsh = _ceil(N, len(devs))
    his, parts, t0min = {}, [], None
    for i, dev in enumerate(devs):
        if dev not in his:
            his[dev] = Hi.to(dev)
        xs = _zero_block(x, {1: (i * Nsh, (i + 1) * Nsh)}, {1: Nsh}, dev)
        y, t0min = refocus_apply(xs, his[dev], t0, fs=fs, device=dev)
        parts.append(y)
    return _gather(parts, 1, _first(mesh))[:, :N], t0min


def focus_tx_freq_sharded(mesh: Mesh, x, t2, w, *, fs: float) -> torch.Tensor:
    """Receive-sharded frequency-domain transmit synthesis
    (:func:`qups_tpu_torch.ops.fdbf.focus_tx_freq`): the FFT, the per-bin
    transmit GEMM and the inverse FFT are per receive channel, so the
    channels of ``x (T, N, M, *F)`` shard over every mesh axis and the
    (M, M') steering replicates. Returns (T, N, M', *F) on the mesh's first
    device.

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.parallel import make_mesh, focus_tx_freq_sharded
        rng = np.random.default_rng(0)
        x = rng.standard_normal((64, 8, 4)).astype(np.float32)
        t2 = rng.uniform(0, 1e-6, (4, 6)).astype(np.float32)
        mesh = make_mesh([torch.device("cpu")] * 4, axes=("tx",))
        y = focus_tx_freq_sharded(mesh, x, t2, np.ones((4, 6)), fs=8e6)
        assert y.shape == (64, 8, 6)
    """
    _check(mesh)
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    N = x.shape[1]
    devs = _flat_devices(mesh)
    Nsh = _ceil(N, len(devs))
    parts = [focus_tx_freq(_zero_block(x, {1: (i * Nsh, (i + 1) * Nsh)}, {1: Nsh}, dev),
                           t2, w, fs=fs)
             for i, dev in enumerate(devs)]
    return _gather(parts, 1, _first(mesh))[:, :N]


def migration_sharded(mesh: Mesh, x, t0, del_tx, angles_deg, *, fs: float,
                      c0: float, pitch: float, fmod: float = 0.0,
                      keep_tx: bool = False, method: str = "cubic",
                      jacobian: bool = True) -> torch.Tensor:
    """Plane-wave-angle-sharded Stolt f-k migration: the transmits of ``x
    (T, N, M, *F)`` shard over every mesh axis (zero traces pad them, their
    ``t0``, ``del_tx (N, M)`` columns and Garcia's ``gamma = sin(th) / (2 -
    cos(th))`` padded by the edge); each device migrates its transmits with
    :func:`qups_tpu_torch.ops.fdbf.stolt_migration` (``gamma`` given, no
    angles), and the images are summed, or gathered with ``keep_tx``.
    Returns complex64 (T, N, 1 | M, *F) on the mesh's first device.

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.parallel import make_mesh, migration_sharded
        rng = np.random.default_rng(0)
        T, N, M = 64, 16, 3
        x = rng.standard_normal((T, N, M)).astype(np.float32)
        mesh = make_mesh([torch.device("cpu")] * 2, axes=("tx",))
        b = migration_sharded(mesh, x, 0.0, np.zeros((N, M), np.float32),
                              (-5.0, 0.0, 5.0), fs=8e6, c0=1540.0, pitch=0.3e-3)
        assert b.shape == (T, N, 1)
    """
    _check(mesh)
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    M = x.shape[2]
    th = np.radians(np.asarray(angles_deg, np.float64)).reshape(-1)
    gamma = (np.sin(th) / (2 - np.cos(th))).astype(np.float32)
    t0v = np.broadcast_to(np.asarray(t0, np.float32).reshape(-1), (M,)).copy()
    del_tx = np.asarray(del_tx, np.float32)
    devs = _flat_devices(mesh)
    Msh = _ceil(M, len(devs))
    parts = []
    for i, dev in enumerate(devs):
        it = _rows(i, Msh, M)
        xs = _zero_block(x, {2: (i * Msh, (i + 1) * Msh)}, {2: Msh}, dev)
        parts.append(stolt_migration(xs, t0v[it], del_tx[:, it], (), fs=fs, c0=c0,
                                     pitch=pitch, fmod=fmod, keep_tx=keep_tx, method=method,
                                     jacobian=jacobian, gamma=gamma[it], device=dev))
    dev0 = _first(mesh)
    return _gather(parts, 2, dev0)[:, :, :M] if keep_tx else _psum(parts, dev0)
