"""K1 and K2: the DAS kernels, hand-written CUDA for Hopper.

K1 replaces the TPU kernel ``qups_tpu/ops/das_pallas.py::_kernel``
(geometry mode, launched by ``_das_call``, public entry ``das_tiled``) for
sub-slices K1(a)-(e): traces real or complex, the three transmit models,
the four samplers, any trailing frame dims, IQ remodulation (``fmod``),
the keep modes, apodization and the trace precisions. K2 replaces the
same TPU kernel in LUT mode (``lut=True``, launched by ``_das_lut_call``,
public entry ``das_lut_tiled``) for K2(a)-(c) and (e): the same sum with
the delays read from tables. Both are one kernel body in ``csrc/das.cu``,
built by :mod:`qups_tpu_torch.ops._nvcc` as ``das.cu`` without
remodulation (with the layout kernel) and ``das_iq.cu`` with it.

:func:`das_sum` (K1) and :func:`das_lut_sum` (K2) launch their kernel for a
CUDA tensor, and raise if it cannot be built or launched; they never fall
back. For a CPU tensor they run :func:`das_sum_plain` and
:func:`das_lut_sum_plain`, which are :func:`qups_tpu_torch.ops.das.das` and
:func:`qups_tpu_torch.ops.das.das_lut` on the rounded taps.
``LAUNCHES`` counts K1's launches and ``LUT_LAUNCHES`` K2's.

Before a launch the wrapper writes the traces ``(T, N, M, F)`` into the
kernels' edge-replicated layout for the sampler, a term's frames innermost
(the traces transposed to ``(M, N, T, F)`` for nearest, stencil entries for
the others): :func:`trace_layout`, which on the card launches the layout
kernel of the same source (counted by ``LAYOUT_LAUNCHES``) and on the CPU
runs its plain version :func:`trace_layout_plain`. A stencil holds 2 to 4
times the traces' bytes, so the wrapper lays out and sums the transmits by
chunks whose layout holds at most ``LAYOUT_BYTES`` (:func:`tx_chunks`; one
transmit's layout where that alone is larger): a call's peak device memory
is then the traces, the tables or geometry, the output and at most
``LAYOUT_BYTES`` more. Each chunk is one launch of the layout kernel and,
per block of ``FB`` frames, one of K1 or K2, which adds its sums to the
chunks' before it.

Keep modes and apodization (K1(c), K1(d), K2(c)) run in a third kernel of
the same body, ``das_keep_kernel`` (``csrc/das_keep.cu``, its remodulating
variants ``csrc/das_keep_iq.cu``): ``keep_rx``,
``keep_tx`` or both, any mix of :class:`Fused` descriptors (K1: evaluated
in the kernel, the plain version :func:`fused_weights`) and dense weight
arrays (K1 and K2), with frames and ``fmod``. ``KEEP_LAUNCHES`` counts its
K1 launches with a keep mode, ``APOD_LAUNCHES`` its K1 launches with
weights (a launch with both counts in both) and ``LUT_KEEP_LAUNCHES`` its
K2 launches. Calls without keep modes or weights run the kernels above,
unchanged.

Reduced-precision traces (K1(e), K2(e); ``precision=``, the TPU kernel's
modes): 'bf16pair' rounds every tap the kernels read to bfloat16 half away
from zero (the TPU kernel's ``_pack_pairs``), 'bf16' (K1 only) half to even
(its ``prep_real``), 'i8x4' (cubic and lanczos3 only) quantizes the taps to
int8 with one scale per transmit (K1) or per call (K2), ``_pack_quads``;
the weights, the rotation and the sums stay float32. The layout kernel
writes the rounded taps as narrow entries (:func:`trace_layout`: 2 bytes a
bf16 tap, 1 an int8 tap) and the same kernel body reads them, built in the
reduced-precision units, one per entry type (``csrc/das_bf16.cu``,
``das_i8.cu``, ``das_keep_bf16.cu``, ``das_keep_i8.cu`` and their ``_iq``
twins). ``QUPS_DAS_ACC16=1`` (read at each call, as the TPU package's
``das_tiled`` reads it) stores K1's kept sums (``keep_rx``, ``keep_tx``)
as bfloat16, half the bytes of the kept output, and returns them widened
to float32 (``das_keep_acc16.cu`` and its twin for float32 traces).
``PREC_LAUNCHES`` counts K1's launches of those units and
``LUT_PREC_LAUNCHES`` K2's; such a launch counts in no other counter. The
plain versions apply the same rounding (:func:`round_taps`) and the scale
per term, as the keep kernel applies it (the summed kernels apply it once
per transmit and chunk of receivers: the same up to float32 rounding).

The TPU package's kernel-level entry points have counterparts here under
their own names and arguments, on top of :func:`das_sum` and
:func:`das_lut_sum`: :func:`das_tiled` (K1), :func:`das_lut_plan` and
:func:`das_lut_tiled` (K2), and :func:`prep_sharded` /
:func:`prep_lut_sharded`, the operands of each shard of an (rx, tx) grid,
which :mod:`qups_tpu_torch.parallel.mesh` launches. They run on the CUDA
device unless given ``device="cpu"`` (the plain versions), and raise
``ValueError`` for the TPU package's transfer contracts: ``out='ri'``,
``interpret=True`` and uint16 wire-format traces.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import operator
import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import _nvcc
from .das import TX_MODELS, _lift5, das, das_lut, rx_distance
from .interp import METHODS, fft_upsample
from ..utils.backend import as_f32, default_device, is_cuda, refuse_tpu_contracts, tensor_on

LAUNCHES = 0  # K1 launches in this process
LUT_LAUNCHES = 0  # K2 launches in this process
LAYOUT_LAUNCHES = 0  # launches of the layout kernel, which K1 and K2 read
KEEP_LAUNCHES = 0  # das_keep_kernel's K1 launches with a keep mode (K1(c))
APOD_LAUNCHES = 0  # das_keep_kernel's K1 launches with weights (K1(d))
LUT_KEEP_LAUNCHES = 0  # das_keep_kernel's K2 launches (K2(c), dense weights)
PREC_LAUNCHES = 0  # K1 launches of the reduced-precision units (K1(e))
LUT_PREC_LAUNCHES = 0  # K2 launches of the reduced-precision units (K2(e))
LAYOUT_BYTES = 4 << 30  # the most a call's trace layout holds at once
TMAX = 1 << 22  # the longest trace the kernels take (csrc/das.cu)
FB = 4  # frames per launch (csrc/das.cu)
BLOCK, NC = 256, 32  # pixels per block, receivers per chunk (csrc/das.cu)
KR_BYTES = 64 << 10  # keep_rx's sums in shared memory, at most (csrc/das.cu)
RX_KINDS = {"aperture_growth": 1, "acceptance_angle": 4}  # csrc/das.cu RxKind
TX_KINDS = {"tx_scanline": 1, "tx_multiline": 2, "tx_parallelogram": 4}  # TxKind

_TX_CODE = {"plane": 0, "diverging": 1, "virtual": 2}
_METHOD_CODE = {"nearest": 0, "linear": 1, "cubic": 2, "lanczos3": 3}
DTYPES = (torch.float32, torch.complex64)
PRECISIONS = ("f32", "bf16pair", "bf16", "i8x4")  # the trace precisions of K1; K2 no bf16
_ENTRY = {"f32": 0, "bf16pair": 1, "bf16": 1, "i8x4": 2}  # csrc/das.cu Prec
_UNIT = {0: torch.float32, 1: torch.int16, 2: torch.int8}  # a layout's unit, by entry type


@dataclasses.dataclass(frozen=True)
class Fused:
    """A fused-geometry apodization descriptor, as
    :class:`qups_tpu.ops.das_pallas.Fused`: ``kind`` is 'aperture_growth'
    (``f``, ``Dmax``), 'acceptance_angle' (``theta`` degrees),
    'tx_scanline' (``tol``, ``lat_tx``), 'tx_multiline' (``dlat``,
    ``lat_tx``) or 'tx_parallelogram' (``xlo``, ``xhi``). K1 evaluates it in
    the kernel (K1(d); its plain version :func:`fused_weights`), in the
    scan's own units: ``lat_tx`` per transmit, ``tol``, ``dlat`` and the
    bounds on the pixels' lateral coordinate (x, or the angle of a polar
    scan). :meth:`materialize` gives the dense array of the system's
    generators instead, as the JAX package's XLA path takes it."""
    kind: str
    params: Tuple[Tuple[str, object], ...] = ()

    def __init__(self, kind: str, **params):
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "params", tuple(sorted(params.items())))

    @property
    def p(self):
        return dict(self.params)

    def materialize(self, us):
        """The dense (I1, I2, I3, N, M)-broadcastable float32 array of this
        descriptor from ``us``'s apodization generators, as the JAX
        package's ``Fused.materialize``: the transmit kinds take the
        sequence's foci (``tx_parallelogram`` also the array's bounds), not
        ``lat_tx``, ``dlat``, ``xlo`` or ``xhi``."""
        from ..system import (_ap_acceptance_angle, _ap_aperture_growth, _ap_multiline,
                              _ap_scanline, _ap_tx_parallelogram)
        p = self.p
        if self.kind == "aperture_growth":
            return _ap_aperture_growth(us, f=p.get("f", 1.5), Dmax=p.get("Dmax", np.inf))
        if self.kind == "acceptance_angle":
            return _ap_acceptance_angle(us, theta=p.get("theta", 45.0))
        if self.kind == "tx_scanline":
            return _ap_scanline(us, tol=p.get("tol"))
        if self.kind == "tx_multiline":
            return _ap_multiline(us)
        if self.kind == "tx_parallelogram":
            return _ap_tx_parallelogram(us)
        raise ValueError(f"unknown fused apodization {self.kind!r}")


def _f32(v) -> float:
    return float(np.float32(v))


def _lat_tx(a: "Fused") -> np.ndarray:
    if "lat_tx" not in a.p:
        raise ValueError(f"Fused({a.kind!r}) needs lat_tx, one lateral position a transmit")
    return np.asarray(a.p["lat_tx"], np.float32).reshape(-1)


def _param(a: "Fused", name: str) -> float:
    if name not in a.p:
        raise ValueError(f"Fused({a.kind!r}) needs {name}")
    return _f32(a.p[name])


def _orientations(orientations, N: int, dev) -> torch.Tensor:
    """(N, 2): sin and cos of each receiver's azimuth, from ``orientations``
    (2, N) as the JAX package passes them, default azimuth 0."""
    if orientations is None:
        return torch.tensor([[0.0, 1.0]], device=dev).expand(N, 2).contiguous()
    return as_f32(orientations, dev).reshape(2, N).T.contiguous()


def _rx_factor(a: "Fused", pi, pr, ori) -> torch.Tensor:
    """The (I, N) receive factor of one fused kind, as K1 computes it."""
    dx = pi[:, None, 0] - pr[None, :, 0]
    dz = pi[:, None, 2] - pr[None, :, 2]
    sa, ca = ori[None, :, 0], ori[None, :, 1]
    p = a.p
    if a.kind == "aperture_growth":
        d = dx * ca - dz * sa
        z = dz * ca + dx * sa
        m = z.abs() > _f32(2.0 * p.get("f", 1.5)) * d.abs()
        Dmax = float(p.get("Dmax", np.inf))
        if np.isfinite(Dmax):
            m = m & (2.0 * d.abs() < _f32(Dmax))
        return m.float()
    cth = _f32(np.cos(np.radians(p.get("theta", 45.0))))
    return ((dx * sa + dz * ca) >= cth * rx_distance(pi, pr)).float()


def _tx_factor(a: "Fused", pi, nv, lat) -> torch.Tensor:
    """The (I, M) transmit factor of one fused kind, as K1 computes it."""
    if a.kind == "tx_parallelogram":
        x0 = pi[:, None, 0] - nv[None, :, 0] * (pi[:, None, 2] / nv[None, :, 2])
        return ((x0 > _param(a, "xlo")) & (x0 <= _param(a, "xhi"))).float()
    lt = torch.as_tensor(_lat_tx(a), device=pi.device)
    dl = (lat[:, None] - lt[None, :]).abs()
    if a.kind == "tx_scanline":
        return (dl < _param(a, "tol")).float()
    return torch.clamp(1 - dl / _param(a, "dlat"), min=0.0)


def fused_weights(apod, pi, pr, nv, *, orientations=None, lat=None, device=None):
    """The plain version of K1(d): what the kernel computes in registers for
    :class:`Fused` descriptors (the TPU kernel's ``_rx_apod_weight`` and
    ``_tx_apod_weight``, on unscaled geometry), densely. Returns ``(wr,
    wt)``: the product of the receive kinds' factors (I, N) and of the
    transmit kinds' (I, M), float32 on ``device`` (default: that of ``pi``),
    ``None`` for a side without descriptors.

    Receive kinds, with (dx, dz) the pixel minus the receiver and (sa, ca)
    the sine and cosine of the receiver's azimuth (``orientations`` (2, N),
    default 0): 'aperture_growth' ``|dz ca + dx sa| > 2 f |dx ca - dz sa|``
    (and ``2 |d| < Dmax``), 'acceptance_angle' ``dx sa + dz ca >= cos(theta)
    |pixel - receiver|``. Transmit kinds, with ``lat`` (I,) the pixels'
    lateral coordinate (default their x): 'tx_scanline' ``|lat - lat_tx| <
    tol``, 'tx_multiline' ``max(0, 1 - |lat - lat_tx| / dlat)``,
    'tx_parallelogram' ``xlo < x - nvx z / nvz <= xhi`` with ``nv`` (M, 3)
    the transmits' directions."""
    dev = device if device is not None else (pi.device if isinstance(pi, torch.Tensor)
                                             else "cpu")
    pi, pr, nv = (as_f32(a, dev).reshape(-1, 3) for a in (pi, pr, nv))
    ori = _orientations(orientations, pr.shape[0], dev)
    lat = pi[:, 0] if lat is None else as_f32(lat, dev).reshape(-1)
    wr = wt = None
    for a in apod:
        if a.kind in RX_KINDS:
            w = _rx_factor(a, pi, pr, ori)
            wr = w if wr is None else wr * w
        elif a.kind in TX_KINDS:
            w = _tx_factor(a, pi, nv, lat)
            wt = w if wt is None else wt * w
        else:
            raise ValueError(f"unknown fused apodization {a.kind!r}")
    return wr, wt


def _apod_tuple(apod) -> tuple:
    return tuple(apod if isinstance(apod, (tuple, list)) else (apod,))


def _im_shape(im_shape, I: int) -> Tuple[int, int, int]:
    im_shape = tuple(int(d) for d in (im_shape or (I, 1, 1)))
    if len(im_shape) != 3 or int(np.prod(im_shape)) != I:
        raise ValueError(f"im_shape {im_shape} does not hold {I} pixels")
    return im_shape


def dense_apod(apod, pi, pr, nv, *, im_shape=None, orientations=None, lat=None,
               device=None) -> tuple:
    """``apod`` as dense arrays broadcastable to (I1, I2, I3, N, M): each
    :class:`Fused` through :func:`fused_weights` (receive factors as (I1,
    I2, I3, N, 1), transmit factors as (I1, I2, I3, 1, M)), dense arrays as
    they are. What the plain versions of K1(d) take."""
    fused = tuple(a for a in apod if isinstance(a, Fused))
    out = tuple(a for a in apod if not isinstance(a, Fused))
    if not fused:
        return out
    wr, wt = fused_weights(fused, pi, pr, nv, orientations=orientations, lat=lat,
                           device=device)
    im = _im_shape(im_shape, (wr if wr is not None else wt).shape[0])
    return out + tuple(w.reshape(im + shape) for w, shape in (
        (wr, (-1, 1)), (wt, (1, -1))) if w is not None)


# The libraries of the reduced-precision entry types (csrc/das_<name>.cu,
# csrc/das_keep_<name>.cu and their _iq twins), by entry type; F32X
# (float32 entries with bfloat16 kept sums) has a keep kernel alone.
_Q_LIBS = {1: "bf16", 2: "i8", 3: "acc16"}
F32X = 3  # csrc/das.cu Prec: float32 entries, the kept sums stored as bfloat16


def _entry(lib: str, name: str, iq: bool):
    """The entry point ``name`` (``name_iq`` with remodulation) in the
    library ``csrc/<lib>.cu`` (``<lib>_iq.cu``), and nvcc's log of its
    build."""
    sfx = "_iq" if iq else ""
    so, log = _nvcc.load(lib + sfx)
    return getattr(so, name + sfx), log


# The arguments a reduced-precision entry takes after its float32
# counterpart's and before (device, stream): prec, qs (, acc16 for the keep
# kernel).
_LP = [ctypes.c_int, ctypes.c_void_p]
_DEV = [ctypes.c_int, ctypes.c_void_p]


def _bind(lib: str, name: str, iq: bool, args: list):
    fn, log = _entry(lib, name, iq)
    fn.argtypes = args
    fn.restype = ctypes.c_int
    return fn, log


_K1_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 6
            + [ctypes.c_float] * 3 + [ctypes.c_int] * 4)
_K2_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2
            + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
            + [ctypes.c_int] * 3)
_KEEP_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
              + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_float] * 3
              + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
              + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)


def build(iq: bool = False):
    """Build (if needed) and load ``csrc/das.cu`` (``das_iq.cu`` with
    ``iq``, the remodulating variants); return ``(K1's entry point, nvcc
    log)``. Raises ``RuntimeError`` with nvcc's output on failure."""
    return _bind("das", "das_k1", iq, _K1_ARGS + _DEV)


def build_lut(iq: bool = False):
    """K2's entry point in the library of :func:`build`."""
    return _bind("das", "das_lut_k2", iq, _K2_ARGS + _DEV)[0]


def build_keep(iq: bool = False):
    """Build (if needed) and load ``csrc/das_keep.cu`` (das_keep_kernel:
    keep modes and weights of K1 and K2; ``das_keep_iq.cu`` with ``iq``,
    its remodulating variants); return ``(its entry point, nvcc log)``."""
    return _bind("das_keep", "das_keep", iq, _KEEP_ARGS + _DEV)


def build_q(q: int, iq: bool = False):
    """Build (if needed) and load the reduced-precision unit of entry type
    ``q`` (1 bf16: ``csrc/das_bf16.cu``, 2 int8: ``das_i8.cu``; their
    ``_iq`` twins with ``iq``), K1(e) and K2(e); return ``(K1's entry
    point, nvcc log)``."""
    return _bind("das_" + _Q_LIBS[q], "das_k1_q", iq, _K1_ARGS + _LP + _DEV)


def build_lut_q(q: int, iq: bool = False):
    """K2's entry point in the library of :func:`build_q`."""
    return _bind("das_" + _Q_LIBS[q], "das_lut_k2_q", iq, _K2_ARGS + _LP + _DEV)[0]


def build_keep_q(q: int, iq: bool = False):
    """Build (if needed) and load the keep kernel's unit of entry type ``q``
    (1 bf16: ``csrc/das_keep_bf16.cu``, 2 int8: ``das_keep_i8.cu``, 3
    float32 with bfloat16 kept sums: ``das_keep_acc16.cu``; their ``_iq``
    twins with ``iq``); return ``(its entry point, nvcc log)``."""
    return _bind("das_keep_" + _Q_LIBS[q], "das_keep_q", iq,
                 _KEEP_ARGS + _LP + [ctypes.c_int] + _DEV)


def check_precision(precision: str, method: str, lut: bool = False) -> None:
    """Raise ``ValueError`` where the TPU kernels raise: an unknown
    precision ('bf16' is K1's alone: ``das_lut_plan`` takes 'f32',
    'bf16pair' and 'i8x4'), and 'i8x4', which holds the four taps of a
    stencil, with a sampler other than cubic and lanczos3."""
    if precision not in PRECISIONS or (lut and precision == "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "i8x4" and method not in ("cubic", "lanczos3"):
        raise ValueError("precision='i8x4' packs the 4-tap stencil; use method='cubic' or "
                         "'lanczos3'")


def cast_traces(x: torch.Tensor) -> torch.Tensor:
    """Traces as K1 and K2 take them: real floating point (float64,
    float16, bfloat16) as float32, complex128 as complex64, as the TPU
    package uploads them (``_upload_trace``, ``prep_real``); others as
    they are (the kernels refuse them)."""
    if x.is_complex():
        return x.to(torch.complex64)
    return x.to(torch.float32) if x.is_floating_point() else x


def round_bf16_half_away(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with each value rounded to bfloat16 half away from
    zero, as float32: the TPU kernel's ``_pack_pairs``, ``(bits + 0x8000)
    >> 16`` on the magnitude's bits ('bf16pair')."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x8000) & -65536).view(torch.float32)


def round_bf16_even(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32, or each part of complex64) rounded to bfloat16 half
    to even, in its own type ('bf16': the TPU kernel's
    ``astype(jnp.bfloat16)``; the kept sums of ``QUPS_DAS_ACC16``)."""
    if x.is_complex():
        return torch.view_as_complex(round_bf16_even(torch.view_as_real(x)).contiguous())
    return x.to(torch.bfloat16).to(torch.float32)


def _magnitude(x: torch.Tensor) -> torch.Tensor:
    """|x|; for complex x as numpy and XLA compute it, ``hi sqrt(fma(r, r,
    1))`` with ``hi, lo`` the larger and smaller of |re|, |im| and ``r = lo
    / hi``, so that a scale is bit-equal to the TPU package's."""
    if not x.is_complex():
        return x.abs()
    r = torch.view_as_real(x).abs()
    hi, lo = torch.maximum(r[..., 0], r[..., 1]), torch.minimum(r[..., 0], r[..., 1])
    q = (lo / hi).double()
    m = hi * torch.sqrt((q * q + 1.0).float())
    return torch.where(hi == 0, torch.zeros_like(m), m)


def i8_scale(x: torch.Tensor, per_transmit: bool = True) -> torch.Tensor:
    """The 'i8x4' quantization scale of traces ``x (T, N, M, *F)``, float32
    ``(M,)`` on their device: ``s = max(max |x|, 1e-30)`` over the time,
    receivers and frames of each transmit (K1: das_pallas.py:2461-2479), or
    over all the traces, one scale per call repeated for every transmit
    (K2: :2076-2083). A complex trace's magnitude covers both parts."""
    xF = _frames(x)
    M = xF.shape[2]
    out = torch.empty(M, dtype=torch.float32, device=x.device)
    step = max(1, (16 << 20) // max(1, xF[:, :, :1].numel()))  # transmits a block
    for m0 in range(0, M, step):
        out[m0:m0 + step] = _magnitude(xF[:, :, m0:m0 + step]).amax(dim=(0, 1, 3))
    s = out if per_transmit else out.amax().expand(M)
    return torch.clamp(s, min=1e-30).contiguous()


def round_taps(x: torch.Tensor, precision: str, scale: Optional[torch.Tensor] = None):
    """The taps the kernels read at ``precision``, as float32 (complex64)
    on the device of ``x (T, N, M, *F)``: 'f32' ``x``; 'bf16pair' and 'bf16'
    each part rounded to bfloat16 (:func:`round_bf16_half_away`,
    :func:`round_bf16_even`); 'i8x4' the int8 values ``clip(round(x (127 /
    s_m)), -127, 127)`` of transmit m, ``127 / s_m`` rounded to float32 and
    round half to even (``_pack_quads``), ``scale`` the (M,) scales s."""
    if precision == "f32":
        return x
    r = torch.view_as_real(x) if x.is_complex() else x
    if precision == "bf16pair":
        q = round_bf16_half_away(r)
    elif precision == "bf16":
        q = round_bf16_even(r)
    else:
        scale = scale.to(torch.float32)
        # a true division: torch's scalar / tensor multiplies by a reciprocal
        inv = (torch.full_like(scale, 127.0) / scale).reshape((1, 1, -1) + (1,) * (r.ndim - 3))
        q = torch.clamp(torch.round(r * inv), -127.0, 127.0)
    return torch.view_as_complex(q.contiguous()) if x.is_complex() else q


def dequant(scale: torch.Tensor) -> torch.Tensor:
    """The 'i8x4' dequantization factors ``s / 127`` of scales ``s``, each a
    true float32 division (torch divides a CUDA tensor by a scalar as a
    product with its reciprocal), contiguous."""
    return (scale / torch.full_like(scale, 127.0)).contiguous()


def _acc16(keep_rx: bool, keep_tx: bool) -> bool:
    """K1 keeps its kept sums in bfloat16: ``QUPS_DAS_ACC16=1`` with a keep
    mode, read at each call as ``das_tiled`` reads it."""
    return os.environ.get("QUPS_DAS_ACC16", "0") == "1" and bool(keep_rx or keep_tx)


def stencil_entry(taps, method: str):
    """The floats of a stencil entry from the taps ``x[k-1], x[k], x[k+1],
    x[k+2]`` of its base ``k`` (tensors of one shape): linear
    ``(x[k], x[k+1] - x[k])``; cubic the coefficients ``c0 .. c3`` of the
    Catmull-Rom cubic ``c0 + u (c1 + u (c2 + u c3))`` in the fraction
    ``u`` (ops/interp.py's weights times the taps, regrouped); lanczos3 the
    four taps."""
    a, b, c, d = taps
    if method == "linear":
        return [b, c - b]
    if method == "cubic":
        return [b, 0.5 * (c - a), (a - 2.5 * b) + (2.0 * c - 0.5 * d),
                1.5 * (b - c) + 0.5 * (d - a)]
    return [a, b, c, d]


def build_layout():
    """The layout kernel's entry point in the library of :func:`build`."""
    return _bind("das", "das_layout", False, [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + _DEV)[0]


def build_layout_q(q: int):
    """The layout kernel's entry point for entry type ``q`` (``das_layout_q``)
    in the library of :func:`build_q`."""
    return _bind("das_" + _Q_LIBS[q], "das_layout_q", False,
                 [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int] + _DEV)[0]


def _frames(x: torch.Tensor) -> torch.Tensor:
    """Traces ``(T, N, M, *F)`` with their frame dims folded to one axis,
    ``(T, N, M, F)`` (F = 1 without frame dims)."""
    return x.reshape(tuple(x.shape[:3]) + (-1,))


def tx_chunks(x: torch.Tensor, method: str, precision: str = "f32"):
    """The ranges ``(m0, m1)`` of transmits of traces ``x (T, N, M, *F)``
    that K1 and K2 lay out and sum at once: as few chunks as keep each
    layout (every frame of its transmits, in the entry type of
    ``precision``: 4, 2 or 1 bytes a unit) within ``LAYOUT_BYTES``, of sizes
    within one of each other."""
    T, N, M = x.shape[:3]
    F = int(np.prod(x.shape[3:], dtype=np.int64))
    units = (2 if x.is_complex() else 1) * {"nearest": 1, "linear": 2}.get(method, 4)
    per_tx = _UNIT[_ENTRY[precision]].itemsize * units * T * N * F
    k = -(-M // max(1, LAYOUT_BYTES // per_tx))
    return [(M * j // k, M * (j + 1) // k) for j in range(k)]


def trace_layout(x: torch.Tensor, method: str, m0: int = 0, m1=None, precision: str = "f32",
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`trace_layout_plain` of transmits ``m0:m1`` of ``x``: for a
    CUDA tensor by the layout kernel of ``csrc/das.cu`` (``das_bf16.cu``,
    ``das_i8.cu`` at a reduced precision; bit for bit the same), else by
    the plain version.
    ``scale``: the (M,) 'i8x4' scales of all of x's transmits."""
    global LAYOUT_LAUNCHES
    m1 = x.shape[2] if m1 is None else m1
    sc = None if scale is None else scale[m0:m1]
    if not is_cuda(x):
        return trace_layout_plain(x[:, :, m0:m1], method, precision, sc)
    if x.dtype not in DTYPES or x.ndim not in (3, 4):
        raise ValueError(f"K1 and K2 take float32 or complex64 (T, N, M[, F]) traces, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected {METHODS}")
    check_precision(precision, method)
    prec = _ENTRY[precision]
    if precision == "i8x4" and (sc is None or sc.numel() != m1 - m0):
        raise ValueError("precision='i8x4' needs one scale per transmit")
    x = x.contiguous()
    T, N, M = x.shape[:3]
    fd = tuple(x.shape[3:])
    F = int(np.prod(fd, dtype=np.int64))
    if not 0 <= m0 < m1 <= M:
        raise ValueError(f"transmits {m0}:{m1} not in 0:{M}")
    if T > TMAX:
        raise ValueError(f"K1 and K2 take traces of at most {TMAX} samples, got {T}")
    cplx = x.is_complex()
    if method == "nearest" and not prec:
        shape, dtype = (m1 - m0, N, T) + fd, x.dtype
    else:
        shape = ((m1 - m0, N, T) + fd + ((2,) if cplx else ())
                 + ({"nearest": (), "linear": (2,)}.get(method, (4,))))
        dtype = _UNIT[prec]
    out = torch.empty(shape, dtype=dtype, device=x.device)
    args = (x.data_ptr() + m0 * F * x.element_size(), out.data_ptr(), T, N, m1 - m0, M, F,
            _METHOD_CODE[method], int(cplx))
    if prec:
        sc = None if sc is None else sc.to(device=x.device, dtype=torch.float32).contiguous()
        rc = build_layout_q(prec)(*args, prec, None if sc is None else sc.data_ptr(),
                                  int(precision == "bf16"), *_nvcc.stream_args(x.device))
    else:
        rc = build_layout()(*args, *_nvcc.stream_args(x.device))
    if rc != 0:
        raise RuntimeError(f"layout kernel launch failed with cudaError {rc}")
    LAYOUT_LAUNCHES += 1
    return out


def trace_layout_plain(x: torch.Tensor, method: str, precision: str = "f32",
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Traces ``x (T, N, M[, F])`` (float32 or complex64) as the kernels
    read them with the sampler ``method``, contiguous on the device of
    ``x``, one trace per (m, n), a term's frames next to each other:

    * nearest: the traces, ``(M, N, T[, F])`` of the trace type.
    * the others, stencils: entry ``k`` holds :func:`stencil_entry` of the
      taps of base ``k``, ``x[clamp(k + j, 0, T - 1)]`` for j in (-1, 0,
      1, 2): float32 ``(M, N, T[, F], 2 | 4)``; complex traces float32
      ``(M, N, T[, F], 2, 2 | 4)``, the real part's entry, then the
      imaginary part's.

    At a reduced ``precision`` the entries hold the rounded taps
    (:func:`round_taps`, ``scale`` the (M,) 'i8x4' scales) as their bits,
    int16 (bf16) or int8: nearest ``(M, N, T[, F][, 2])`` the sample,
    linear ``(..., 2)`` ``(x[k], x[k+1])``, cubic and lanczos3 ``(..., 4)``
    the four taps ``x[k-1..k+2]``.

    Every base ``k`` in ``[0, T - 1]`` then reads what the taps that
    ``ops/interp.py`` gathers with its indices clamped to ``[0, T - 1]``
    give, with no clamp in the kernel."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected {METHODS}")
    check_precision(precision, method)
    prec = _ENTRY[precision]
    x = round_taps(x, precision, scale)
    xt = x.permute(2, 1, 0, *range(3, x.ndim))  # (M, N, T[, F])
    if method == "nearest":
        if not prec:
            return xt.contiguous()
        s = torch.view_as_real(xt) if x.is_complex() else xt
    else:
        xp = torch.cat((xt[:, :, :1], xt, xt[:, :, -1:], xt[:, :, -1:]), dim=2)
        T = x.shape[0]
        xr = torch.view_as_real(xp) if x.is_complex() else xp[..., None]  # (M, N, T + 3[, F], C)
        taps = [xr[:, :, j:j + T] for j in range(4)]
        ent = taps[1:3] if prec and method == "linear" else taps if prec else \
            stencil_entry(taps, method)
        s = torch.stack(ent, -1)
        s = s if x.is_complex() else s[..., 0, :]
    if prec == 1:
        s = s.to(torch.bfloat16).view(torch.int16)  # exact: the taps are rounded
    elif prec == 2:
        s = s.to(torch.int8)
    return s.contiguous()


def tx_t0(t0, M: int) -> np.ndarray:
    """``t0`` as one start time per transmit, float32 ``(M,)``: a scalar,
    ``(1,)``, ``(M,)``, or a ``ChannelData`` t0 ``(1, 1, M | 1, 1, ...)``.
    Raises ``ValueError`` for a t0 that varies over receivers or frames:
    K1 and K2 take one per transmit."""
    a = t0.detach().cpu().numpy() if isinstance(t0, torch.Tensor) else np.asarray(t0)
    a = a.astype(np.float32)
    if a.ndim >= 2:
        a = a.reshape((1,) * max(0, 3 - a.ndim) + a.shape)
        if any(d != 1 for k, d in enumerate(a.shape) if k != 2):
            raise ValueError(
                f"t0 of shape {a.shape} varies over receivers or frames; K1 and K2 "
                "take one t0 per transmit")
    a = a.reshape(-1)
    if a.size not in (1, M):
        raise ValueError(f"t0 of {a.size} values for {M} transmits")
    return np.broadcast_to(a, (M,)).copy()


def _t0_on(t0, M: int, dev) -> torch.Tensor:
    """:func:`tx_t0` as a float32 (M,) tensor on ``dev``. A float32 (M,)
    tensor already on ``dev`` is taken as it is: no read on the host, so a
    caller that uploads its t0 once launches without waiting on the card."""
    if isinstance(t0, torch.Tensor) and t0.device == dev and t0.dtype == torch.float32 \
            and tuple(t0.shape) == (M,):
        return t0
    return torch.as_tensor(tx_t0(t0, M), device=dev)


def _launch_frames(x, method, fmod, launch, fb_max=FB, precision="f32", scale=None):
    """Lay out the chunks of transmits of ``x (T, N, M, *F)`` at
    ``precision`` (``scale``: its (M,) 'i8x4' scales) and call
    ``launch(layout, m0, m1, F, f0, fb, w, add)`` for each block of at most
    ``fb_max`` frames of each chunk: w = 2 pi fmod in float32, add 1 after
    the first chunk."""
    xF = _frames(x)
    F = xF.shape[3]
    w = float(np.float32(2 * np.pi * fmod))
    for j, (m0, m1) in enumerate(tx_chunks(xF, method, precision)):
        xl = trace_layout(xF, method, m0, m1, precision, scale)
        for f0 in range(0, F, fb_max):
            launch(xl, m0, m1, F, f0, min(fb_max, F - f0), w, int(j > 0))
        del xl  # the next chunk's layout may take its memory


def _check_traces(x: torch.Tensor, kern: str):
    if x.dtype not in DTYPES or x.ndim < 3:
        raise ValueError(f"{kern} takes float32 or complex64 (T, N, M, *F) traces, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[0] > TMAX:
        raise ValueError(f"{kern} takes traces of at most {TMAX} samples, got {x.shape[0]}")


def _kernel_fused(apod):
    """Split ``apod`` into (the Fused descriptors K1 evaluates in the kernel:
    the first of each kind, one ``lat_tx`` for the transmit kinds that take
    one; the other Fused descriptors; the dense arrays)."""
    kern, extra, dense, lat_tx = [], [], [], None
    for a in apod:
        if not isinstance(a, Fused):
            dense.append(a)
            continue
        if a.kind not in RX_KINDS and a.kind not in TX_KINDS:
            raise ValueError(f"unknown fused apodization {a.kind!r}")
        lt = _lat_tx(a) if a.kind in ("tx_scanline", "tx_multiline") else None
        if any(b.kind == a.kind for b in kern) or (
                lt is not None and lat_tx is not None and not np.array_equal(lt, lat_tx)):
            extra.append(a)
            continue
        kern.append(a)
        lat_tx = lt if lt is not None else lat_tx
    return kern, extra, dense, lat_tx


def _dense_weights(dense, im_shape, N: int, M: int, dev):
    """The dense weights as the kernel reads them: {'wr' | 'wt' | 'wd':
    (tensor, its 5 element strides over (I1, I2, I3, N, M), 0 on a
    broadcast axis)}, the product of the arrays that vary over the
    receivers only ('wr'; or over neither), the transmits only ('wt'), or
    both ('wd')."""
    full = tuple(im_shape) + (N, M)
    groups = {"wr": [], "wt": [], "wd": []}
    for a in dense:
        if a.is_complex() if isinstance(a, torch.Tensor) else np.iscomplexobj(a):
            raise ValueError("dense apodization must be real arrays")
        t = _lift5(as_f32(a, dev))
        if any(d not in (1, f) for d, f in zip(t.shape, full)):
            raise ValueError(f"apodization {tuple(t.shape)} does not broadcast to {full}")
        key = "wd" if t.shape[3] != 1 and t.shape[4] != 1 else ("wt" if t.shape[4] != 1
                                                                  else "wr")
        groups[key].append(t)
    out = {}
    for key, ts in groups.items():
        if ts:
            prod = functools.reduce(operator.mul, ts).contiguous()
            shape = full[:3] + ((1,) if key == "wt" else (N,)) + ((1,) if key == "wr" else (M,))
            out[key] = (prod, prod.expand(shape).stride())
    return out


def _das_keep(x: torch.Tensor, I: int, t0: torch.Tensor, *, fs, method, fmod, apod,
              keep_rx, keep_tx, im_shape, k1=None, k2=None, cinv=0.0, tx_model="plane",
              orientations=None, lat=None, precision="f32", scale=None,
              acc16=False) -> torch.Tensor:
    """K1 (``k1 = (pi, pr, pv, nv)`` on the card) or K2 (``k2 = (tau_rx,
    tau_tx)``) through das_keep_kernel: keep modes and weights, at
    ``precision`` (``scale``: the (M,) 'i8x4' scales), the kept sums
    stored as bfloat16 with ``acc16`` (half the output's bytes; widened to
    float32 here). Returns (I, N', M', *F), a view of the kernel's (N', M',
    F, I) output."""
    dev = x.device
    T, N, M = x.shape[:3]
    fd = tuple(x.shape[3:])
    F = int(np.prod(fd, dtype=np.int64))
    im_shape = _im_shape(im_shape, I)
    kern, extra, dense, lat_tx = _kernel_fused(apod)
    if k2 is not None and (kern or extra):
        raise TypeError("K2 takes dense apodization arrays; materialize a Fused descriptor "
                        "first (Fused.materialize)")
    if extra:  # a second descriptor of a kind: its plain version, as a dense weight
        dense += list(dense_apod(extra, k1[0], k1[1], k1[3], im_shape=im_shape,
                                 orientations=orientations, lat=lat, device=dev))
    wts = _dense_weights(dense, im_shape, N, M, dev)
    rx_bits = sum(RX_KINDS[a.kind] for a in kern if a.kind in RX_KINDS)
    tx_bits = sum(TX_KINDS[a.kind] for a in kern if a.kind in TX_KINDS)
    prm = [0.0, np.inf, 0.0, 0.0, 1.0, 0.0, 0.0]  # 2 f, Dmax, cos theta, tol, dlat, xlo, xhi
    for a in kern:
        p = a.p
        if a.kind == "aperture_growth":
            prm[0], prm[1] = _f32(2.0 * p.get("f", 1.5)), _f32(p.get("Dmax", np.inf))
            rx_bits |= 2 if np.isfinite(prm[1]) else 0  # AP_DMAX
        elif a.kind == "acceptance_angle":
            prm[2] = _f32(np.cos(np.radians(p.get("theta", 45.0))))
        elif a.kind == "tx_scanline":
            prm[3] = _param(a, "tol")
        elif a.kind == "tx_multiline":
            prm[4] = _param(a, "dlat")
        elif a.kind == "tx_parallelogram":
            prm[5], prm[6] = _param(a, "xlo"), _param(a, "xhi")
    ori = _orientations(orientations, N, dev) if rx_bits else None
    if tx_bits & 3:
        latg = (k1[0][:, 0] if lat is None else as_f32(lat, dev).reshape(-1)).contiguous()
        ltg = torch.as_tensor(lat_tx, device=dev)
        if latg.numel() != I or ltg.numel() != M:
            raise ValueError(f"lat ({latg.numel()}) and lat_tx ({ltg.numel()}) do not match "
                             f"{I} pixels and {M} transmits")
    else:
        latg = ltg = None
    cplx, iq = x.is_complex(), fmod != 0
    Np, Mp = (N if keep_rx else 1), (M if keep_tx else 1)
    sum_bytes = 8 if cplx or iq else 4  # a sum in the kernel
    if acc16:  # the kept sums as bfloat16, a pair for a complex sum: half the bytes
        out = torch.empty((Np, Mp, F, I) + ((2,) if cplx or iq else ()), dtype=torch.bfloat16,
                          device=dev)
    else:
        out = torch.empty((Np, Mp, F, I), dtype=torch.complex64 if cplx or iq else torch.float32,
                          device=dev)
    out_bytes = sum_bytes // 2 if acc16 else sum_bytes  # a kept sum in out
    of, om, on = I, F * I, Mp * F * I
    keep = int(keep_rx) + 2 * int(keep_tx)
    fb_max = FB if keep != 1 else max(1, min(FB, KR_BYTES // (BLOCK * NC * sum_bytes)))
    prec = _ENTRY[precision] or (F32X if acc16 else 0)
    lp = prec != 0  # a reduced-precision unit's launch
    fn, _ = build_keep_q(prec, iq) if lp else build_keep(iq)
    dq = None if scale is None else dequant(scale)
    nul = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lut = k2 is not None
    if lut:
        tau_rx, tau_tx = k2
    else:
        pi, pr, pv, nv = k1

    def launch(xl, m0, m1, F, f0, fb, w, add):
        global KEEP_LAUNCHES, APOD_LAUNCHES, LUT_KEEP_LAUNCHES, PREC_LAUNCHES
        global LUT_PREC_LAUNCHES
        strides, ptrs = [], []
        for key in ("wr", "wt", "wd"):
            t, st = wts.get(key, (None, (0,) * 5))
            strides += list(st)
            ptrs.append(None if t is None else t.data_ptr() + 4 * m0 * st[4])
        sa = (ctypes.c_longlong * 15)(*strides)
        pa = (ctypes.c_float * 7)(*prm)
        o = out.data_ptr() + (m0 * om * out_bytes if keep_tx else 0)
        geo = ((None,) * 4 + (tau_rx.data_ptr(), tau_tx[:, m0:].data_ptr(), M) if lut else
               (pi.data_ptr(), pr.data_ptr(), pv[m0:].data_ptr(), nv[m0:].data_ptr(), None,
                None, 0))
        rc = fn(xl.data_ptr(), *geo, t0[m0:].data_ptr(), o, I, N, m1 - m0, T, F, f0, fb,
                _f32(cinv), _f32(fs), w, 3 if lut else _TX_CODE[tx_model], _METHOD_CODE[method],
                int(cplx), int(iq), 0 if keep_tx else add, keep, on, om, of, im_shape[1],
                im_shape[2], *ptrs, ctypes.addressof(sa), rx_bits, tx_bits, nul(ori),
                nul(latg), None if ltg is None else ltg[m0:].data_ptr(), ctypes.addressof(pa),
                *((prec, None if dq is None else dq[m0:].data_ptr(), int(acc16)) if lp else ()),
                *_nvcc.stream_args(dev))
        if rc != 0:
            raise RuntimeError(f"{'K2' if lut else 'K1'} keep/apodization launch failed "
                               f"with cudaError {rc}")
        if lp and lut:
            LUT_PREC_LAUNCHES += 1
        elif lp:
            PREC_LAUNCHES += 1
        elif lut:
            LUT_KEEP_LAUNCHES += 1
        else:
            KEEP_LAUNCHES += int(keep != 0)
            APOD_LAUNCHES += int(bool(kern or wts))

    _launch_frames(x, method, fmod, launch, fb_max, precision, scale)
    if acc16:  # widened exactly to float32
        out = torch.view_as_complex(out.float()) if cplx or iq else out.float()
    return out.permute(3, 0, 1, 2).reshape((I, Np, Mp) + fd)


def _quantized(x: torch.Tensor, precision: str, apod: tuple, per_transmit: bool):
    """(the rounded taps of ``x``, ``apod`` with the 'i8x4' dequantization
    ``s_m / 127`` as a per-transmit weight (I1, I2, I3, N, M) = (1, 1, 1,
    1, M), applied per term as the keep kernel applies it; K1's and K2's
    summed kernels scale each transmit's sum over a chunk of NC receivers
    instead, the same up to float32 rounding)."""
    if precision != "i8x4":
        return round_taps(x, precision), apod
    s = i8_scale(x, per_transmit)
    return round_taps(x, precision, s), apod + (dequant(s).reshape(1, 1, 1, 1, -1),)


def _acc16_plain(x, pi, pr, pv, nv, t0, cinv, apod, *, keep_rx, keep_tx, method, precision,
                 **kw) -> torch.Tensor:
    """K1's kept sums stored as bfloat16 where the kernel stores them:
    keep_rx once a launch, after the transmits of each layout chunk
    (:func:`tx_chunks`) are added to the stored sums; keep_tx after each
    chunk of NC receivers is added; both once per term. ``x`` holds the
    rounded taps, ``apod`` the weights (the 'i8x4' scale among them)."""
    dev = x.device
    N = x.shape[1]
    pr, pv, nv = (as_f32(a, dev).reshape(-1, 3) for a in (pr, pv, nv))
    apod = tuple(_lift5(torch.as_tensor(a, device=dev)) for a in apod)

    def part(ns, ms):
        sub = tuple(a[:, :, :, ns if a.shape[3] != 1 else slice(None),
                      ms if a.shape[4] != 1 else slice(None)] for a in apod)
        return das(x[:, ns, ms], pi, pr[ns], pv[ms], nv[ms], t0[ms], cinv, apod=sub,
                   keep_rx=keep_rx, keep_tx=keep_tx, method=method, **kw)

    if keep_rx and keep_tx:
        return round_bf16_even(part(slice(None), slice(None)))
    if keep_rx:
        blocks = [(slice(None), slice(m0, m1)) for m0, m1 in tx_chunks(x, method, precision)]
    else:
        blocks = [(slice(n0, n0 + NC), slice(None)) for n0 in range(0, N, NC)]
    acc = None
    for ns, ms in blocks:
        v = part(ns, ms)
        acc = round_bf16_even(v if acc is None else acc + v)
    return acc


def das_sum_plain(x: torch.Tensor, pi, pr, pv, nv, t0, cinv, *, fs: float,
                  tx_model: str = "virtual", method: str = "cubic", fmod: float = 0.0,
                  apod=(), keep_rx: bool = False, keep_tx: bool = False, im_shape=None,
                  orientations=None, lat=None, precision: str = "f32") -> torch.Tensor:
    """The plain PyTorch version of K1 (K1(c)-(e)): the image (I, N', M',
    *F) on the device of ``x``, ``Fused`` descriptors through
    :func:`fused_weights`, the taps rounded to ``precision``
    (:func:`round_taps`; 'i8x4' one scale per transmit, applied per term),
    the kept sums rounded to bfloat16 where K1 stores them with
    ``QUPS_DAS_ACC16=1``."""
    check_precision(precision, method)
    x = cast_traces(x)
    apod = dense_apod(_apod_tuple(apod), pi, pr, nv, im_shape=im_shape,
                      orientations=orientations, lat=lat, device=x.device)
    xq, apod = _quantized(x, precision, apod, per_transmit=True)
    t0 = tx_t0(t0, x.shape[2])
    kw = dict(fs=fs, tx_model=tx_model, fmod=float(fmod), im_shape=im_shape)
    if _acc16(keep_rx, keep_tx):
        return _acc16_plain(xq, pi, pr, pv, nv, t0, cinv, apod, keep_rx=keep_rx,
                            keep_tx=keep_tx, method=method, precision=precision, **kw)
    return das(xq, pi, pr, pv, nv, t0, cinv, method=method, apod=apod, keep_rx=keep_rx,
               keep_tx=keep_tx, **kw)


def das_sum(x: torch.Tensor, pi, pr, pv, nv, t0, cinv, *, fs: float,
            tx_model: str = "virtual", method: str = "cubic", fmod: float = 0.0,
            apod=(), keep_rx: bool = False, keep_tx: bool = False, im_shape=None,
            orientations=None, lat=None, precision: str = "f32") -> torch.Tensor:
    """Geometry DAS image (I, N', M', *F) of traces ``x (T, N, M, *F)``,
    remodulated at ``fmod`` (complex64 when ``fmod != 0`` or the traces are
    complex), summed over the receivers unless ``keep_rx`` (N' = N) and the
    transmits unless ``keep_tx`` (M' = M).

    Arguments as :func:`qups_tpu_torch.ops.das.das`, with ``cinv`` a scalar
    and ``t0`` one start time per transmit (:func:`tx_t0`); ``apod`` dense
    arrays broadcastable to ``im_shape + (N, M)`` and :class:`Fused`
    descriptors, with ``orientations`` (2, N) the sine and cosine of each
    receiver's azimuth and ``lat`` (I,) each pixel's lateral coordinate
    (default its x) for them. ``precision``: 'f32', 'bf16pair', 'bf16' or
    'i8x4' (cubic and lanczos3 only): the taps K1 reads (K1(e)); float64,
    complex128 and bfloat16 traces are cast to float32 or complex64 first.
    With ``QUPS_DAS_ACC16=1`` and a keep mode the kept sums are stored as
    bfloat16 (returned as float32). On a CUDA tensor this launches K1
    (summed and unweighted), das_keep_kernel (K1(c), K1(d)) or their
    reduced-precision units (K1(e)); on a CPU tensor it runs
    :func:`das_sum_plain`.
    """
    apod = _apod_tuple(apod)
    check_precision(precision, method)
    x = cast_traces(x)
    if not is_cuda(x):
        return das_sum_plain(x, pi, pr, pv, nv, t0, cinv, fs=fs, tx_model=tx_model,
                             method=method, fmod=fmod, apod=apod, keep_rx=keep_rx,
                             keep_tx=keep_tx, im_shape=im_shape, orientations=orientations,
                             lat=lat, precision=precision)
    if tx_model not in TX_MODELS:
        raise ValueError(f"unknown tx model {tx_model!r}; expected {TX_MODELS}")
    if np.ndim(cinv) != 0:
        raise ValueError("K1 takes a scalar cinv")
    _check_traces(x, "K1")
    dev = x.device
    T, N, M = x.shape[:3]
    pi, pr, pv, nv = (as_f32(a, dev).reshape(-1, 3).contiguous()
                      for a in (pi, pr, pv, nv))
    if pr.shape[0] != N or pv.shape[0] != M or nv.shape[0] != M:
        raise ValueError(f"geometry does not match traces (T, N, M) = {(T, N, M)}")
    t0 = _t0_on(t0, M, dev)
    I = pi.shape[0]
    scale = i8_scale(x) if precision == "i8x4" else None
    if apod or keep_rx or keep_tx:
        return _das_keep(x, I, t0, fs=fs, method=method, fmod=fmod, apod=apod,
                         keep_rx=keep_rx, keep_tx=keep_tx, im_shape=im_shape,
                         k1=(pi, pr, pv, nv), cinv=cinv, tx_model=tx_model,
                         orientations=orientations, lat=lat, precision=precision,
                         scale=scale, acc16=_acc16(keep_rx, keep_tx))
    cplx = x.is_complex()
    iq = fmod != 0
    fd = tuple(x.shape[3:])
    out = torch.empty((I, int(np.prod(fd, dtype=np.int64))),
                      dtype=torch.complex64 if cplx or iq else torch.float32, device=dev)
    prec = _ENTRY[precision]
    fn, _ = build_q(prec, iq) if prec else build(iq)
    dq = None if scale is None else dequant(scale)

    def launch(xl, m0, m1, F, f0, fb, w, add):
        global LAUNCHES, PREC_LAUNCHES
        lp = (prec, None if dq is None else dq[m0:].data_ptr()) if prec else ()
        rc = fn(xl.data_ptr(), pi.data_ptr(), pr.data_ptr(), pv[m0:].data_ptr(),
                nv[m0:].data_ptr(), t0[m0:].data_ptr(), out.data_ptr(), I, N, m1 - m0, T,
                F, f0, fb, float(np.float32(cinv)), float(np.float32(fs)), w,
                _TX_CODE[tx_model], _METHOD_CODE[method], int(cplx), add, *lp,
                *_nvcc.stream_args(dev))
        if rc != 0:
            raise RuntimeError(f"K1 launch failed with cudaError {rc}")
        if prec:
            PREC_LAUNCHES += 1
        else:
            LAUNCHES += 1

    _launch_frames(x, method, fmod, launch, precision=precision, scale=scale)
    return out.view((I, 1, 1) + fd)


def _no_fused(apod):
    if any(isinstance(a, Fused) for a in apod):
        raise TypeError("K2 and das_lut take dense apodization arrays; materialize a Fused "
                        "descriptor first (Fused.materialize)")


def das_lut_sum_plain(x: torch.Tensor, tau_rx, tau_tx, t0, *, fs: float,
                      method: str = "cubic", fmod: float = 0.0, apod=(),
                      keep_rx: bool = False, keep_tx: bool = False,
                      im_shape=None, precision: str = "f32") -> torch.Tensor:
    """The plain PyTorch version of K2 (K2(c), K2(e)): the LUT DAS image
    (I, N', M', *F) on the device of ``x``, the taps rounded to
    ``precision`` ('i8x4': one scale per call, applied per term)."""
    check_precision(precision, method, lut=True)
    apod = _apod_tuple(apod)
    _no_fused(apod)
    x = cast_traces(x)
    xq, apod = _quantized(x, precision, apod, per_transmit=False)
    return das_lut(xq, tau_rx, tau_tx, tx_t0(t0, x.shape[2]), fs=fs, method=method,
                   fmod=float(fmod), apod=apod, keep_rx=keep_rx, keep_tx=keep_tx,
                   im_shape=im_shape)


def das_lut_sum(x: torch.Tensor, tau_rx, tau_tx, t0, *, fs: float,
                method: str = "cubic", fmod: float = 0.0, apod=(), keep_rx: bool = False,
                keep_tx: bool = False, im_shape=None, precision: str = "f32") -> torch.Tensor:
    """LUT DAS image (I, N', M', *F) of traces ``x (T, N, M, *F)`` with the
    delays ``tau = (tau_tx[i, m] + tau_rx[i, n]) - t0[m]``, remodulated at
    ``fmod``: tables ``tau_rx (I, N)``, ``tau_tx (I, M)`` [s], ``t0`` one
    start time per transmit (:func:`tx_t0`); keep modes and dense ``apod``
    as :func:`das_sum` (no :class:`Fused`). ``precision``: 'f32',
    'bf16pair' or 'i8x4' (one scale per call; K2(e)). On a CUDA tensor this
    launches K2 (summed and unweighted), das_keep_kernel (K2(c)) or their
    reduced-precision units (K2(e)); on a CPU tensor it runs
    :func:`das_lut_sum_plain`.
    """
    apod = _apod_tuple(apod)
    check_precision(precision, method, lut=True)
    x = cast_traces(x)
    if not is_cuda(x):
        return das_lut_sum_plain(x, tau_rx, tau_tx, t0, fs=fs, method=method, fmod=fmod,
                                 apod=apod, keep_rx=keep_rx, keep_tx=keep_tx,
                                 im_shape=im_shape, precision=precision)
    _no_fused(apod)
    _check_traces(x, "K2")
    dev = x.device
    T, N, M = x.shape[:3]
    tau_rx, tau_tx = (as_f32(a, dev).contiguous() for a in (tau_rx, tau_tx))
    I = tau_rx.shape[0]
    if tau_rx.shape != (I, N) or tau_tx.shape != (I, M):
        raise ValueError(f"tables {tuple(tau_rx.shape)}, {tuple(tau_tx.shape)} do "
                         f"not match traces (T, N, M) = {(T, N, M)}")
    t0 = _t0_on(t0, M, dev)
    scale = i8_scale(x, per_transmit=False) if precision == "i8x4" else None
    if apod or keep_rx or keep_tx:
        return _das_keep(x, I, t0, fs=fs, method=method, fmod=fmod, apod=apod,
                         keep_rx=keep_rx, keep_tx=keep_tx, im_shape=im_shape,
                         k2=(tau_rx, tau_tx), precision=precision, scale=scale)
    cplx = x.is_complex()
    iq = fmod != 0
    fd = tuple(x.shape[3:])
    out = torch.empty((I, int(np.prod(fd, dtype=np.int64))),
                      dtype=torch.complex64 if cplx or iq else torch.float32, device=dev)
    prec = _ENTRY[precision]
    fn = build_lut_q(prec, iq) if prec else build_lut(iq)
    dq = None if scale is None else dequant(scale)

    def launch(xl, m0, m1, F, f0, fb, w, add):
        global LUT_LAUNCHES, LUT_PREC_LAUNCHES
        lp = (prec, None if dq is None else dq[m0:].data_ptr()) if prec else ()
        rc = fn(xl.data_ptr(), tau_rx.data_ptr(), tau_tx[:, m0:].data_ptr(),
                t0[m0:].data_ptr(), out.data_ptr(), I, N, m1 - m0, M, T, F, f0, fb,
                float(np.float32(fs)), w, _METHOD_CODE[method], int(cplx), add, *lp,
                *_nvcc.stream_args(dev))
        if rc != 0:
            raise RuntimeError(f"K2 launch failed with cudaError {rc}")
        if prec:
            LUT_PREC_LAUNCHES += 1
        else:
            LUT_LAUNCHES += 1

    _launch_frames(x, method, fmod, launch, precision=precision, scale=scale)
    return out.view((I, 1, 1) + fd)


# ------------------------------------------- the TPU package's entry points
def _cubic2x(x: torch.Tensor, fs: float, method: str):
    """'cubic2x': the linear sampler on the traces upsampled 2x, band-limited
    (``fft_upsample``), at 2 fs, as the TPU package's ``_upsample2x_any``."""
    if method != "cubic2x":
        return x, fs, method
    return fft_upsample(x, 2, axis=0), float(fs) * 2.0, "linear"


def das_tiled(x, pi, pr, pv, nv, t0, cinv, *, fs: float, tx_model: str = "virtual",
              method: str = "linear", fmod: float = 0.0, im_shape=None, out: str = "complex",
              apod=(), keep_rx: bool = False, keep_tx: bool = False, lat=None,
              interpret: bool = False, orientations=None, precision: str = "f32",
              device=None) -> torch.Tensor:
    """The counterpart of ``qups_tpu.ops.das_pallas.das_tiled``: the DAS
    image of traces ``x (T, N, M, *F)`` on K1 (summed; K1(b) with frames or
    ``fmod``; K1(c) and (d) with keep modes or ``apod``; K1(e) at a reduced
    ``precision``), through :func:`das_sum`, on ``device`` (default the
    CUDA device, raising without one; ``device="cpu"`` runs the plain
    version). ``x`` may be numpy, a JAX array or a tensor on any device.

    Arguments as the JAX function's: ``method`` 'nearest' | 'linear'
    (default) | 'cubic' | 'lanczos3' | 'cubic2x'; ``precision`` 'f32' |
    'bf16pair' | 'bf16' | 'i8x4'; ``apod`` :class:`Fused` descriptors (a
    JAX one through :func:`qups_tpu_torch.convert.from_reference`) and, as
    :func:`das_sum` takes them, dense arrays; ``lat``, ``orientations`` for
    them. Returns (I, 1|N, 1|M, *F), complex64 for complex traces or
    ``fmod``. ``out='ri'``, ``interpret=True`` and uint16 traces raise
    ``ValueError``.

    Where the JAX function is at fault, this one follows the reference
    (ROADMAP Queue 3): a ``Fused`` transmit kind with ``lat_tx`` works
    (JAX raises ``NameError``, ``das_pallas.py:2557``); the 'i8x4' scale is
    taken from the traces' values (JAX takes it before the uint16 decode,
    ``:2471-2479``); ``tol`` and ``dlat`` are in the scan's lateral units
    (JAX compares them with lateral positions in seconds on a cartesian
    scan, ``:124-131``, ``:2189-2192``).

    Example:
        import numpy as np
        import torch
        from qups_tpu_torch.ops.das import das
        from qups_tpu_torch.ops.das_cuda import das_tiled
        rng = np.random.default_rng(0)
        T, N, M = 256, 16, 4
        x = rng.standard_normal((T, N, M)).astype(np.float32)
        Z, X = np.meshgrid(np.linspace(5e-3, 45e-3, 16),
                           np.linspace(-12e-3, 12e-3, 128), indexing="ij")
        pi = np.stack([X.ravel(), 0 * X.ravel(), Z.ravel()], -1)
        pr = np.stack([np.linspace(-12e-3, 12e-3, N), np.zeros(N),
                       np.zeros(N)], -1).astype(np.float32)
        pv = np.zeros((M, 3), np.float32)
        nv = np.tile([0.0, 0.0, 1.0], (M, 1)).astype(np.float32)
        t0 = np.zeros(M, np.float32)
        img = das_tiled(x, pi.astype(np.float32), pr, pv, nv, t0, 1 / 1540.0,
                        fs=4e6, tx_model="plane", method="cubic",
                        im_shape=(16, 128, 1), device="cpu")
        ref = das(torch.as_tensor(x), pi, pr, pv, nv, t0, 1 / 1540.0,
                  fs=4e6, tx_model="plane", method="cubic")
        assert float((img - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    """
    refuse_tpu_contracts(out, interpret)
    x, fs, method = _cubic2x(tensor_on(x, device), fs, method)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected {METHODS} or 'cubic2x'")
    return das_sum(x, pi, pr, pv, nv, t0, cinv, fs=fs, tx_model=tx_model, method=method,
                   fmod=fmod, apod=apod, keep_rx=keep_rx, keep_tx=keep_tx,
                   im_shape=im_shape, orientations=orientations, lat=lat,
                   precision=precision)


def das_lut_plan(tau_rx, tau_tx, t0, *, fs: float, T: int, N: int, M: int,
                 Fn: Optional[int] = None, cplx: bool = False, im_shape=None,
                 out: str = "complex", keep_rx: bool = False, keep_tx: bool = False,
                 fmod: float = 0.0, method: str = "linear", interpret: bool = False,
                 precision: str = "f32", device=None):
    """The counterpart of ``qups_tpu.ops.das_pallas.das_lut_plan``: a
    reusable LUT DAS on K2. The delay tables ``tau_rx (I, N)``, ``tau_tx (I,
    M)`` [s] (numpy, JAX arrays or tensors) and ``t0`` are uploaded to
    ``device`` (default the CUDA device; ``device="cpu"`` for the plain
    version) once, as float32, and the sampler, keep modes, ``fmod`` and
    ``precision`` ('f32', 'bf16pair', 'i8x4': one scale per call) are
    checked once; the returned ``apply(x)`` beamforms traces ``(T, N, M)``
    (``Fn`` None) or ``(T, N, M, *F)`` with ``prod(F) == Fn`` through
    :func:`das_lut_sum` against them, any number of times. Complex traces
    need ``cplx=True``; real ones with ``cplx=True`` are taken as complex.
    Returns (I, 1|N, 1|M, *F). ``out='ri'`` and ``interpret=True`` raise
    ``ValueError``. The traces' layout depends on the traces, so each call
    writes its own (the layout kernel)."""
    refuse_tpu_contracts(out, interpret)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected {METHODS}")
    check_precision(precision, method, lut=True)
    dev = default_device(device)
    taur, taut = (as_f32(a, dev).contiguous() for a in (tau_rx, tau_tx))
    I = taur.shape[0]
    if tuple(taur.shape) != (I, N) or tuple(taut.shape) != (I, M):
        raise ValueError(f"tables {tuple(taur.shape)}, {tuple(taut.shape)} do not match "
                         f"N = {N}, M = {M}")
    t0d = torch.as_tensor(tx_t0(t0, M), device=dev)
    im_shape = _im_shape(im_shape, I)

    def apply(x) -> torch.Tensor:
        """The plan's image of traces ``x``."""
        x = tensor_on(x, dev)
        fd = tuple(x.shape[3:])
        if tuple(x.shape[:3]) != (T, N, M) or (int(np.prod(fd)) if fd else None) != Fn:
            raise ValueError(f"traces {tuple(x.shape)} for a plan of (T, N, M) = {(T, N, M)}"
                             f", Fn = {Fn}")
        if x.is_complex() and not cplx:
            raise ValueError("complex traces for a plan of real ones (cplx=False)")
        x = x.to(torch.complex64) if cplx else x
        return das_lut_sum(x, taur, taut, t0d, fs=fs, method=method, fmod=fmod,
                           keep_rx=keep_rx, keep_tx=keep_tx, im_shape=im_shape,
                           precision=precision)

    return apply


def das_lut_tiled(x, tau_rx, tau_tx, t0, *, fs: float, im_shape=None, out: str = "complex",
                  keep_rx: bool = False, keep_tx: bool = False, fmod: float = 0.0,
                  method: str = "linear", interpret: bool = False, precision: str = "f32",
                  device=None) -> torch.Tensor:
    """The counterpart of ``qups_tpu.ops.das_pallas.das_lut_tiled``: the
    LUT DAS image of traces ``x (T, N, M, *F)`` on K2, :func:`das_lut_plan`
    applied once (``method='cubic2x'`` too: linear on the traces upsampled
    2x). Returns (I, 1|N, 1|M, *F) on ``device`` (default the CUDA
    device)."""
    refuse_tpu_contracts(out, interpret)
    x, fs, method = _cubic2x(tensor_on(x, device), fs, method)
    if x.ndim < 3:
        raise ValueError(f"traces (T, N, M, *F), got {tuple(x.shape)}")
    T, N, M = x.shape[:3]
    fd = tuple(x.shape[3:])
    plan = das_lut_plan(tau_rx, tau_tx, t0, fs=fs, T=T, N=N, M=M,
                        Fn=int(np.prod(fd)) if fd else None, cplx=x.is_complex(),
                        im_shape=im_shape, keep_rx=keep_rx, keep_tx=keep_tx, fmod=fmod,
                        method=method, precision=precision, device=x.device)
    return plan(x)


def _shard_widths(N: int, M: int, nrx: int, ntx: int) -> Tuple[int, int]:
    """The TPU package's kernel shard widths: ``ceil(N / (nrx 8)) 8``
    receivers, ``ceil(M / ntx)`` transmits."""
    return -(-N // (nrx * 8)) * 8, -(-M // ntx)


def prep_sharded(pi, pr, pv, nv, t0, cinv, *, fs: float, T: int, tx_model: str, im_shape,
                 nrx: int = 1, ntx: int = 1, method: str = "linear", pair: bool = False,
                 apod=(), orientations=None, lat=None, nch: int = 1, device=None):
    """The counterpart of ``qups_tpu.ops.das_pallas.prep_sharded``: K1's
    operands for each shard of an (``nrx``, ``ntx``) grid of receivers and
    transmits, stacked along a leading shard axis on ``device`` (default the
    CUDA device). Shard r takes receivers ``[r Nsh, (r + 1) Nsh)`` and shard
    t transmits ``[t Msh, (t + 1) Msh)``, with the JAX widths ``Nsh =
    ceil(N / (nrx 8)) 8`` and ``Msh = ceil(M / ntx)``; past the last element
    the geometry, ``t0``, orientations and ``lat_tx`` repeat the edge, and
    the caller pads the traces to (T, nrx Nsh, ntx Msh) with zeros. Shard
    (r, t)'s image is :func:`das_sum` of its block of traces with ``pi``,
    ``pr[r]``, ``pv[t]``, ``nv[t]``, ``t0[t]``, ``cinv``, ``orientations =
    ori[r]``, ``lat`` and ``apod[r, t]``; the sum over the shards is the
    image (:func:`qups_tpu_torch.parallel.das_sharded_pallas_plan`).

    Returns ``(arrays, statics)``: arrays ``pi`` (I, 3), ``pr`` (nrx, Nsh,
    3), ``ori`` (nrx, 2, Nsh) or None, ``pv``, ``nv`` (ntx, Msh, 3), ``t0``
    (ntx, Msh), ``lat`` (I,) or None, all float32, and ``apod`` {(r, t):
    the shard's apodization: :class:`Fused` with a per-transmit ``lat_tx``
    sliced to the shard, dense arrays on ``device`` sliced on their N and M
    axes}; statics ``Nsh``, ``Msh``, ``nrx``, ``ntx``, ``N``, ``M``, ``T``,
    ``I``, ``im_shape``, ``fs``, ``cinv``, ``tx_model``, ``method``. The
    positions stay unscaled and ``t0`` unshifted (the TPU package folds
    ``cinv`` into them, and 1/fs into t0 for the 4-tap samplers); its
    window plans and tiling (``boxes``, ``MC``, ``NC``, ``Tp``, ...) have no
    counterpart, and ``pair`` and ``nch``, which tune them, are accepted
    and ignored."""
    from ..parallel.mesh import _rows, _shard_apod, _take

    dev = default_device(device)
    pi, pr, pv, nv = (as_f32(a, dev).reshape(-1, 3) for a in (pi, pr, pv, nv))
    N, M, I = pr.shape[0], pv.shape[0], pi.shape[0]
    if nv.shape[0] != M:
        raise ValueError(f"{nv.shape[0]} transmit directions for {M} transmits")
    Nsh, Msh = _shard_widths(N, M, nrx, ntx)
    t0 = torch.as_tensor(tx_t0(t0, M), device=dev)
    ori = None if orientations is None else as_f32(orientations, dev).reshape(2, N)
    rows = [_rows(r, Nsh, N) for r in range(nrx)]
    cols = [_rows(t, Msh, M) for t in range(ntx)]
    apod = _apod_tuple(apod)
    arrays = dict(
        pi=pi, pr=torch.stack([_take(pr, ir, 0) for ir in rows]),
        ori=None if ori is None else torch.stack([_take(ori, ir, 1) for ir in rows]),
        pv=torch.stack([_take(pv, it, 0) for it in cols]),
        nv=torch.stack([_take(nv, it, 0) for it in cols]),
        t0=torch.stack([_take(t0, it, 0) for it in cols]),
        lat=None if lat is None else as_f32(lat, dev).reshape(-1),
        apod={(r, t): tuple(a if isinstance(a, Fused) else as_f32(a, dev)
                            for a in (_shard_apod(a, ir, it, N, M) for a in apod))
              for r, ir in enumerate(rows) for t, it in enumerate(cols)})
    statics = dict(Nsh=Nsh, Msh=Msh, nrx=nrx, ntx=ntx, N=N, M=M, T=T, I=I,
                   im_shape=_im_shape(im_shape, I), fs=fs,
                   cinv=float(np.asarray(cinv, np.float32).reshape(())), tx_model=tx_model,
                   method=method)
    return arrays, statics


def prep_lut_sharded(tau_rx, tau_tx, t0, *, fs: float, T: int, im_shape, nrx: int = 1,
                     ntx: int = 1, method: str = "linear", pair: bool = False, nch: int = 1,
                     device=None):
    """The counterpart of ``qups_tpu.ops.das_pallas.prep_lut_sharded``:
    K2's operands for each shard of an (``nrx``, ``ntx``) grid, stacked on
    ``device`` (default the CUDA device), with :func:`prep_sharded`'s
    widths and edge padding: arrays ``taur`` (nrx, I, Nsh), ``taut`` (ntx,
    I, Msh), ``t0`` (ntx, Msh), float32; statics ``Nsh``, ``Msh``, ``nrx``,
    ``ntx``, ``N``, ``M``, ``T``, ``I``, ``im_shape``, ``fs``, ``method``.
    Shard (r, t)'s image is :func:`das_lut_sum` of its block of traces with
    ``taur[r]``, ``taut[t]``, ``t0[t]``. The tables keep the port's (I, E)
    order (the TPU package's are (E, I1p, I2p) tiles) and ``t0`` is
    unshifted; ``pair`` and ``nch`` are accepted and ignored."""
    from ..parallel.mesh import _rows, _take

    dev = default_device(device)
    taur, taut = (as_f32(a, dev) for a in (tau_rx, tau_tx))
    I, N, M = taur.shape[0], taur.shape[1], taut.shape[1]
    if taur.ndim != 2 or tuple(taut.shape) != (I, M):
        raise ValueError(f"tables {tuple(taur.shape)}, {tuple(taut.shape)}: expected (I, N), "
                         "(I, M)")
    Nsh, Msh = _shard_widths(N, M, nrx, ntx)
    t0 = torch.as_tensor(tx_t0(t0, M), device=dev)
    cols = [_rows(t, Msh, M) for t in range(ntx)]
    arrays = dict(taur=torch.stack([_take(taur, _rows(r, Nsh, N), 1) for r in range(nrx)]),
                  taut=torch.stack([_take(taut, it, 1) for it in cols]),
                  t0=torch.stack([_take(t0, it, 0) for it in cols]))
    statics = dict(Nsh=Nsh, Msh=Msh, nrx=nrx, ntx=ntx, N=N, M=M, T=T, I=I,
                   im_shape=_im_shape(im_shape, I), fs=fs, method=method)
    return arrays, statics
