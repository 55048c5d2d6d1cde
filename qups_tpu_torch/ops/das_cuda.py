"""K1 and K2: the DAS kernels, hand-written CUDA for Hopper.

K1 replaces the TPU kernel ``qups_tpu/ops/das_pallas.py::_kernel``
(geometry mode, launched by ``_das_call``, public entry ``das_tiled``) for
sub-slice K1(a): summed output, float32 traces, real or complex (complex64
without remodulation), the three transmit models and the four samplers.
K2 replaces the same TPU kernel in LUT mode (``lut=True``, launched by
``_das_lut_call``, public entry ``das_lut_tiled``) for sub-slice K2(a): the
same sum with the delays read from tables. Both are one kernel body in
``csrc/das.cu``, built and loaded by :mod:`qups_tpu_torch.ops._nvcc`.

:func:`das_sum` (K1) and :func:`das_lut_sum` (K2) launch their kernel for a
CUDA tensor, and raise if it cannot be built or launched; they never fall
back. For a CPU tensor they run :func:`das_sum_plain` and
:func:`das_lut_sum_plain`, which are :func:`qups_tpu_torch.ops.das.das` and
:func:`qups_tpu_torch.ops.das.das_lut` with the same arguments.
``LAUNCHES`` counts K1's launches and ``LUT_LAUNCHES`` K2's.

Before a launch the wrapper writes the traces ``(T, N, M)`` into the
kernels' edge-replicated layout for the sampler (the traces transposed for
nearest, stencil entries for the others): :func:`trace_layout`, which on the
card launches the layout kernel of the same source (counted by
``LAYOUT_LAUNCHES``) and on the CPU runs its plain version
:func:`trace_layout_plain`. A stencil holds 2 to 4 times the traces' bytes,
so the wrapper lays out and sums the transmits by chunks whose layout holds
at most ``LAYOUT_BYTES`` (:func:`tx_chunks`; one transmit's layout where
that alone is larger): a call's peak device memory is then the traces, the
tables or geometry, the output and at most ``LAYOUT_BYTES`` more. Each chunk
is one launch of the layout kernel and one of K1 or K2, which adds its sum
to the chunks' before it.

``Fused`` is the descriptor class of the fused apodizations; the kernel does
not evaluate them yet (sub-slice K1(d)).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import _nvcc
from .das import TX_MODELS, das, das_lut
from .interp import METHODS
from ..utils.backend import as_f32, is_cuda

LAUNCHES = 0  # K1 launches in this process
LUT_LAUNCHES = 0  # K2 launches in this process
LAYOUT_LAUNCHES = 0  # launches of the layout kernel, which K1 and K2 read
LAYOUT_BYTES = 4 << 30  # the most a call's trace layout holds at once
TMAX = 1 << 22  # the longest trace the kernels take (csrc/das.cu)

_TX_CODE = {"plane": 0, "diverging": 1, "virtual": 2}
_METHOD_CODE = {"nearest": 0, "linear": 1, "cubic": 2, "lanczos3": 3}
DTYPES = (torch.float32, torch.complex64)


@dataclasses.dataclass(frozen=True)
class Fused:
    """A fused-geometry apodization descriptor, as
    :class:`qups_tpu.ops.das_pallas.Fused`: ``kind`` is 'aperture_growth',
    'acceptance_angle', 'tx_scanline', 'tx_multiline' or 'tx_parallelogram',
    with its parameters. Descriptor only: evaluating it, in the kernel or
    as a dense array, is sub-slice K1(d)."""
    kind: str
    params: Tuple[Tuple[str, object], ...] = ()

    def __init__(self, kind: str, **params):
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "params", tuple(sorted(params.items())))

    @property
    def p(self):
        return dict(self.params)


def build():
    """Build (if needed) and load ``csrc/das.cu``; return ``(K1's entry
    point, nvcc log)``. Raises ``RuntimeError`` with nvcc's output on
    failure."""
    lib, log = _nvcc.load("das")
    fn = lib.das_k1
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, log


def build_lut():
    """K2's entry point in the library of :func:`build`."""
    lib, _ = _nvcc.load("das")
    fn = lib.das_lut_k2
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    lib, _ = _nvcc.load("das")
    fn = lib.das_layout
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def tx_chunks(x: torch.Tensor, method: str):
    """The ranges ``(m0, m1)`` of transmits of traces ``x (T, N, M)`` that
    K1 and K2 lay out and sum at once: as few chunks as keep each layout
    within ``LAYOUT_BYTES``, of sizes within one of each other."""
    T, N, M = x.shape
    floats = (2 if x.is_complex() else 1) * {"nearest": 1, "linear": 2}.get(method, 4)
    per_tx = 4 * floats * T * N
    k = -(-M // max(1, LAYOUT_BYTES // per_tx))
    return [(M * j // k, M * (j + 1) // k) for j in range(k)]


def trace_layout(x: torch.Tensor, method: str, m0: int = 0, m1=None) -> torch.Tensor:
    """:func:`trace_layout_plain` of transmits ``m0:m1`` of ``x``: for a
    CUDA tensor by the layout kernel of ``csrc/das.cu`` (bit for bit the
    same), else by the plain version."""
    global LAYOUT_LAUNCHES
    m1 = x.shape[-1] if m1 is None else m1
    if not is_cuda(x):
        return trace_layout_plain(x[..., m0:m1], method)
    if x.dtype not in DTYPES or x.ndim != 3:
        raise ValueError(f"K1 and K2 take float32 or complex64 (T, N, M) traces, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected {METHODS}")
    x = x.contiguous()
    T, N, M = x.shape
    if not 0 <= m0 < m1 <= M:
        raise ValueError(f"transmits {m0}:{m1} not in 0:{M}")
    if T > TMAX:
        raise ValueError(f"K1 and K2 take traces of at most {TMAX} samples, got {T}")
    cplx = x.is_complex()
    if method == "nearest":
        shape, dtype = (m1 - m0, N, T), x.dtype
    else:
        shape = (m1 - m0, N, T) + ((2,) if cplx else ()) + (2 if method == "linear" else 4,)
        dtype = torch.float32
    out = torch.empty(shape, dtype=dtype, device=x.device)
    rc = build_layout()(x.data_ptr() + m0 * x.element_size(), out.data_ptr(), T, N,
                        m1 - m0, M, _METHOD_CODE[method], int(cplx),
                        *_nvcc.stream_args(x.device))
    if rc != 0:
        raise RuntimeError(f"layout kernel launch failed with cudaError {rc}")
    LAYOUT_LAUNCHES += 1
    return out


def trace_layout_plain(x: torch.Tensor, method: str) -> torch.Tensor:
    """Traces ``x (T, N, M)`` (float32 or complex64) as the kernels read
    them with the sampler ``method``, contiguous on the device of ``x``,
    one trace per (m, n):

    * nearest: the traces, ``(M, N, T)`` of the trace type.
    * the others, stencils: entry ``k`` holds :func:`stencil_entry` of the
      taps of base ``k``, ``x[clamp(k + j, 0, T - 1)]`` for j in (-1, 0,
      1, 2): float32 ``(M, N, T, 2 | 4)``; complex traces float32
      ``(M, N, T, 2, 2 | 4)``, the real part's entry, then the imaginary
      part's.

    Every base ``k`` in ``[0, T - 1]`` then reads what the taps that
    ``ops/interp.py`` gathers with its indices clamped to ``[0, T - 1]``
    give, with no clamp in the kernel."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected {METHODS}")
    xt = x.permute(2, 1, 0)  # (M, N, T)
    if method == "nearest":
        return xt.contiguous()
    xp = torch.cat((xt[..., :1], xt, xt[..., -1:], xt[..., -1:]), dim=-1)
    T = x.shape[0]
    xr = torch.view_as_real(xp) if x.is_complex() else xp[..., None]  # (M, N, T + 3, 1 | 2)
    s = torch.stack(stencil_entry([xr[:, :, j:j + T] for j in range(4)], method), -1)
    return (s if x.is_complex() else s[..., 0, :]).contiguous()


def das_sum_plain(x: torch.Tensor, pi, pr, pv, nv, t0, cinv, *, fs: float,
                  tx_model: str = "virtual", method: str = "cubic") -> torch.Tensor:
    """The plain PyTorch version of K1: summed DAS image (I, 1, 1) on the
    device of ``x``."""
    return das(x, pi, pr, pv, nv, t0, cinv, fs=fs, tx_model=tx_model,
               method=method)


def das_sum(x: torch.Tensor, pi, pr, pv, nv, t0, cinv, *, fs: float,
            tx_model: str = "virtual", method: str = "cubic") -> torch.Tensor:
    """Summed geometry DAS image (I, 1, 1) of traces ``x (T, N, M)``.

    Arguments as :func:`qups_tpu_torch.ops.das.das`, with ``cinv`` a scalar.
    On a CUDA tensor this launches K1 (float32 or complex64 traces); on a
    CPU tensor it runs :func:`das_sum_plain`.
    """
    global LAUNCHES
    if not is_cuda(x):
        return das_sum_plain(x, pi, pr, pv, nv, t0, cinv, fs=fs,
                             tx_model=tx_model, method=method)
    if tx_model not in TX_MODELS:
        raise ValueError(f"unknown tx model {tx_model!r}; expected {TX_MODELS}")
    if np.ndim(cinv) != 0:
        raise ValueError("K1 takes a scalar cinv")
    dev = x.device
    T, N, M = x.shape
    pi, pr, pv, nv = (as_f32(a, dev).reshape(-1, 3).contiguous()
                      for a in (pi, pr, pv, nv))
    if pr.shape[0] != N or pv.shape[0] != M or nv.shape[0] != M:
        raise ValueError(f"geometry does not match traces (T, N, M) = {(T, N, M)}")
    t0 = as_f32(t0, dev).reshape(-1).expand(M).contiguous()
    I = pi.shape[0]
    out = torch.empty(I, dtype=x.dtype, device=dev)
    fn, _ = build()
    for j, (m0, m1) in enumerate(tx_chunks(x, method)):
        xl = trace_layout(x, method, m0, m1)
        rc = fn(xl.data_ptr(), pi.data_ptr(), pr.data_ptr(), pv[m0:].data_ptr(),
                nv[m0:].data_ptr(), t0[m0:].data_ptr(), out.data_ptr(), I, N, m1 - m0, T,
                float(np.float32(cinv)), float(np.float32(fs)), _TX_CODE[tx_model],
                _METHOD_CODE[method], int(x.is_complex()), int(j > 0),
                *_nvcc.stream_args(dev))
        if rc != 0:
            raise RuntimeError(f"K1 launch failed with cudaError {rc}")
        LAUNCHES += 1
        del xl  # the next chunk's layout may take its memory
    return out.view(I, 1, 1)


def das_lut_sum_plain(x: torch.Tensor, tau_rx, tau_tx, t0, *, fs: float,
                      method: str = "cubic") -> torch.Tensor:
    """The plain PyTorch version of K2: summed LUT DAS image (I, 1, 1) on
    the device of ``x``."""
    return das_lut(x, tau_rx, tau_tx, t0, fs=fs, method=method)


def das_lut_sum(x: torch.Tensor, tau_rx, tau_tx, t0, *, fs: float,
                method: str = "cubic") -> torch.Tensor:
    """Summed LUT DAS image (I, 1, 1) of traces ``x (T, N, M)`` with the
    delays ``(tau_tx[i, m] + tau_rx[i, n]) - t0[m]``: tables ``tau_rx
    (I, N)``, ``tau_tx (I, M)`` [s], ``t0`` scalar or (M,). On a CUDA tensor
    this launches K2 (float32 or complex64 traces); on a CPU tensor it runs
    :func:`das_lut_sum_plain`.
    """
    global LUT_LAUNCHES
    if not is_cuda(x):
        return das_lut_sum_plain(x, tau_rx, tau_tx, t0, fs=fs, method=method)
    dev = x.device
    T, N, M = x.shape
    tau_rx, tau_tx = (as_f32(a, dev).contiguous() for a in (tau_rx, tau_tx))
    I = tau_rx.shape[0]
    if tau_rx.shape != (I, N) or tau_tx.shape != (I, M):
        raise ValueError(f"tables {tuple(tau_rx.shape)}, {tuple(tau_tx.shape)} do "
                         f"not match traces (T, N, M) = {(T, N, M)}")
    t0 = as_f32(t0, dev).reshape(-1).expand(M).contiguous()
    out = torch.empty(I, dtype=x.dtype, device=dev)
    fn = build_lut()
    for j, (m0, m1) in enumerate(tx_chunks(x, method)):
        xl = trace_layout(x, method, m0, m1)
        rc = fn(xl.data_ptr(), tau_rx.data_ptr(), tau_tx[:, m0:].data_ptr(),
                t0[m0:].data_ptr(), out.data_ptr(), I, N, m1 - m0, M, T,
                float(np.float32(fs)), _METHOD_CODE[method], int(x.is_complex()),
                int(j > 0), *_nvcc.stream_args(dev))
        if rc != 0:
            raise RuntimeError(f"K2 launch failed with cudaError {rc}")
        LUT_LAUNCHES += 1
        del xl  # the next chunk's layout may take its memory
    return out.view(I, 1, 1)
