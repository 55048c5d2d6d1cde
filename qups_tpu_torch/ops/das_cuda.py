"""K1 and K2: the DAS kernels, hand-written CUDA for Hopper.

K1 replaces the TPU kernel ``qups_tpu/ops/das_pallas.py::_kernel``
(geometry mode, launched by ``_das_call``, public entry ``das_tiled``) for
sub-slice K1(a): summed output, float32 traces, real or complex (complex64
without remodulation), the three transmit models and the four samplers.
K2 replaces the same TPU kernel in LUT mode (``lut=True``, launched by
``_das_lut_call``, public entry ``das_lut_tiled``) for sub-slice K2(a): the
same sum with the delays read from tables. Both live in ``csrc/das.cu``,
built and loaded by :mod:`qups_tpu_torch.ops._nvcc`.

:func:`das_sum` (K1) and :func:`das_lut_sum` (K2) launch their kernel for a
CUDA tensor, and raise if it cannot be built or launched; they never fall
back. For a CPU tensor they run :func:`das_sum_plain` and
:func:`das_lut_sum_plain`, which are :func:`qups_tpu_torch.ops.das.das` and
:func:`qups_tpu_torch.ops.das.das_lut` with the same arguments.
``LAUNCHES`` counts K1's launches and ``LUT_LAUNCHES`` K2's.

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
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, log


def build_lut():
    """K2's entry point in the library of :func:`build`."""
    lib, _ = _nvcc.load("das")
    fn = lib.das_lut_k2
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    if x.dtype not in DTYPES or x.ndim != 3:
        raise ValueError(f"K1 takes float32 or complex64 (T, N, M) traces, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if tx_model not in TX_MODELS:
        raise ValueError(f"unknown tx model {tx_model!r}; expected {TX_MODELS}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected {METHODS}")
    if np.ndim(cinv) != 0:
        raise ValueError("K1 takes a scalar cinv")
    dev = x.device
    T, N, M = x.shape
    xt = x.permute(2, 1, 0).contiguous()  # (M, N, T): one trace per (m, n)
    cplx = x.is_complex()
    pi, pr, pv, nv = (as_f32(a, dev).reshape(-1, 3).contiguous()
                      for a in (pi, pr, pv, nv))
    if pr.shape[0] != N or pv.shape[0] != M or nv.shape[0] != M:
        raise ValueError(f"geometry does not match traces (T, N, M) = {(T, N, M)}")
    t0 = as_f32(t0, dev).reshape(-1).expand(M).contiguous()
    I = pi.shape[0]
    out = torch.empty(I, dtype=x.dtype, device=dev)
    fn, _ = build()
    rc = fn(xt.data_ptr(), pi.data_ptr(), pr.data_ptr(), pv.data_ptr(),
            nv.data_ptr(), t0.data_ptr(), out.data_ptr(), I, N, M, T,
            float(np.float32(cinv)), float(np.float32(fs)), _TX_CODE[tx_model],
            _METHOD_CODE[method], int(cplx), *_nvcc.stream_args(dev))
    if rc != 0:
        raise RuntimeError(f"K1 launch failed with cudaError {rc}")
    LAUNCHES += 1
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
    if x.dtype not in DTYPES or x.ndim != 3:
        raise ValueError(f"K2 takes float32 or complex64 (T, N, M) traces, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected {METHODS}")
    dev = x.device
    T, N, M = x.shape
    tau_rx, tau_tx = as_f32(tau_rx, dev), as_f32(tau_tx, dev)
    I = tau_rx.shape[0]
    if tau_rx.shape != (I, N) or tau_tx.shape != (I, M):
        raise ValueError(f"tables {tuple(tau_rx.shape)}, {tuple(tau_tx.shape)} do "
                         f"not match traces (T, N, M) = {(T, N, M)}")
    # (M, N, T) traces and (N, I), (M, I) tables: a warp's reads at one
    # (m, n) are 32 neighbouring pixels' table entries and nearby samples
    xt = x.permute(2, 1, 0).contiguous()
    taur, taut = tau_rx.t().contiguous(), tau_tx.t().contiguous()
    t0 = as_f32(t0, dev).reshape(-1).expand(M).contiguous()
    out = torch.empty(I, dtype=x.dtype, device=dev)
    rc = build_lut()(xt.data_ptr(), taur.data_ptr(), taut.data_ptr(),
                     t0.data_ptr(), out.data_ptr(), I, N, M, T,
                     float(np.float32(fs)), _METHOD_CODE[method],
                     int(x.is_complex()), *_nvcc.stream_args(dev))
    if rc != 0:
        raise RuntimeError(f"K2 launch failed with cudaError {rc}")
    LUT_LAUNCHES += 1
    return out.view(I, 1, 1)
