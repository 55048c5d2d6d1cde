"""K4: the frequency-domain adjoint beamformer, hand-written CUDA for Hopper.

Replaces the TPU kernel ``qups_tpu/ops/fdbf_pallas.py::_kernel`` (launched
by ``_adj_call``, public entry ``bf_adjoint_tiled``) for sub-slice K4(a):
keep modes '' (summed), 'rx' and 'tx', dot precisions 'f32' and 'bf16', up
to 256 synthesized pulses (and, with keep_rx, 256 receivers). The source is
``csrc/fdbf.cu``, built and loaded by :mod:`qups_tpu_torch.ops._nvcc`. The
host/XLA glue of the TPU engine (``_prep_spectra``, ``_pack``, the
empty-bin case) is plain torch in :func:`qups_tpu_torch.ops.fdbf.
adjoint_spectra`, shared with the plain version; the TPU's 128-lane
padding is gone.

:func:`bf_adjoint_cuda` launches the kernel for a CUDA tensor, and raises
if it cannot be built or launched; it never falls back. For a CPU tensor it
runs :func:`qups_tpu_torch.ops.fdbf.bf_adjoint`, the plain version.
``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _nvcc
from .fdbf import (PRECISIONS, adjoint_spectra, bf_adjoint, keep_mode,
                   round_operand)
from ..utils.backend import as_f32, is_cuda

LAUNCHES = 0  # K4 launches in this process

MAX_COLS = 256  # receivers / pulses a block's 8 warps x 32 columns hold
_KEEP_CODE = {"": 0, "rx": 1, "tx": 2}


def build():
    """Build (if needed) and load ``csrc/fdbf.cu``; return ``(entry point,
    nvcc log)``. Raises ``RuntimeError`` with nvcc's output on failure."""
    lib, log = _nvcc.load("fdbf")
    fn = lib.adjoint_k4
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, log


def bf_adjoint_cuda(x: torch.Tensor, tau_rx, tau_tx, del_tx, apod_tx, t0,
                    t0_off, fbins, *, fs: float, fmod: float = 0.0,
                    keep_rx: bool = False, keep_tx: bool = False,
                    precision: str = "bf16") -> torch.Tensor:
    """Frequency-domain adjoint image, arguments and result as
    :func:`qups_tpu_torch.ops.fdbf.bf_adjoint`. On a CUDA tensor this
    launches K4; on a CPU tensor it runs the plain version."""
    global LAUNCHES
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    kw = dict(fs=fs, fmod=fmod, keep_rx=keep_rx, keep_tx=keep_tx,
              precision=precision)
    if not is_cuda(x):
        return bf_adjoint(x, tau_rx, tau_tx, del_tx, apod_tx, t0, t0_off,
                          fbins, **kw)
    keep = keep_mode(keep_rx, keep_tx)
    if x.ndim != 3:
        raise ValueError(f"K4 takes (T, N, V) traces, got {tuple(x.shape)}")
    dev = x.device
    N, V = x.shape[1], x.shape[2]
    if V > MAX_COLS or (keep == "rx" and N > MAX_COLS):
        raise NotImplementedError(
            f"bfAdjoint on CUDA (kernel K4): more than {MAX_COLS} synthesized "
            f"pulses (V = {V}) or, with keep_rx, receivers (N = {N}) is "
            "sub-slice K4(b)")
    tau_rx, tau_tx = as_f32(tau_rx, dev), as_f32(tau_tx, dev)
    I, M = tau_rx.shape[0], tau_tx.shape[1]
    if tau_rx.shape != (I, N) or tau_tx.shape[0] != I or np.shape(del_tx) != (M, V):
        raise ValueError("tables and sequence do not match the traces")
    shape = (I, N) if keep == "rx" else ((I, V) if keep == "tx" else (I,))
    out = torch.zeros(shape, dtype=torch.complex64, device=dev)
    spec = adjoint_spectra(x, del_tx, apod_tx, t0, t0_off, fbins, fs=fs,
                           fmod=fmod)
    if spec is None:  # no bins selected: a zero image, as the plain version
        return out
    _, fk, Xk, Sk = spec
    if keep == "rx":  # the kernel contracts conj(Ahat) (BI, V) x X_k^T (V, N)
        Xk = Xk.transpose(1, 2)
    # the operands the kernel reads as they are: rounded here for 'bf16'
    Sk, Xk = (round_operand(a, precision).contiguous() for a in (Sk, Xk))
    taur, taut = tau_rx.t().contiguous(), tau_tx.t().contiguous()
    cols = -(-max(V, N if keep == "rx" else 1) // 8)
    R = next(r for r in (1, 4, 16, 32) if r >= cols)
    fn, _ = build()
    rc = fn(fk.data_ptr(), taur.data_ptr(), taut.data_ptr(), Sk.data_ptr(),
            Xk.data_ptr(), out.data_ptr(), I, N, M, V, int(fk.shape[0]),
            _KEEP_CODE[keep], int(precision == "bf16"), R,
            *_nvcc.stream_args(dev))
    if rc != 0:
        raise RuntimeError(f"K4 launch failed with cudaError {rc}")
    LAUNCHES += 1
    return out
