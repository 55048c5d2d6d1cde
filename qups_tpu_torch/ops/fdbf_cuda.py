"""K4: the frequency-domain adjoint beamformer, hand-written CUDA for Hopper.

Replaces the TPU kernel ``qups_tpu/ops/fdbf_pallas.py::_kernel`` (launched
by ``_adj_call``, public entry ``bf_adjoint_tiled``): keep modes ''
(summed), 'rx' and 'tx', dot precisions 'f32' (CUDA cores) and 'bf16'
(tensor cores), any number of synthesized pulses and receivers (K4(a) and
K4(b); :func:`rx_chunk` plans keep_rx's conj(Ahat) in chunks where it does
not fit in shared memory). The source is ``csrc/fdbf.cu``, built and loaded by
:mod:`qups_tpu_torch.ops._nvcc`. The host/XLA glue of the TPU engine
(``_prep_spectra``, ``_pack``, the empty-bin case) is plain torch in
:func:`qups_tpu_torch.ops.fdbf.adjoint_spectra`, shared with the plain
version; the TPU's 128-lane padding is gone. For 'bf16' the wrapper packs
the per-bin spectra into the real-block operands of the tensor-core GEMMs
(:func:`block_operand`).

:func:`bf_adjoint_cuda` launches the kernel for a CUDA tensor, and raises
if it cannot be built or launched; it never falls back. For a CPU tensor it
runs :func:`qups_tpu_torch.ops.fdbf.bf_adjoint`, the plain version.
``LAUNCHES`` counts the kernel launches. :func:`bf_adjoint_tiled` is the
counterpart of the TPU package's entry of the same name, on the CUDA
device unless given ``device="cpu"``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _nvcc
from .fdbf import PRECISIONS, adjoint_spectra, bf_adjoint, keep_mode
from ..utils.backend import as_f32, is_cuda, refuse_tpu_contracts, tensor_on

LAUNCHES = 0  # K4 launches in this process

_KEEP_CODE = {"": 0, "rx": 1, "tx": 2}


def build():
    """Build (if needed) and load ``csrc/fdbf.cu``; return ``(entry point,
    nvcc log)``. Raises ``RuntimeError`` with nvcc's output on failure."""
    lib, log = _nvcc.load("fdbf")
    fn = lib.adjoint_k4
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, log


def _ceil(a: int, b: int) -> int:
    return -(-a // b) * b


def tile_cols(V: int, N: int, keep: str) -> int:
    """Complex columns of K4's tiles: the least of 8, 16, 32, 64 that holds
    the pulses (and, with keep 'rx', the receivers), else 64."""
    cols = max(V, N if keep == "rx" else 1)
    return next((vt for vt in (8, 16, 32) if vt >= cols), 64)


def block_operand(z: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The real-block form of the complex right operands ``z (K, R, C)`` of
    K4's tensor-core GEMMs, rounded to bfloat16: (K, 2 rows, 2 cols) with
    row 2r = (Re, Im) and row 2r + 1 = (-Im, Re) of z[:, r, c] at columns
    2c, 2c + 1, zero past R and C. A left operand whose (Re, Im) are
    interleaved along its columns times this block gives the complex
    product with (Re, Im) interleaved; the four real products of
    :func:`qups_tpu_torch.ops.fdbf.cmatmul` on the same bf16 operands."""
    K, R, C = z.shape
    zr, zi = z.real.to(torch.bfloat16), z.imag.to(torch.bfloat16)
    out = torch.zeros((K, rows, 2, cols, 2), dtype=torch.bfloat16, device=z.device)
    out[:, :R, 0, :C, 0] = zr
    out[:, :R, 0, :C, 1] = zi
    out[:, :R, 1, :C, 0] = -zi
    out[:, :R, 1, :C, 1] = zr
    return out.reshape(K, 2 * rows, 2 * cols)


KROWS = 16  # complex rows of a ring stage of the bf16 variant (fdbf.cu's KC2)


def tc_layout(M: int, N: int, V: int, keep: str):
    """(vt, Mp, Np, Vp, Vz) of the bf16 variant: the tile width and the
    paddings of M, N and V that its operands and shared tiles take."""
    vt = tile_cols(V, N, keep)
    q = max(vt, KROWS)
    return vt, _ceil(M, KROWS), _ceil(N, q), _ceil(V, q), _ceil(V, KROWS)


# fdbf.cu's shared memory: what a block may opt into less room for its
# static arrays, and the sizes of its tiles (BI pixels a block, GLD the row
# stride of a generated phasor chunk, a STAGES-deep ring of KC rows, LC rows
# of an f32 chunk)
SMEM_LIMIT = 232448 - 4096
BI, GLD, STAGES, KC, LC = 64, 40, 3, 32, 16
# A Hopper SM's shared memory, and what each resident block takes from it
# beside its dynamic shared memory: the 1 KB the hardware reserves and the
# kernel's static row sums (2 x 3 x BI floats)
SM_SMEM, BLOCK_EXTRA = 233472, 1024 + 4 * 6 * BI


def rx_smem(N: int, V: int, precision: str, cols: int) -> int:
    """Bytes of dynamic shared memory K4's keep 'rx' block takes with
    ``cols`` columns of conj(Ahat) (H) resident: the bf16 variant's
    generated phasor chunks, H and the ring; the f32 variant's chunks and
    H. As fdbf.cu's ``smem_bytes`` (GEN for bf16)."""
    vt = tile_cols(V, N, "rx")
    if precision == "bf16":
        return 2 * (2 * BI * GLD + BI * (2 * cols + 8) + STAGES * KC * (2 * vt + 8))
    return 8 * (LC * BI + LC * vt + cols * BI)


def rx_chunk(N: int, V: int, precision: str) -> int:
    """Columns of conj(Ahat) per chunk of K4's keep 'rx' (K4(b)): 0 where
    H of all V columns fits in a block's shared memory (one pass, the bf16
    variant with generated phasors at the most); else the widest whole
    number of 64-column tiles with which two blocks share an SM: bf16 256,
    f32 128 (on an H100 80GB HBM3 at 700 W, keep_rx at V = 1024 ran 1.62x
    faster in bf16 chunks of 256 than in one-block chunks of 704, and 1.35x
    in f32 chunks of 128 than of 384; chip_smoke.py phase 19)."""
    vt = tile_cols(V, N, "rx")
    full = _ceil(V, max(vt, KROWS)) if precision == "bf16" else V  # tc_layout's Vp
    if rx_smem(N, V, precision, full) <= SMEM_LIMIT:
        return 0
    per_col = 4 * BI if precision == "bf16" else 8 * BI
    cols = (SM_SMEM // 2 - BLOCK_EXTRA - rx_smem(N, V, precision, 0)) // per_col // vt * vt
    assert vt == 64 and cols >= vt, (N, V, precision, cols)
    return cols


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
    tau_rx, tau_tx = as_f32(tau_rx, dev), as_f32(tau_tx, dev)
    I, M = tau_rx.shape[0], tau_tx.shape[1]
    if tau_rx.shape != (I, N) or tau_tx.shape[0] != I or np.shape(del_tx) != (M, V):
        raise ValueError("tables and sequence do not match the traces")
    spec = adjoint_spectra(x, del_tx, apod_tx, t0, t0_off, fbins, fs=fs,
                           fmod=fmod)
    if spec is None:  # no bins selected: a zero image, as the plain version
        shape = (I, N) if keep == "rx" else ((I, V) if keep == "tx" else (I,))
        return torch.zeros(shape, dtype=torch.complex64, device=dev)
    _, fk, Xk, Sk = spec
    return adjoint_launch(adjoint_operands(fk, Xk, Sk, keep=keep, precision=precision),
                          tau_rx, tau_tx)


def bf_adjoint_tiled(x, tau_rx, tau_tx, del_tx, apod_tx, t0, t0_off, fbins, *, fs: float,
                     fmod: float = 0.0, keep_rx: bool = False, keep_tx: bool = False,
                     precision: str = "bf16", BI: int = 1024, interpret: bool = False,
                     device=None) -> torch.Tensor:
    """The counterpart of ``qups_tpu.ops.fdbf_pallas.bf_adjoint_tiled``: the
    frequency-domain adjoint image of traces ``x (T, N, V)`` (numpy, a JAX
    array or a tensor) on K4 through :func:`bf_adjoint_cuda`, on ``device``
    (default the CUDA device, raising without one; ``device="cpu"`` runs the
    plain version). Arguments as :func:`qups_tpu_torch.ops.fdbf.bf_adjoint`:
    ``fbins`` the bins, negative entries padding; keep modes '' (I,),
    keep_rx (I, N), keep_tx (I, V) complex64; ``precision`` 'bf16' (the
    default, tensor cores) or 'f32'; any V (keep_rx past a block's shared
    memory by chunks of conj(Ahat), :func:`rx_chunk`). ``BI``, the TPU
    kernel's pixel rows a block, is accepted and ignored: K4 picks its own
    tiles. ``interpret=True`` raises ``ValueError``."""
    refuse_tpu_contracts(interpret=interpret)
    return bf_adjoint_cuda(tensor_on(x, device), tau_rx, tau_tx, del_tx, apod_tx, t0, t0_off,
                           fbins, fs=fs, fmod=fmod, keep_rx=keep_rx, keep_tx=keep_tx,
                           precision=precision)


def adjoint_operands(fk: torch.Tensor, Xk: torch.Tensor, Sk: torch.Tensor, *, keep: str,
                     precision: str) -> dict:
    """The spectra of :func:`~qups_tpu_torch.ops.fdbf.adjoint_spectra` as K4
    reads them: for 'bf16' the real-block operands of the tensor-core GEMMs
    (:func:`block_operand`), for 'f32' the spectra contiguous (``X_k``
    transposed for keep 'rx'). Independent of the pixels, so a caller that
    splits the pixels builds them once (and copies them to each device with
    :func:`operands_to`)."""
    N, V, M = Xk.shape[1], Xk.shape[2], Sk.shape[1]
    ops = dict(fk=fk, N=N, M=M, V=V, keep=keep, precision=precision)
    if precision == "bf16":
        vt, Mp, Np, Vp, Vz = tc_layout(M, N, V, keep)
        # keep 'rx' contracts conj(Ahat) (BI, V) x X_k^T (V, N)
        X = block_operand(Xk.transpose(1, 2), Vp, Np) if keep == "rx" \
            else block_operand(Xk, Np, Vp)
        ops.update(S=block_operand(Sk, Mp, Vp), X=X, layout=(Mp, Np, Vp, Vz), vt=vt)
    else:
        X = Xk.transpose(1, 2) if keep == "rx" else Xk
        ops.update(S=Sk.contiguous(), X=X.contiguous(), layout=(0, 0, 0, 0),
                   vt=tile_cols(V, N, keep))
    return ops


def operands_to(ops: dict, device) -> dict:
    """:func:`adjoint_operands` with its tensors on ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in ops.items()}


def adjoint_launch(ops: dict, tau_rx, tau_tx) -> torch.Tensor:
    """K4 over the pixels of ``tau_rx (I, N)``, ``tau_tx (I, M)`` from the
    operands of :func:`adjoint_operands` (on the tables' CUDA device):
    complex64 (I,), (I, N) or (I, V). A pixel's sum depends on its own rows
    only."""
    global LAUNCHES
    dev = ops["fk"].device
    N, M, V, keep = ops["N"], ops["M"], ops["V"], ops["keep"]
    tau_rx, tau_tx = as_f32(tau_rx, dev), as_f32(tau_tx, dev)
    I = tau_rx.shape[0]
    if tau_rx.shape != (I, N) or tau_tx.shape != (I, M):
        raise ValueError("tables do not match the operands")
    shape = (I, N) if keep == "rx" else ((I, V) if keep == "tx" else (I,))
    out = torch.zeros(shape, dtype=torch.complex64, device=dev)
    fn, _ = build()
    K = int(ops["fk"].shape[0])
    code = _KEEP_CODE[keep]
    vh = rx_chunk(N, V, ops["precision"]) if keep == "rx" else 0
    bf16 = ops["precision"] == "bf16"
    if bf16:
        taur, taut = tau_rx.contiguous(), tau_tx.contiguous()
    else:
        taur, taut = tau_rx.t().contiguous(), tau_tx.t().contiguous()
    rc = fn(ops["fk"].data_ptr(), taur.data_ptr(), taut.data_ptr(), ops["S"].data_ptr(),
            ops["X"].data_ptr(), out.data_ptr(), I, N, M, V, K, *ops["layout"],
            code, int(bf16), ops["vt"], vh, *_nvcc.stream_args(dev))
    if rc != 0:
        raise RuntimeError(f"K4 launch failed with cudaError {rc}")
    LAUNCHES += 1
    return out
