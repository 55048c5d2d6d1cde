"""K4: the frequency-domain adjoint beamformer, hand-written CUDA for Hopper.

Replaces the TPU kernel ``qups_tpu/ops/fdbf_pallas.py::_kernel`` (launched
by ``_adj_call``, public entry ``bf_adjoint_tiled``): keep modes ''
(summed), 'rx' and 'tx', dot precisions 'f32' (CUDA cores) and 'bf16'
(tensor cores), any number of synthesized pulses and receivers (K4(a) and
K4(b); :func:`rx_chunk` plans keep_rx's conj(Ahat) in chunks where it does
not fit in shared memory). In bf16, where a block's phasor tiles do not fit
in shared memory (:func:`wide_route`: M + N past ~780), K4 takes the wide
route: :func:`phasor_table` builds each bin's phasors once into device
memory and :func:`adjoint_wide` streams them through 128-pixel tensor-core
blocks, bins in groups within ``WIDE_BYTES`` (:func:`wide_plan`). The
source is ``csrc/fdbf.cu``, built and loaded by
:mod:`qups_tpu_torch.ops._nvcc`. The host/XLA glue of the TPU engine
(``_prep_spectra``, ``_pack``, the empty-bin case) is plain torch in
:func:`qups_tpu_torch.ops.fdbf.adjoint_spectra`, shared with the plain
version; the TPU's 128-lane padding is gone. For 'bf16' the wrapper packs
the per-bin spectra into the real-block operands of the tensor-core GEMMs
(:func:`block_operand`).

:func:`bf_adjoint_cuda` launches the kernel for a CUDA tensor, and raises
if it cannot be built or launched; it never falls back. For a CPU tensor it
runs :func:`qups_tpu_torch.ops.fdbf.bf_adjoint`, the plain version.
``LAUNCHES`` counts K4's calls (one a call on either route),
``TABLE_LAUNCHES`` the phasor table kernel's launches (one a bin group and
table). :func:`bf_adjoint_tiled` is the
counterpart of the TPU package's entry of the same name, on the CUDA
device unless given ``device="cpu"``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _nvcc
from .fdbf import (PRECISIONS, adjoint_spectra, bf_adjoint, keep_mode, phasor,
                   round_operand)
from ..utils.backend import as_f32, is_cuda, refuse_tpu_contracts, tensor_on

LAUNCHES = 0  # K4 launches in this process
TABLE_LAUNCHES = 0  # phasor table launches (the wide route)

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


def build_wide():
    """The wide route's entry points of ``csrc/fdbf.cu``: ``(phasor_table,
    adjoint_k4_wide)``."""
    lib, _ = _nvcc.load("fdbf")
    table, wide = lib.phasor_table, lib.adjoint_k4_wide
    table.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    wide.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 10
                     + [ctypes.c_void_p])
    table.restype = wide.restype = ctypes.c_int
    return table, wide


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
# static arrays, and the sizes of its tiles (BI pixels a block, a
# STAGES-deep ring of KC rows, LC rows of an f32 chunk)
SMEM_LIMIT = 232448 - 4096
BI, STAGES, KC, LC = 64, 3, 32, 16
# A Hopper SM's shared memory, and what each resident block takes from it
# beside its dynamic shared memory: the 1 KB the hardware reserves and the
# kernel's static row sums (2 x 3 x BI floats)
SM_SMEM, BLOCK_EXTRA = 233472, 1024 + 4 * 6 * BI


def tc_smem(M: int, N: int, V: int, keep: str, cols: int | None = None) -> int:
    """Bytes of dynamic shared memory of the bf16 variant's resident route,
    as fdbf.cu's ``TcEngine`` / ``TcChunked::smem_bytes``: the phasor tiles
    (Wtx; Wrx but for keep 'rx'), with keep 'rx' ``cols`` columns of
    conj(Ahat) (None: all of ``tc_layout``'s Vp), and the ring."""
    vt, Mp, Np, Vp, _ = tc_layout(M, N, V, keep)
    e = BI * (2 * Mp + 8) + STAGES * KC * (2 * vt + 8)
    if keep == "rx":
        e += BI * (2 * (Vp if cols is None else cols) + 8)
    else:
        e += BI * (2 * Np + 8)
    return 2 * e


def rx_smem(M: int, N: int, V: int, precision: str, cols: int) -> int:
    """Bytes of dynamic shared memory K4's keep 'rx' block takes with
    ``cols`` columns of conj(Ahat) (H) resident: the bf16 variant's
    phasor tile, H and the ring (:func:`tc_smem`); the f32 variant's chunks
    and H. As fdbf.cu's ``smem_bytes``."""
    if precision == "bf16":
        return tc_smem(M, N, V, "rx", cols)
    return 8 * (LC * BI + LC * tile_cols(V, N, "rx") + cols * BI)


def wide_route(M: int, N: int, V: int, keep: str, precision: str = "bf16") -> bool:
    """Whether K4 takes the wide route: bf16, where the phasor tiles of a
    64-pixel block do not fit a block's shared memory beside the ring and,
    with keep 'rx', one 64-column chunk of conj(Ahat) (M + N past ~780)."""
    if precision != "bf16":
        return False
    Vp = tc_layout(M, N, V, keep)[3]
    return tc_smem(M, N, V, keep, min(Vp, 64) if keep == "rx" else None) > SMEM_LIMIT


def rx_chunk(M: int, N: int, V: int, precision: str) -> int:
    """Columns of conj(Ahat) per chunk of K4's keep 'rx' on the resident
    route (K4(b)): 0 where H of all V columns fits in a block's shared
    memory (one pass); else the widest whole number of 64-column tiles with
    which two blocks share an SM (bf16 256, f32 128 at N = V = 1024 and few
    elements; on an H100 80GB HBM3 at 700 W, keep_rx at V = 1024 ran 1.62x
    faster in bf16 chunks of 256 than in one-block chunks of 704, and 1.35x
    in f32 chunks of 128 than of 384; chip_smoke.py phase 19), or, where
    the phasor tile leaves no two such blocks room, the widest one block
    holds. Not used on the wide route (:func:`wide_route`)."""
    vt = tile_cols(V, N, "rx")
    full = tc_layout(M, N, V, "rx")[3] if precision == "bf16" else V
    if rx_smem(M, N, V, precision, full) <= SMEM_LIMIT:
        return 0
    per_col = 4 * BI if precision == "bf16" else 8 * BI
    base = rx_smem(M, N, V, precision, 0)
    cols = (SM_SMEM // 2 - BLOCK_EXTRA - base) // per_col // vt * vt
    if cols < vt:
        cols = (SMEM_LIMIT - base) // per_col // vt * vt
    assert vt == 64 and cols >= vt, (M, N, V, precision, cols)
    return cols


# The wide route (fdbf.cu's WM, WVT, WKC): 128 pixels a block, tiles of 64
# complex columns, ring stages of WKC / 2 complex rows; its scratch per call
# (phasor tables, row sums, the keep modes' Q or conj(A)), as the port's
# other chunkings
WM, WVT, WKROWS = 128, 64, 32
WIDE_BYTES = 4 << 30


def wide_layout(M: int, N: int, V: int, keep: str):
    """(Mp, Np, Vp, Vz) of the wide route: M, N padded to a ring stage's
    WKROWS complex rows (N to the 64-column tiles with keep 'rx'), V to the
    tiles (Vp) and to WKROWS (Vz, the depth of keep 'rx''s z = conj(A)
    X_k^T)."""
    return (_ceil(M, WKROWS), _ceil(N, WVT if keep == "rx" else WKROWS), _ceil(V, WVT),
            _ceil(V, WKROWS))


def wide_bytes(M: int, N: int, V: int, keep: str) -> int:
    """Scratch bytes of the wide route per pixel and bin: the bf16 phasor
    tables (Wtx; Wrx but for keep 'rx'), the per-tile row sums (float4),
    and for keep 'tx' the 1 / ||A_i|| (float) and y conj(A) (complex64),
    for keep 'rx' 1 / ||A_i||, A (complex64) and conj(A) / ||A_i|| (bf16
    pairs)."""
    Mp, Np, Vp, _ = wide_layout(M, N, V, keep)
    b = 4 * Mp + 16 * (Vp // WVT)
    if keep != "rx":
        b += 4 * Np
    if keep == "tx":
        b += 4 + 8 * V
    elif keep == "rx":
        b += 4 + 12 * Vp
    return b


def wide_plan(I: int, M: int, N: int, V: int, K: int, keep: str) -> dict:
    """The wide route's chunks within ``WIDE_BYTES``: ``bins`` a group (as
    many as fit with all ``I`` pixels, at most 1024) and ``rows`` pixels a
    chunk (all ``I``, or where one bin of all pixels does not fit, equal
    chunks of whole 128-pixel blocks); ``scratch`` the bytes allocated."""
    per = wide_bytes(M, N, V, keep)
    bins = min(K, 1024, WIDE_BYTES // max(1, I * per))
    if bins >= 1:
        rows = I
    else:
        bins = 1
        nchunk = -(-I * per // WIDE_BYTES)
        rows = _ceil(-(-I // nchunk), WM)
    return dict(bins=bins, rows=rows, per=per, scratch=bins * rows * per)


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
    (:func:`block_operand`; padded by :func:`wide_layout` where ``wide``,
    :func:`wide_route`), for 'f32' the spectra contiguous (``X_k``
    transposed for keep 'rx'). Independent of the pixels, so a caller that
    splits the pixels builds them once (and copies them to each device with
    :func:`operands_to`)."""
    N, V, M = Xk.shape[1], Xk.shape[2], Sk.shape[1]
    ops = dict(fk=fk, N=N, M=M, V=V, keep=keep, precision=precision,
               wide=wide_route(M, N, V, keep, precision))
    if ops["wide"]:
        Mp, Np, Vp, Vz = wide_layout(M, N, V, keep)
        X = block_operand(Xk.transpose(1, 2), Vp, Np) if keep == "rx" \
            else block_operand(Xk, Np, Vp)
        ops.update(S=block_operand(Sk, Mp, Vp), X=X, layout=(Mp, Np, Vp, Vz), vt=WVT)
    elif precision == "bf16":
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
    if ops["wide"]:
        adjoint_wide(ops, tau_rx, tau_tx, out)
        LAUNCHES += 1
        return out
    fn, _ = build()
    K = int(ops["fk"].shape[0])
    code = _KEEP_CODE[keep]
    vh = rx_chunk(M, N, V, ops["precision"]) if keep == "rx" else 0
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


def phasor_table_plain(fk: torch.Tensor, tau: torch.Tensor, sign: float, Lp: int) -> torch.Tensor:
    """The plain version of the phasor table kernel: (G, I, 2 Lp) bfloat16,
    row (g, i) the (Re, Im) pairs of :func:`~qups_tpu_torch.ops.fdbf.phasor`
    ``(fk[g], tau[i], sign)`` rounded to bfloat16, zero past ``L``;
    ``tau (I, L)``."""
    I, L = tau.shape
    out = torch.zeros((fk.shape[0], I, Lp, 2), dtype=torch.bfloat16, device=tau.device)
    for g in range(fk.shape[0]):
        p = phasor(fk[g], tau, sign)
        out[g, :, :L, 0] = p.real.to(torch.bfloat16)
        out[g, :, :L, 1] = p.imag.to(torch.bfloat16)
    return out.reshape(fk.shape[0], I, 2 * Lp)


def phasor_table(fk: torch.Tensor, tau: torch.Tensor, sign: float, Lp: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 phasors of the bins ``fk (G,)`` at the delays ``tau (I, L)``
    [s] as the wide route streams them: (G, I, 2 Lp) bfloat16 (written into
    the front of the flat bfloat16 buffer ``out`` where given). On a CUDA
    tensor the table kernel (sin and cos on the special function unit,
    about 2^-21.4 from the accurate ones before the rounding), on a CPU
    tensor :func:`phasor_table_plain`."""
    global TABLE_LAUNCHES
    if not is_cuda(tau):
        return phasor_table_plain(fk, tau, sign, Lp)
    I, L = tau.shape
    G = int(fk.shape[0])
    n = G * I * 2 * Lp
    if out is None:
        out = torch.empty(n, dtype=torch.bfloat16, device=tau.device)
    if out.dtype != torch.bfloat16 or out.numel() < n or not out.is_contiguous() \
            or out.data_ptr() % 16 or Lp % 4 or Lp < L:
        raise ValueError("the table takes Lp >= L, a multiple of 4, and a contiguous, "
                         "16-byte aligned bfloat16 buffer of G I 2 Lp entries")
    fk, tau = as_f32(fk, tau.device).contiguous(), as_f32(tau, tau.device).contiguous()
    if tau.data_ptr() % 16:  # the kernel reads 4 delays at once
        tau = tau.clone()
    table, _ = build_wide()
    rc = table(fk.data_ptr(), tau.data_ptr(), out.data_ptr(), I, L, Lp, G, float(sign),
               *_nvcc.stream_args(tau.device))
    if rc != 0:
        raise RuntimeError(f"phasor table launch failed with cudaError {rc}")
    TABLE_LAUNCHES += 1
    return out[:n].view(G, I, 2 * Lp)


def _wide_chunks(ops: dict, I: int):
    """(plan, its (pixel range, bin range) pairs) of the wide route's
    launches (:func:`wide_plan`), pixels outer."""
    K = int(ops["fk"].shape[0])
    plan = wide_plan(I, ops["M"], ops["N"], ops["V"], K, ops["keep"])
    return plan, [((i0, min(I, i0 + plan["rows"])), (k0, min(K, k0 + plan["bins"])))
                  for i0 in range(0, I, plan["rows"]) for k0 in range(0, K, plan["bins"])]


def adjoint_wide(ops: dict, tau_rx: torch.Tensor, tau_tx: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """K4's wide route (:func:`wide_route`) on the card: for each chunk of
    :func:`wide_plan`, the phasor tables of its bins (:func:`phasor_table`,
    Wtx and, but for keep 'rx', Wrx), then ``adjoint_k4_wide`` (the
    products, the row sums, the finish) adds the chunk's bins into ``out``
    (the zeroed image of :func:`adjoint_launch`). Operands of
    :func:`adjoint_operands` with ``wide``."""
    dev = out.device
    N, M, V, keep = ops["N"], ops["M"], ops["V"], ops["keep"]
    Mp, Np, Vp, Vz = ops["layout"]
    I = tau_rx.shape[0]
    plan, chunks = _wide_chunks(ops, I)
    G, R = plan["bins"], plan["rows"]
    fk = ops["fk"].contiguous()
    taur, taut = as_f32(tau_rx, dev).contiguous(), as_f32(tau_tx, dev).contiguous()
    wt = torch.empty(G * R * 2 * Mp, dtype=torch.bfloat16, device=dev)
    wr = torch.empty(G * R * 2 * Np, dtype=torch.bfloat16, device=dev) if keep != "rx" else None
    part = torch.empty(G * (Vp // WVT) * R * 4, dtype=torch.float32, device=dev)
    inv = torch.empty(G * R, dtype=torch.float32, device=dev)
    scr = (torch.empty(G * R * V, dtype=torch.complex64, device=dev) if keep == "tx" else
           torch.empty(G * R * Vp, dtype=torch.complex64, device=dev) if keep == "rx" else None)
    H = torch.empty(G * R * 2 * Vp, dtype=torch.bfloat16, device=dev) if keep == "rx" else None
    S, X = ops["S"], ops["X"]
    s_bin, x_bin = S[0].numel() * 2, X[0].numel() * 2  # bytes a bin
    row = out[0].numel() * 8 if out.ndim > 1 else 8
    _, wide = build_wide()
    for (i0, i1), (k0, k1) in chunks:
        n, g = i1 - i0, k1 - k0
        tr, tt, fg = taur[i0:i1], taut[i0:i1], fk[k0:k1]
        phasor_table(fg, tt, -1.0, Mp, wt)
        if wr is not None:
            phasor_table(fg, tr, 1.0, Np, wr)
        rc = wide(fg.data_ptr(), tr.data_ptr(), wt.data_ptr(),
                  None if wr is None else wr.data_ptr(), S.data_ptr() + k0 * s_bin,
                  X.data_ptr() + k0 * x_bin, part.data_ptr(), inv.data_ptr(),
                  None if scr is None else scr.data_ptr(), None if H is None else H.data_ptr(),
                  out.data_ptr() + i0 * row,
                  n, N, M, V, g, Mp, Np, Vp, Vz, _KEEP_CODE[keep], *_nvcc.stream_args(dev))
        if rc != 0:
            raise RuntimeError(f"K4 wide route launch failed with cudaError {rc}")
    return out


def adjoint_wide_plain(ops: dict, tau_rx, tau_tx) -> torch.Tensor:
    """The plain version of the wide route, its steps in its order: per
    chunk of :func:`wide_plan`, the bf16 tables of
    :func:`phasor_table_plain`, the real-block products in float32, the row
    sums per 64-column tile, and 1 / ||A_i|| applied after the products
    (keep '': to sum_v y conj(A); 'tx': to y conj(A); 'rx': to conj(A)
    before its rounding to bf16, then z = conj(Ahat) X_k^T times the
    accurate Wrx). Complex64 (I,), (I, N) or (I, V); for the tests."""
    N, V, keep = ops["N"], ops["V"], ops["keep"]
    Mp, Np, Vp, Vz = ops["layout"]
    S, X, fk = ops["S"].float(), ops["X"].float(), ops["fk"]
    dev = S.device
    taur, taut = as_f32(tau_rx, dev), as_f32(tau_tx, dev)
    I = taur.shape[0]
    shape = (I, N) if keep == "rx" else ((I, V) if keep == "tx" else (I,))
    out = torch.zeros(shape, dtype=torch.complex64, device=dev)

    def cplx(z, cols):  # (n, 2 cols) interleaved -> complex (n, cols)
        return torch.view_as_complex(z.reshape(z.shape[0], cols, 2).contiguous())

    for (i0, i1), (k0, k1) in _wide_chunks(ops, I)[1]:
        n = i1 - i0
        wt = phasor_table_plain(fk[k0:k1], taut[i0:i1], -1.0, Mp).float()
        if keep != "rx":
            wr = phasor_table_plain(fk[k0:k1], taur[i0:i1], 1.0, Np).float()
        for g in range(k1 - k0):
            k = k0 + g
            A = cplx(wt[g] @ S[k], Vp)  # (n, Vp)
            a2 = (A.real * A.real + A.imag * A.imag).reshape(n, -1, WVT).sum(2)
            s = torch.zeros(n, device=dev)
            for ct in range(a2.shape[1]):  # the tiles' row sums in order
                s = s + a2[:, ct]
            nrm = torch.sqrt(s)
            inv = 1.0 / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
            if keep == "rx":
                H = round_operand((A * inv[:, None]).conj(), "bf16")
                h = torch.view_as_real(H).reshape(n, 2 * Vp)[:, :2 * Vz]
                z = cplx(h @ X[k][:2 * Vz], Np)[:, :N]
                out[i0:i1] += phasor(fk[k], taur[i0:i1], 1.0) * z
                continue
            Y = cplx(wr[g] @ X[k], Vp)
            q = Y * A.conj()
            if keep == "tx":
                out[i0:i1] += q[:, :V] * inv[:, None]
            else:
                out[i0:i1] += q.sum(1) * inv
    return out
