"""K3: the frequency-domain Green's-function GEMM, hand-written CUDA for Hopper.

Replaces the TPU kernel ``qups_tpu/ops/greens_freq_pallas.py::_kernel``
(launched by ``_gf_call``, public entries ``freq_gemm_pallas`` and
``simus_spectrum_pallas``): per DFT bin k of the synthesis band, the complex
GEMM

    G[k, n, m] = sum_s A_k[s, n] B_k[s, m],
    A_k[s, n]  = D1 sum_e w1 exp(-att k q1) e^{-i 2 pi frac(k q1)}   (and B_k alike)

with ``q = cinv fs r / L`` and ``w`` from
:func:`qups_tpu_torch.ops.greens_freq.prologue` (or
:func:`qups_tpu_torch.ops.simus.simus_prologue`). Sub-slices: K3(a) the
float32 GEMM (``D = 1``, CUDA cores); K3(b) ``bf16=True``, each operand
rounded to bfloat16 after the sub-element sum and the directivity, the
product on the tensor cores with float32 sums;
K3(c) the element directivity ``D = sinc(s k)`` from slopes ``s1 (S, N)``,
``s2 (S, M)``. The source is ``csrc/greens_freq.cu``, built and loaded by
:mod:`qups_tpu_torch.ops._nvcc`.

:func:`freq_gemm` launches the kernel for CUDA tensors, and raises if the
kernel cannot be built or launched; it never falls back. For CPU tensors it
runs :func:`freq_gemm_plain`. ``LAUNCHES`` counts the kernel launches.

The TPU package's entries of this kernel have counterparts here, named as
the port names its modules (``_pallas`` -> ``_cuda``), with their
arguments: :func:`freq_gemm_cuda` is ``freq_gemm_pallas``
(``greens_freq_pallas.py:205``) and :func:`simus_spectrum_cuda` is
``simus_spectrum_pallas`` (``:282``). They run on the CUDA device unless
given ``device="cpu"``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _nvcc
from ..utils.backend import as_f32, default_device, is_cuda
from ..utils.profiling import annotate

LAUNCHES = 0  # K3 launches in this process
# the same launches by sub-slice: 'a' float32, 'b' bf16 operands, 'c' the
# directivity, 'bc' both
VARIANT_LAUNCHES = {"a": 0, "b": 0, "c": 0, "bc": 0}

_TWO_PI = 6.283185307179586
_PI_F32 = float(np.float32(np.pi))  # the float32 pi of the TPU kernel's sinc


def build():
    """Build (if needed) and load ``csrc/greens_freq.cu``; return ``(entry
    point, nvcc log)``. Raises ``RuntimeError`` with nvcc's output on
    failure."""
    lib, log = _nvcc.load("greens_freq")
    fn = lib.freq_gemm_k3
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, log


def sinc(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's sinc: ``sin(pi x) / (pi x)``, 1 where
    ``|pi x| < 1e-6``."""
    px = _PI_F32 * x
    return torch.where(px.abs() < 1e-6, torch.ones_like(px), torch.sin(px) / px)


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def _phasors(q: torch.Tensor, w: torch.Tensor, k: torch.Tensor, att: float,
             s=None, bf16: bool = False):
    """(B, S, E') complex64 operands for the bins ``k (B,)``: the phasors
    summed over sub-elements, sum_e w exp(-att k q) e^{-i 2 pi frac(k q)},
    times ``sinc(s k)`` when ``s (S, E')`` is given, rounded to bfloat16
    with ``bf16``; in K3's order."""
    kk = k.reshape(-1, 1, 1, 1)
    u = kk * q[None]
    th = (u - torch.floor(u)) * _TWO_PI
    mag = w[None] if not att else w[None] * torch.exp((-att * kk) * q[None])
    re = torch.sum(mag * torch.cos(th), dim=-1)
    im = -torch.sum(mag * torch.sin(th), dim=-1)
    if s is not None:
        g = sinc(s[None] * k.reshape(-1, 1, 1))
        re, im = re * g, im * g
    if bf16:
        re, im = _bf16(re), _bf16(im)
    return torch.complex(re, im)


def freq_gemm_plain(q1: torch.Tensor, w1: torch.Tensor, q2: torch.Tensor,
                    w2: torch.Tensor, *, k0: int, F: int, att: float = 0.0,
                    s1=None, s2=None, bf16: bool = False,
                    max_elems: int = 1 << 24) -> torch.Tensor:
    """The plain PyTorch version of K3: ``G (F, N, M)`` complex64 on the
    device of ``q1``, bins ``k0 .. k0+F-1``, with the same options as
    :func:`freq_gemm`. The bins go in blocks so that at most about
    ``max_elems`` phasor terms are live at once. The products run in float32
    (a bf16 operand times a bf16 operand is exact in float32)."""
    S, N, E1 = q1.shape
    M, E2 = q2.shape[1:]
    dev = q1.device
    per_bin = max(1, S * (N * E1 + M * E2))
    FB = max(1, min(F, max_elems // per_bin))
    out = torch.empty((F, N, M), dtype=torch.complex64, device=dev)
    for f0 in range(0, F, FB):
        f1 = min(F, f0 + FB)
        k = torch.arange(k0 + f0, k0 + f1, dtype=torch.float32, device=dev)
        A = _phasors(q1, w1, k, att, s1, bf16)  # (B, S, N)
        B = _phasors(q2, w2, k, att, s2, bf16)  # (B, S, M)
        out[f0:f1] = torch.bmm(A.transpose(1, 2), B)
    return out


def freq_gemm(q1: torch.Tensor, w1: torch.Tensor, q2: torch.Tensor,
              w2: torch.Tensor, *, k0: int, F: int, att: float = 0.0,
              s1=None, s2=None, bf16: bool = False) -> torch.Tensor:
    """Geometry spectrum ``G (F, N, M)`` complex64 for bins k0 .. k0+F-1.

    ``q1, w1``: (S, N, E1) float32 receive phase slopes and weights;
    ``q2, w2``: (S, M, E2) the transmit side, amplitudes folded in;
    ``att``: attenuation in nepers per unit q per bin; ``s1 (S, N)``,
    ``s2 (S, M)`` (both or neither): sinc directivity slopes per bin, K3(c);
    ``bf16``: round the operands to bfloat16, K3(b). On CUDA tensors this
    launches K3; on CPU tensors it runs :func:`freq_gemm_plain`.
    """
    global LAUNCHES
    if (s1 is None) != (s2 is None):
        raise ValueError("K3 takes both directivity slopes s1, s2 or neither")
    if not is_cuda(q1):
        return freq_gemm_plain(q1, w1, q2, w2, k0=k0, F=F, att=att, s1=s1,
                               s2=s2, bf16=bf16)
    ops = (q1, w1, q2, w2)
    if any(t.dtype != torch.float32 or t.ndim != 3 or t.device != q1.device
           for t in ops):
        raise ValueError("K3 takes float32 (S, E, sub) tensors on one device")
    S, N, E1 = q1.shape
    M, E2 = q2.shape[1:]
    if w1.shape != q1.shape or w2.shape != q2.shape or q2.shape[0] != S:
        raise ValueError(f"K3 operands disagree: {[tuple(t.shape) for t in ops]}")
    dirs = ()
    if s1 is not None:
        if any(not isinstance(t, torch.Tensor) or t.dtype != torch.float32
               or t.device != q1.device for t in (s1, s2)) \
                or s1.shape != (S, N) or s2.shape != (S, M):
            raise ValueError("K3 directivity slopes are float32 (S, N) and "
                             "(S, M) on the operands' device")
        dirs = (s1.contiguous(), s2.contiguous())
    if max(S, N, M, F) >= 2**31 or not math.isfinite(att):
        raise ValueError("K3 sizes must fit int32 and att must be finite")
    q1, w1, q2, w2 = (t.contiguous() for t in ops)
    dev = q1.device
    with annotate("qups.greens_freq.k3"):
        out = torch.empty((F, N, M), dtype=torch.complex64, device=dev)
        fn, _ = build()
        sp = (dirs[0].data_ptr(), dirs[1].data_ptr()) if dirs else (None, None)
        rc = fn(q1.data_ptr(), w1.data_ptr(), q2.data_ptr(), w2.data_ptr(), *sp,
                out.data_ptr(), S, N, M, E1, E2, int(k0), int(F), float(att),
                int(bool(bf16)), *_nvcc.stream_args(dev))
        if rc != 0:
            raise RuntimeError(f"K3 launch failed with cudaError {rc}")
        LAUNCHES += 1
        VARIANT_LAUNCHES[("b" if bf16 else "") + ("c" if dirs else "") or "a"] += 1
    return out


def _gemm_precision(precision: str) -> bool:
    """``bf16`` of :func:`freq_gemm` for a JAX ``precision``."""
    from .greens_freq import PRECISIONS

    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected {PRECISIONS}")
    return precision == "bf16"


def freq_gemm_cuda(phc, ps, amp, pn, pv, *, L: int, k0: int, F: int, R0: float, fsr: float,
                   precision: str = "highest", B: int = 8, SC: int = 512,
                   interpret: bool = False, att: float = 0.0, device=None) -> torch.Tensor:
    """The counterpart of ``qups_tpu.ops.greens_freq_pallas.freq_gemm_pallas``:
    the geometry spectrum ``G (F, N, M)`` for bins ``k0 .. k0+F-1``, with
    ``G[k, n, m] = sum_s w1 w2 e^{-i k phc (r1 + r2)}``, ``w1 = 1 / max(r1,
    R0)`` (1 for R0 = 0) and ``w2 = amp / fsr`` times the same of r2, the
    distances of the scatterers ``ps (S, 3)`` to the receivers ``pn`` and
    the transmitters ``pv``, (E, 3) or (E, Esub, 3) with their sub-elements
    summed (the JAX function takes one sub-element). ``phc = 2 pi cinv fs /
    L``; ``att``: frequency-linear attenuation in nepers per metre per bin.
    ``precision`` 'highest' | 'default' (float32) or 'bf16' (K3(b): the
    operands rounded to bfloat16, float32 sums).

    Its prologue (:func:`qups_tpu_torch.ops.greens_freq.prologue`) and K3
    run on ``device`` (default the CUDA device, raising without one;
    ``device="cpu"`` runs the plain version). Returns complex64 (F, N, M);
    the JAX function returns its (F, N, M, 2) real/imaginary pair
    (``torch.view_as_real`` gives that). ``L`` (in ``phc`` already), ``B``,
    ``SC`` (the TPU kernel's bin and scatterer tiles) and ``interpret`` are
    accepted and ignored."""
    from .greens_freq import prologue

    bf16 = _gemm_precision(precision)
    dev = default_device(device)
    pn, pv = (as_f32(a, dev) for a in (pn, pv))
    pn, pv = (a.reshape(a.shape[0], -1, 3) for a in (pn, pv))
    q1, w1, q2, w2 = prologue(phc, ps, amp, pn, pv, R0=float(R0), fsr=float(fsr), device=dev)
    # q = (phc / 2 pi) r, so the decay exp(-att k r) is exp(-(att 2 pi / phc) k q)
    att_q = float(att) * _TWO_PI / float(phc) if att else 0.0
    return freq_gemm(q1, w1, q2, w2, k0=int(k0), F=int(F), att=att_q, bf16=bf16)


def simus_spectrum_cuda(ps, amp, pn, nn_az, pv, nv_az, widths, *, k0: int, F: int, T: int,
                        fs: float, c0: float, baffle: str = "soft", precision: str = "highest",
                        SC: int = 512, interpret: bool = False, att: float = 0.0,
                        device=None) -> torch.Tensor:
    """The counterpart of
    ``qups_tpu.ops.greens_freq_pallas.simus_spectrum_pallas``: the
    frequency-domain point-scatterer spectrum with rectangular-element sinc
    directivity (the SIMUS analog of :mod:`qups_tpu_torch.ops.simus`),
    ``X (F, N, E)`` complex64 for bins ``k0 .. k0+F-1`` of a ``T``-sample
    rfft at ``fs``, through its prologue
    (:func:`qups_tpu_torch.ops.simus.simus_prologue`) and K3(c). ``ps (S,
    3)``, ``amp (S,)`` the scatterers; ``pn (N, 3)``, ``nn_az (N,)`` the
    receivers and their azimuths [rad]; ``pv (E, 3)``, ``nv_az (E,)`` the
    transmitters; ``widths`` (tx, rx) element widths; ``baffle`` 'soft'
    (the obliquity) or 'hard'; ``att`` nepers per metre per bin;
    ``precision`` as :func:`freq_gemm_cuda`. On ``device`` (default the CUDA
    device, raising without one; ``device="cpu"`` runs the plain version).
    ``SC`` and ``interpret`` are accepted and ignored."""
    from .simus import simus_prologue

    bf16 = _gemm_precision(precision)
    dev = default_device(device)
    sl = np.float32(fs / (T * c0))  # phase slope (/ 2 pi) and sinc slope per bin
    q1, w1, s1, q2, w2, s2 = simus_prologue(ps, amp, pn, nn_az, pv, nv_az, widths, sl,
                                            baffle=baffle, device=dev)
    # q = sl r, so the per-bin decay exp(-att r) is exp(-(att / sl) q)
    att_q = float(att) / float(sl) if att else 0.0
    return freq_gemm(q1, w1, q2, w2, k0=int(k0), F=int(F), att=att_q, s1=s1, s2=s2, bf16=bf16)
