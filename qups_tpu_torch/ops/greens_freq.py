"""Frequency-domain Green's-function simulation.

Port of :mod:`qups_tpu.ops.greens_freq`. Same FSA response as
:func:`qups_tpu_torch.ops.greens.greens_splat`,

    x[t, n, m] = sum_s a_s / (r1' r2' fsr) * wv(t - tau_snm - t0k + s0),

but with band-limited (exact fractional-delay) semantics: with ``L`` a
wrap-free FFT length and ``KERN_k`` the rfft of the pulse kernel, every
output bin is ``X_k[n, m] = KERN_k * G_k[n, m]``, where ``G_k`` is the
per-bin complex GEMM of kernel K3 (:mod:`qups_tpu_torch.ops.greens_freq_cuda`)
and the traces are the inverse rfft, cropped to ``[0, T)``.

Host planning (FFT length, kernel spectrum, synthesis band) is float64
numpy, as in the JAX package; the geometry prologue, K3 and the synthesis
run on ``device``. A complex kernel costs two syntheses of the same ``G``; a
complex amplitude costs a second GEMM pass (bilinearity).
"""
from __future__ import annotations

import numpy as np
import torch

from . import greens_freq_cuda
from .interp import interp1
from ..utils.backend import as_f32, default_device
from ..utils.maths import box_rbounds
from ..utils.profiling import annotate

_TWO_PI = 6.283185307179586
_DB_PER_NP = 20.0 / np.log(10.0)  # 8.6859 dB per neper


def alpha_np_per_bin(alpha0: float, fs: float, L: int) -> float:
    """``alpha0`` [dB/cm/MHz] (frequency-linear absorption) as nepers per
    meter per rfft bin index of an L-point transform at rate fs."""
    return float(alpha0) * 100.0 / _DB_PER_NP * (fs / L) / 1e6


def host_plan(kern, ps, pn, pv, *, T, s0, t0k, fs, cinv, fsr, rtol):
    """Kernel resampling, the wrap-free FFT length ``L`` and the kernel
    spectrum's synthesis band ``[k0, k1)``; float64 numpy, as
    ``qups_tpu.ops.greens_freq._host_plan``."""
    with annotate("qups.greens_freq.plan"):
        kern = np.asarray(kern)
        ps = np.asarray(ps, np.float32)
        pn = np.asarray(pn, np.float32)
        pv = np.asarray(pv, np.float32)
        if pn.ndim == 2:
            pn = pn[:, None, :]
        if pv.ndim == 2:
            pv = pv[:, None, :]
        if fsr != 1.0:  # resample the kernel to the output rate (host, small)
            Kn = int(np.ceil(kern.shape[0] / fsr))
            q = torch.arange(Kn, dtype=torch.float32) * fsr

            def res(kr):
                return interp1(torch.as_tensor(np.asarray(kr, np.float32)), q,
                               method="lanczos3").numpy()

            kern = res(kern.real) + 1j * res(kern.imag) if np.iscomplexobj(kern) \
                else res(kern)
        K = kern.shape[0]

        # [0, T) must be wrap-free: tails past L alias to [0, ...) unless
        # L > dmax + K; deposits before 0 alias to [L + dmin, ...) unless
        # L + dmin >= T. 8-bin guard for band-limited ringing.
        r1lo, r1hi = box_rbounds(ps, pn)
        r2lo, r2hi = box_rbounds(ps, pv)
        dc = (t0k - s0) * fs
        cinv = float(np.asarray(cinv).reshape(()))
        dmin = cinv * (r1lo + r2lo) * fs + dc
        dmax = cinv * (r1hi + r2hi) * fs + dc
        L = int(max(T, dmax + K + 8, T - min(0.0, dmin) + 8))
        L = 1 << int(np.ceil(np.log2(max(2, L))))

        k = np.arange(L // 2 + 1)
        ramp = np.exp(-2j * np.pi * k * dc / L)  # the scalar delay (t0k - s0)

        def spec(kr):
            return np.fft.rfft(kr, n=L) * ramp

        if np.iscomplexobj(kern):
            Kr = spec(kern.real.astype(np.float64))
            Ki = spec(kern.imag.astype(np.float64))
            mag = np.abs(Kr) + np.abs(Ki)
        else:
            Kr, Ki = spec(kern.astype(np.float64)), None
            mag = np.abs(Kr)
        keep = np.nonzero(mag >= rtol * mag.max())[0]
        k0, k1 = (int(keep[0]), int(keep[-1]) + 1) if keep.size else (0, 1)
        phc = np.float32(2.0 * np.pi * cinv * fs / L)
        return dict(ps=ps, pn=pn, pv=pv, phc=phc, L=L, k0=k0, k1=k1, Kr=Kr, Ki=Ki)


def prologue(phc, ps, amp, pn, pv, *, R0: float, fsr: float, device):
    """Device-side geometry: phase slopes ``q = (phc / 2 pi) r`` and weights,
    ``(q1, w1)`` (S, N, En) on the receive side and ``(q2, w2)`` (S, M, Em)
    on the transmit side with ``amp / fsr`` folded in; float32 on
    ``device``, as ``qups_tpu.ops.greens_freq_pallas._prologue``."""
    with annotate("qups.greens_freq.prologue"):
        ps, pn, pv = (as_f32(a, device) for a in (ps, pn, pv))
        amp = as_f32(amp, device)
        c = np.float32(phc) / np.float32(_TWO_PI)

        def geom(pe):  # (E, Esub, 3) -> r (S, E, Esub)
            d = ps[:, None, None, :] - pe[None]
            return torch.sqrt(torch.sum(d * d, dim=-1))

        r1, r2 = geom(pn), geom(pv)
        w1 = 1.0 / torch.clamp(r1, min=R0) if R0 > 0 else torch.ones_like(r1)
        w2 = (amp / fsr)[:, None, None] * (
            1.0 / torch.clamp(r2, min=R0) if R0 > 0 else torch.ones_like(r2))
        return float(c) * r1, w1, float(c) * r2, w2


def synth(G: torch.Tensor, Kf: np.ndarray, *, L: int, k0: int,
          T: int) -> torch.Tensor:
    """``irfft(KERN .* G)[:T]`` along the bin axis: G (F, N, M) complex64
    bins k0 .. k0+F-1, Kf the kernel spectrum (all L/2+1 bins). Returns
    (T, N, M) float32 on the device of ``G``."""
    with annotate("qups.greens_freq.synth"):
        F, N, M = G.shape
        kf = torch.as_tensor(np.asarray(Kf[k0:k0 + F], np.complex64), device=G.device)
        full = torch.zeros((L // 2 + 1, N, M), dtype=torch.complex64, device=G.device)
        full[k0:k0 + F] = G * kf[:, None, None]
        return torch.fft.irfft(full, n=L, dim=0)[:T]


PRECISIONS = ("highest", "default", "bf16")


def greens_freq(kern, ps, amp, pn, pv, *, T: int, s0: float, t0k: float,
                fs: float, cinv, R0: float, fsr: float = 1.0,
                rtol: float = 1e-6, precision: str = "highest",
                alpha0: float = 0.0, kernel: str = "auto",
                device=None) -> torch.Tensor:
    """Frequency-domain FSA Green's-function simulation on ``device``
    (default: the CUDA device).

    Same contract as :func:`qups_tpu_torch.ops.greens.greens_splat`:
    ``kern`` (K,) real or complex sampled at ``fsr * fs``; ``ps`` (S, 3);
    ``amp`` (S,) real or complex; ``pn`` (N, En, 3) rx and ``pv`` (M, Em, 3)
    tx sub-element positions.

    ``rtol``: kernel-spectrum bins below ``rtol * max`` are dropped;
    ``precision``: 'highest' and 'default' run the GEMM in float32 (the JAX
    package's XLA engine on the CPU runs ``Precision.DEFAULT`` in float32
    too); 'bf16' rounds each GEMM operand to bfloat16 after the sub-element
    sum, as the JAX package's ``block_gemm_scan`` does, and sums in float32
    (sub-slice K3(b)).
    ``alpha0``: frequency-linear absorption [dB/cm/MHz] over both legs.
    ``kernel``: 'auto' runs K3 on a CUDA device and the plain GEMM on the
    CPU; 'cuda' requires K3; 'plain' runs the plain GEMM on any device.

    Returns (T, N, M) float32, or complex64 if ``kern`` or ``amp`` is
    complex.
    """
    if kernel not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected {PRECISIONS}")
    device = default_device(device)
    if kernel == "cuda" and device.type != "cuda":
        raise ValueError("kernel='cuda' needs a CUDA device")
    gemm = gemm_engine(kernel)
    plan = host_plan(kern, ps, pn, pv, T=T, s0=s0, t0k=t0k, fs=fs, cinv=cinv,
                     fsr=fsr, rtol=rtol)
    att = attenuation(alpha0, fs, plan)

    def gpass(a_real):
        return gemm_pass(plan, plan["ps"], a_real, plan["pn"], R0=R0, fsr=fsr,
                         att=att, bf16=precision == "bf16", gemm=gemm, device=device)

    return synthesize(gpass, plan, amp, T=T)


def gemm_engine(kernel: str):
    """The GEMM of ``kernel``: 'plain' the plain version on any device,
    else K3 (:func:`~qups_tpu_torch.ops.greens_freq_cuda.freq_gemm`, which
    runs the plain version on a CPU tensor)."""
    return greens_freq_cuda.freq_gemm_plain if kernel == "plain" \
        else greens_freq_cuda.freq_gemm


def attenuation(alpha0: float, fs: float, plan: dict) -> float:
    """``alpha0`` [dB/cm/MHz] as the GEMM's ``att``: nepers per unit of the
    phase slope ``q`` per bin."""
    if not alpha0:
        return 0.0
    return alpha_np_per_bin(alpha0, fs, plan["L"]) * _TWO_PI / float(plan["phc"])


def gemm_pass(plan: dict, ps, amp, pn, *, R0: float, fsr: float, att: float,
              bf16: bool, gemm, device) -> torch.Tensor:
    """One GEMM pass of a real amplitude: the spectra ``G (F, N, M)``
    complex64 on ``device`` of the scatterers ``ps (S, 3)`` with amplitudes
    ``amp (S,)`` against the receivers ``pn (N, En, 3)`` and the plan's
    transmitters, over the plan's band."""
    q1, w1, q2, w2 = prologue(plan["phc"], ps, amp, pn, plan["pv"], R0=R0, fsr=fsr,
                              device=device)
    return gemm(q1, w1, q2, w2, k0=plan["k0"], F=plan["k1"] - plan["k0"], att=att,
                bf16=bf16)


def synthesize(gpass, plan: dict, amp, *, T: int) -> torch.Tensor:
    """The traces (T, N, M) from the GEMM passes ``gpass(real amplitudes) ->
    G`` (one, or two for complex amplitudes) and the plan's kernel
    spectrum: float32, or complex64 for a complex kernel or amplitudes."""
    amp = np.asarray(amp)
    Kr, Ki = plan["Kr"], plan["Ki"]
    kw = dict(L=plan["L"], k0=plan["k0"], T=T)
    if Ki is None and not np.iscomplexobj(amp):
        return synth(gpass(amp), Kr, **kw)
    # bilinear decomposition: x = S(kr, ar) - S(ki, ai)
    #                           + i [S(ki, ar) + S(kr, ai)]
    Gr = gpass(np.real(amp))
    Gi = gpass(np.imag(amp)) if np.iscomplexobj(amp) and np.any(np.imag(amp)) \
        else None
    xr = synth(Gr, Kr, **kw)
    xi = synth(Gr, Ki, **kw) if Ki is not None else torch.zeros_like(xr)
    if Gi is not None:
        xi = xi + synth(Gi, Kr, **kw)
        if Ki is not None:
            xr = xr - synth(Gi, Ki, **kw)
    return torch.complex(xr, xi)
