"""The frequency-domain Green's-function GEMM (kernel K3): the least
operations of one simulation, frozen from the program's kernel table of the
time the benchmark was written (PERF.md, section 6, row K3(a)):

    8 F S N M flops

for S scatterers, N receive and M transmit elements and F frequency bins:
each bin's complex product of the (N, S) receive and (S, M) transmit
phasor matrices. F is the echo kernel's band, the bins of its L-point
spectrum at or above 1e-6 of its largest (``usbench/reference/sim.py``).
"""
from __future__ import annotations

import numpy as np

from . import PEAKS
from ..reference import sim

RTOL = 1e-6


def band_bins(ps, ele, *, fc: float, bw: float, fs: float, c0: float) -> int:
    """F: the bins of the echo kernel's spectrum at or above RTOL of its
    largest, first to last, on the simulation's own FFT length."""
    T, s0, h, t0k, L = sim.window(ps, ele, fc, bw, fs, c0)
    mag = np.abs(np.fft.rfft(h.real, n=L)) + np.abs(np.fft.rfft(h.imag, n=L))
    keep = np.nonzero(mag >= RTOL * mag.max())[0]
    return int(keep[-1] - keep[0] + 1)


def flops(F: int, S: int, N: int, M: int) -> float:
    return 8.0 * F * S * N * M


def bound_s(F: int, S: int, N: int, M: int) -> float:
    """The least time of the GEMM on the card: float32 operations against
    their peak (its bytes, the phasor operands, are a small share)."""
    return flops(F, S, N, M) / PEAKS["f32_flop_per_s"]
