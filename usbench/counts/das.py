"""Delay-and-sum with the cubic sampler: the least operations and bytes of
one summed call, frozen from the program's kernel table of the time the
benchmark was written (PERF.md, section 6, rows K1, K1(b), K1(e)).

A term is one (pixel, transmit, receiver). Its delay costs 4 flops (the
path sum, the times 1/c, minus t0, times fs; the transmit and receive
distances are formed once per (pixel, transmit) and (pixel, receiver)) and
its tap base and fraction 3; with remodulation the phase 1 and its sine and
cosine 20. Each frame then costs, real: the cubic from its coefficients 6
(three FMAs) and the sum 1; complex: the complex cubic 12 and the sum 2,
and with remodulation the rotation 6 (a complex product). The cubic's coefficients depend on the
taps alone and are formed in the layout, once per tap base, not per term.
So a real term of one frame is 14 flops, and a complex remodulated term of
4 frames 28 + 4 x 20 = 108.

Bytes: the traces read once (4 bytes a real sample, 8 a complex one) and
the image written once.
"""
from __future__ import annotations

from . import PEAKS


def flops(pixels: int, rx: int, tx: int, frames: int, cplx: bool, rotate: bool) -> float:
    """Least flops of one summed cubic DAS call over ``frames`` frames."""
    terms = float(pixels) * rx * tx
    per_term = 7.0 + (21.0 if rotate else 0.0)
    per_frame = (14.0 + (6.0 if rotate else 0.0)) if cplx else 7.0
    return terms * (per_term + per_frame * frames)


def bytes_moved(pixels: int, rx: int, tx: int, frames: int, T: int, cplx: bool) -> float:
    """Least bytes of the same call: traces in, image out."""
    unit = 8 if cplx else 4
    return float(T) * rx * tx * frames * unit + float(pixels) * frames * unit


def bound_s(pixels: int, rx: int, tx: int, frames: int, T: int, cplx: bool,
            rotate: bool) -> float:
    """The least time of the call on the card, float32 operations against
    their peak and bytes against the memory's."""
    return max(flops(pixels, rx, tx, frames, cplx, rotate) / PEAKS["f32_flop_per_s"],
               bytes_moved(pixels, rx, tx, frames, T, cplx) / PEAKS["hbm_byte_per_s"])
