"""Geometry of a configuration, from its file alone.

Pixels: a Cartesian grid, image axes (z, x) in that order (depth rows,
lateral columns), y = 0; flat pixel index ``i = iz * nx + ix``. Elements: a
linear array of ``numel`` elements at ``pitch``, centred on x = 0 at
y = z = 0. Plane waves: unit directions ``(sin a, 0, cos a)`` through the
origin for angles ``a`` in degrees. Everything is float64 until it is
rounded to float32, the precision of the configurations.
"""
from __future__ import annotations

import numpy as np


def axis(spec) -> np.ndarray:
    """``[lo, hi, n]`` as n evenly spaced values from lo to hi, float64."""
    lo, hi, n = spec
    return np.linspace(float(lo), float(hi), int(n))


def grid_shape(cfg) -> tuple:
    """(nz, nx): the image's rows (depth) and columns (lateral)."""
    return int(cfg["scan"]["z"][2]), int(cfg["scan"]["x"][2])


def sample_pixels(cfg, k: int, rng: np.random.Generator) -> np.ndarray:
    """``k`` distinct flat pixel indices drawn by ``rng``, sorted (int64)."""
    nz, nx = grid_shape(cfg)
    k = min(int(k), nz * nx)
    return np.sort(rng.choice(nz * nx, size=k, replace=False)).astype(np.int64)


def pixel_positions(cfg, idx: np.ndarray) -> np.ndarray:
    """(K, 3) float32 positions of flat pixel indices ``idx``."""
    x, z = axis(cfg["scan"]["x"]), axis(cfg["scan"]["z"])
    iz, ix = np.divmod(np.asarray(idx, np.int64), len(x))
    return np.stack([x[ix], np.zeros(len(ix)), z[iz]], -1).astype(np.float32)


def elements(cfg) -> np.ndarray:
    """(N, 3) float32 element centres."""
    n, pitch = int(cfg["transducer"]["numel"]), float(cfg["transducer"]["pitch"])
    half = (n - 1) * pitch / 2
    return np.stack([np.linspace(-half, half, n), np.zeros(n), np.zeros(n)],
                    -1).astype(np.float32)


def angles_deg(cfg) -> np.ndarray:
    return axis(cfg["sequence"]["angles_deg"])


def plane_waves(cfg) -> np.ndarray:
    """(M, 3) float32 plane-wave directions."""
    a = np.radians(angles_deg(cfg))
    return np.stack([np.sin(a), np.zeros(len(a)), np.cos(a)], -1).astype(np.float32)


def max_delay_samples(cfg) -> float:
    """The largest delay, in samples after ``t0``, of any pixel, element and
    plane wave (float64): the time axis a configuration needs."""
    x, z = axis(cfg["scan"]["x"]), axis(cfg["scan"]["z"])
    X, Z = np.meshgrid(x, z)
    ex = elements(cfg).astype(np.float64)[:, 0]
    a = np.radians(angles_deg(cfg))
    # x sin a + z cos a is largest at the angle nearest the pixel's own
    # direction (an upper bound over the discrete angles); the receive path
    # at an end element
    ab = np.clip(np.arctan2(X, Z), a.min(), a.max())
    dv = X * np.sin(ab) + Z * np.cos(ab)
    dr = np.maximum(np.hypot(X - ex.min(), Z), np.hypot(X - ex.max(), Z))
    return float(((dv + dr) / float(cfg["c0"]) - float(cfg["t0"])).max() * float(cfg["fs"]))
