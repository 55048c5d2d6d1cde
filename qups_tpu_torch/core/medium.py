"""Heterogeneous media, the port of :mod:`qups_tpu.core.medium`.

QUPS's ``Medium`` (``src/Medium.m:13-796``): ambient material constants
(``c0``, ``rho0``, ``bona0``, ``alpha0``, ``alpha_power``) plus perturbation
regions, sampled onto a Scan grid by :meth:`Medium.props`
(``Medium.m:129``). Property maps are geometry, so they stay float64 host
numpy, as in the JAX package.

Perturbation regions are (mask_fn, values) pairs: ``mask_fn(P) -> bool`` over
cartesian positions ``P (3, ...)``, and ``values`` either a dict of scalar
property overrides or a callable ``P -> dict`` of arrays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

PROPS = ("c", "rho", "bona", "alpha")


@dataclass(frozen=True)
class Medium:
    c0: float = 1540.0        # ambient sound speed [m/s]
    rho0: float = 1000.0      # ambient density [kg/m^3]
    bona0: float = float("nan")   # ambient nonlinearity B/A
    alpha0: float = float("nan")  # ambient attenuation [dB/cm/MHz]
    alpha_power: float = 1.01
    pertreg: Tuple = ()       # ((mask_fn, values), ...)

    def replace(self, **changes) -> "Medium":
        return dataclasses.replace(self, **changes)

    def _ambient(self, key: str):
        return {"c": self.c0, "rho": self.rho0, "bona": self.bona0,
                "alpha": self.alpha0}[key]

    def props(self, scan, keys: Union[str, Sequence[str]] = "c"
              ) -> Union[np.ndarray, Dict[str, np.ndarray]]:
        """Sample property maps on a Scan grid (``Medium.props``,
        ``Medium.m:129``). Returns a single array for a string key, else a
        dict of arrays, each shaped ``scan.shape``, float64.

        Example:
            import numpy as np
            import qups_tpu_torch as q
            scan = q.ScanCartesian(x=np.linspace(-1e-3, 1e-3, 3), z=np.linspace(0, 4e-3, 5))
            med = q.Medium(c0=1540.0, pertreg=((lambda P: P[2] < 2e-3, {"c": 1300.0}),))
            c = med.props(scan, "c")
            assert c.shape == scan.shape and c.min() == 1300.0 and c.max() == 1540.0
        """
        single = isinstance(keys, str)
        klist = [keys] if single else list(keys)
        P = scan.positions()  # (3, I1, I2, I3)
        out = {k: np.full(P.shape[1:], self._ambient(k), dtype=np.float64) for k in klist}
        for mask_fn, values in self.pertreg:
            m = np.asarray(mask_fn(P), dtype=bool)
            vals = values(P) if callable(values) else values
            for k in klist:
                if k in vals:
                    v = vals[k]
                    if np.ndim(v) == 0:
                        out[k][m] = v
                    else:
                        out[k][m] = np.broadcast_to(v, m.shape)[m]
        return out[klist[0]] if single else out

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "Medium":
        return dataclasses.replace(
            self, c0=self.c0 * dist / time,
            rho0=self.rho0 / dist**3,
        )

    # ---------------------------------------------------------- constructors
    @staticmethod
    def Sampled(scan, c: Optional[np.ndarray] = None, rho: Optional[np.ndarray] = None,
                bona: Optional[np.ndarray] = None, alpha: Optional[np.ndarray] = None,
                method: str = "cubic", **ambient) -> "Medium":
        """Medium defined by gridded property arrays on ``scan``
        (``Medium.Sampled``, ``Medium.m:465``); samples are looked up by
        gridded interpolation at query positions, cubic by default like the
        reference's gridded interpolants (``method``: 'nearest' | 'linear'
        | 'cubic')."""
        med = Medium(**ambient)
        arrays = {k: np.asarray(v, dtype=np.float64)
                  for k, v in (("c", c), ("rho", rho), ("bona", bona), ("alpha", alpha))
                  if v is not None}
        if not arrays:
            return med
        axes = scan.axes
        order = scan.order

        def lookup(P):
            # map cartesian positions onto the source grid's data axes
            from .scan import ScanCartesian
            from ..utils.maths import gridded_interp
            assert isinstance(scan, ScanCartesian), "Sampled requires a cartesian scan"
            comp = {"X": P[0], "Y": P[1], "Z": P[2]}
            fis = []
            for dim, c_ in enumerate(order):
                ax = axes[dim]
                q = comp[c_]
                step = ax[1] - ax[0] if ax.size > 1 else 1.0
                fis.append((q - ax[0]) / step)
            return {k: gridded_interp(v, fis, method=method)
                    for k, v in arrays.items()}

        region = (lambda P: np.ones(P.shape[1:], dtype=bool), lookup)
        return dataclasses.replace(med, pertreg=med.pertreg + (region,))

    @staticmethod
    def Diffuse(scan, c0: float = 1540.0, rho0: float = 1000.0,
                rho_scat: float = 0.05, seed: int = 0) -> "Medium":
        """Speckle medium: ambient plus a seeded random density perturbation
        (``Medium.Diffuse``, ``Medium.m:591``)."""
        rng = np.random.default_rng(seed)
        noise = rho_scat * rho0 * rng.standard_normal(scan.shape)

        def lookup(P):
            return {"rho": rho0 + np.broadcast_to(noise, P.shape[1:])}

        region = (lambda P: np.ones(P.shape[1:], dtype=bool), lookup)
        return Medium(c0=c0, rho0=rho0, pertreg=(region,))
