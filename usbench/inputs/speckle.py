"""A new cloud of ``scatterers`` point scatterers a request, uniform over
the scan's region (y = 0) with normal amplitudes, drawn on the host from
(seed, request); two silent scatterers (amplitude 0) at the region's
corners fix the simulation's time window, so that every cloud has the
same sizes."""
import numpy as np


class Clouds:
    """Request i's scatterers, ``{"pos": (S + 2, 3), "amp": (S + 2,)}``
    float32, the same for the same seed; indexable without end."""

    def __init__(self, cfg: dict, trf: dict, seed: int):
        self.seed, self.S = seed, int(trf["scatterers"])
        (self.x0, self.x1), (self.z0, self.z1) = (
            (float(cfg["scan"][k][0]), float(cfg["scan"][k][1])) for k in ("x", "z"))

    def __len__(self) -> int:
        return 1 << 62

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng([self.seed, int(i)])
        S = self.S
        pos = np.zeros((S + 2, 3), np.float32)
        pos[:S, 0] = rng.uniform(self.x0, self.x1, S)
        pos[:S, 2] = rng.uniform(self.z0, self.z1, S)
        pos[S:, 0], pos[S:, 2] = (self.x0, self.x1), (self.z0, self.z1)
        amp = np.zeros(S + 2, np.float32)
        amp[:S] = rng.standard_normal(S)
        return {"pos": pos, "amp": amp}


def make(cfg: dict, trf: dict, seed: int, device) -> Clouds:
    return Clouds(cfg, trf, seed)
