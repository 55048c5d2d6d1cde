"""The general generator: a cell's inputs from its seed, the system under
test from its configuration, and the request its traffic file names.

A traffic file (``traffic/<traffic>.json``) names its input generator
(``input``: ``inputs/<input>.py``, ``make(cfg, trf, seed, device)``, which
returns the inputs, request i reading input i mod their number) and its
entry (``entry``: ``entries/<entry>.py``, ``request_fn(cfg, trf, us,
device)``, which returns ``request(x, calls)``: the program's
call on input ``x``, its image copied to the host). ``frames`` is the frames
a request (0: a single frame, no frame axis).

The program is reached only through ``qups_tpu_torch``'s public
``UltrasoundSystem``, ``ChannelData``, ``Scatterers``, ``TransducerArray``,
``SequenceRadial`` and ``ScanCartesian``.
"""
from __future__ import annotations

import numpy as np

from . import spec
from .reference import geometry

SEED_MOD = 1 << 63


def frames(trf: dict) -> int:
    """Frames a request images."""
    return max(1, int(trf["frames"]))


def make_inputs(cfg: dict, trf: dict, seed: int, device, base=spec.HERE):
    """The cell's inputs, the same for the same seed."""
    return spec.module("inputs", trf["input"], base).make(cfg, trf, int(seed) % SEED_MOD,
                                                           device)


def build_system(cfg: dict):
    """The ``UltrasoundSystem`` of a configuration file."""
    import qups_tpu_torch as q

    td = cfg["transducer"]
    xdc = q.TransducerArray(numel=int(td["numel"]), pitch=float(td["pitch"]),
                            width=float(td["pitch"]), fc=float(td["fc"]),
                            bw=tuple(float(b) for b in td["bw"]))
    if cfg["sequence"]["type"] != "PW":
        raise ValueError(f"unknown sequence {cfg['sequence']['type']!r}")
    seq = q.SequenceRadial(type="PW", angles=geometry.angles_deg(cfg), c0=float(cfg["c0"]))
    scan = q.ScanCartesian(x=geometry.axis(cfg["scan"]["x"]),
                           z=geometry.axis(cfg["scan"]["z"]))
    return q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=float(cfg["fs"]))


def request_fn(cfg: dict, trf: dict, us, device, base=spec.HERE):
    """``request(x, calls) -> host image``: the traffic's entry."""
    return spec.module("entries", trf["entry"], base).request_fn(cfg, trf, us, device)


class Calls:
    """What one request asked of the program's kernels, as the entry saw
    it: ``das``, one dict a DAS call (pixels, rx, tx, frames, T, cplx,
    rotate: the traces it was handed), and ``greens``, one a simulation (S
    scatterers, N, M elements, the scatterers' bounding box)."""

    def __init__(self):
        self.das, self.greens = [], []

    def das_call(self, cfg: dict, data, fmod: float):
        shape = tuple(data.shape)
        self.das.append(dict(
            pixels=int(cfg["scan"]["x"][2]) * int(cfg["scan"]["z"][2]), rx=int(shape[1]),
            tx=int(shape[2]), frames=int(np.prod(shape[3:], dtype=np.int64)), T=int(shape[0]),
            cplx=bool(data.is_complex()), rotate=float(fmod) != 0.0))

    def greens_call(self, pos: np.ndarray, n_rx: int, n_tx: int):
        self.greens.append(dict(S=int(pos.shape[0]), N=int(n_rx), M=int(n_tx),
                                box=[pos.min(0).tolist(), pos.max(0).tolist()]))


class Reservoir:
    """A uniform sample of ``k`` of the requests offered, drawn from the seed
    (Algorithm R), without knowing beforehand how many come: ``slot(i)``
    gives the slot request i takes in the sample, or None; ``index[j]`` is
    the request that slot j holds."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.index = max(1, int(k)), 0, []
        self.rng = np.random.default_rng([int(seed) % SEED_MOD, 1])

    def slot(self, i: int):
        self.n += 1
        if len(self.index) < self.k:
            self.index.append(i)
            return len(self.index) - 1
        j = int(self.rng.integers(0, self.n))
        if j < self.k:
            self.index[j] = i
            return j
        return None
