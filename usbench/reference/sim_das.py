"""The plain reference of the ``sim_das`` entry: a cloud's FSA echoes by
the Green's function, the sequence's plane waves synthesised from them
(``sim.py``), then cubic delay-and-sum of those traces."""
import numpy as np
import torch

from usbench.reference import sim
from usbench.reference.das import das_image
from usbench.reference.geometry import elements, plane_waves


def simulated(cfg: dict, cloud: dict, device):
    """The plane-wave echoes of a cloud, (T, N, W) complex128, and their t0."""
    td = cfg["transducer"]
    fc, c0, fs = float(td["fc"]), float(cfg["c0"]), float(cfg["fs"])
    ele = elements(cfg).astype(np.float64)
    with torch.no_grad():
        x, s0 = sim.fsa_echoes(cloud["pos"], cloud["amp"], ele, fc=fc,
                               bw=(float(td["bw"][1]) - float(td["bw"][0])) / fc, fs=fs,
                               c0=c0, R0=c0 / fc, device=device)
        return sim.plane_wave_synthesis(x, s0, ele, plane_waves(cfg).astype(np.float64),
                                        fs=fs, c0=c0)


def image(cfg: dict, trf: dict, x, idx, device=None, taps=None):
    y, t0 = simulated(cfg, x, device)
    return das_image(cfg, y, idx, t0=t0, taps=taps)
