"""kernel.greens_roofline: the least time of the window's simulations'
frequency GEMMs (frozen counts, usbench/counts/greens.py: 8 F S N M flops
against the card's float32 peak; F the echo kernel's band on the window of
each cloud's bounding box) over the device time of kernel K3
(``k3_kernel``, csrc/greens_freq.cu), in percent."""
import numpy as np

from usbench.counts import greens
from usbench.reference import geometry


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = tr.device_us(lambda n: "k3_kernel" in n) * 1e-6
    calls = [c for r in run.requests if r.ok for c in r.calls.greens]
    if not busy or not calls:
        return None
    cfg = run.cell.config
    td = cfg["transducer"]
    ele = geometry.elements(cfg)
    bins = {}
    total = 0.0
    for c in calls:
        box = tuple(map(tuple, c["box"]))
        if box not in bins:
            bins[box] = greens.band_bins(
                np.array(box, np.float32), ele, fc=float(td["fc"]),
                bw=(float(td["bw"][1]) - float(td["bw"][0])) / float(td["fc"]),
                fs=float(cfg["fs"]), c0=float(cfg["c0"]))
        total += greens.bound_s(bins[box], c["S"], c["N"], c["M"])
    return 100.0 * total / busy
