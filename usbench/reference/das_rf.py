"""The plain reference of the ``das_rf`` entry: cubic delay-and-sum of the
RF traces."""
from usbench.reference.das import das_image


def image(cfg: dict, trf: dict, x, idx, device=None, taps=None):
    return das_image(cfg, x, idx, t0=float(cfg["t0"]), taps=taps)
