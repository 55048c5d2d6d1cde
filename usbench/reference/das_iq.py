"""The plain reference of the ``das_iq`` entry: the analytic signal of the
RF traces, downmixed by fc, then cubic delay-and-sum remodulated by fc."""
from usbench.reference.das import das_image
from usbench.reference.dsp import analytic, downmix


def image(cfg: dict, trf: dict, x, idx, device=None, taps=None):
    fs, t0 = float(cfg["fs"]), float(cfg["t0"])
    fc = float(cfg["transducer"]["fc"])
    return das_image(cfg, x, idx, t0=t0, fmod=fc, taps=taps,
                     prep=lambda xm: downmix(analytic(xm), fc, t0, fs))
