"""RF traces of seeded Gaussian noise band-limited to the array's band
(``transducer.bw``): ``randn`` on the device from a ``torch.Generator``
seeded with the seed, then the bins of its real FFT outside the band set
to zero. ``resident`` of them, (T, N, M[, frames]) float32, on the card."""
import numpy as np
import torch


def trace_shape(cfg: dict, trf: dict) -> tuple:
    """(T, N, M[, F]) of one input."""
    shape = (int(cfg["T"]), int(cfg["transducer"]["numel"]),
             int(cfg["sequence"]["angles_deg"][2]))
    return shape + ((int(trf["frames"]),) if int(trf["frames"]) else ())


def band_noise(shape: tuple, fs: float, band, gen: torch.Generator,
               device) -> torch.Tensor:
    """Gaussian noise (T, ...) float32 band-limited to ``band`` (Hz) along
    the time axis."""
    T = shape[0]
    x = torch.randn((T, int(np.prod(shape[1:]))), generator=gen, device=device)
    X = torch.fft.rfft(x, dim=0)
    del x
    f = torch.fft.rfftfreq(T, d=1.0 / fs, device=device)
    X[(f < band[0]) | (f > band[1])] = 0
    return torch.fft.irfft(X, n=T, dim=0).reshape(shape).contiguous()


def make(cfg: dict, trf: dict, seed: int, device) -> list:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [band_noise(trace_shape(cfg, trf), float(cfg["fs"]), cfg["transducer"]["bw"],
                       gen, device) for _ in range(int(trf["resident"]))]
