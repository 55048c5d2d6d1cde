"""The benchmark's plain reference: PyTorch and NumPy only.

Written from the delay-and-sum and signal-processing definitions, not from
the measured program: it imports nothing of the program, reads only the
configuration file and the inputs the benchmark made, and works out again
everything the program derives from them (pixel grid, element positions,
plane-wave directions, delays, the analytic signal, the downmix, the
remodulation). Delays, time axes and phases are formed in float32, the
precision the configurations state; taps, weights, products and sums in
float64.
"""
from .geometry import elements, pixel_positions, plane_waves, sample_pixels
from .das import das_at, das_image
from .dsp import analytic, downmix

__all__ = ["elements", "pixel_positions", "plane_waves", "sample_pixels", "das_at", "das_image",
           "analytic", "downmix"]
