"""system.greens_plan_ms: host milliseconds a request in the program's
planning spans of a simulation, ``qups.greens.problem`` (the kernel
waveform's convolutions, the scatterers' time bounds),
``qups.greens_freq.plan`` (the kernel's spectrum, the band) and
``qups.focus_tx.plan`` (the transmit delays and weights), outside the CUDA
calls that wait on the card or copy with it; the profiler's host records."""
from usbench import spans

PLANS = ("qups.greens.problem", "qups.greens_freq.plan", "qups.focus_tx.plan")


def read(run):
    tr = run.trace
    return None if tr is None else spans.per_request_ms(run, spans.host_us(tr, *PLANS))
