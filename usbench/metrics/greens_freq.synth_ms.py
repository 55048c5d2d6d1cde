"""greens_freq.synth_ms: device milliseconds a request inside the device
side of the program's span ``qups.greens_freq.synth`` (the kernel spectrum
times the GEMM's bins, the inverse rfft), from the device trace."""
from usbench import spans


def read(run):
    tr = run.trace
    return None if tr is None else spans.per_request_ms(
        run, tr.range_device_us("qups.greens_freq.synth"))
