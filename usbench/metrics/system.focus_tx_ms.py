"""system.focus_tx_ms: device milliseconds a request inside the device side
of the program's span ``qups.focus_tx`` (``UltrasoundSystem.focusTx``: the
transmit synthesis, its per-bin transmit GEMM), from the device trace."""
from usbench import spans


def read(run):
    tr = run.trace
    return None if tr is None else spans.per_request_ms(run, tr.range_device_us("qups.focus_tx"))
