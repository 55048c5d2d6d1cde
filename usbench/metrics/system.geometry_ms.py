"""system.geometry_ms: host milliseconds a request in the program's span
``qups.das.geometry`` (``UltrasoundSystem.DAS``: the transmit geometry, the
pixel grid, the receivers, the fused-weight operands) outside the CUDA calls
that wait on the card or copy with it; the profiler's host records."""
from usbench import spans


def read(run):
    tr = run.trace
    return None if tr is None else spans.per_request_ms(run, spans.host_us(tr, "qups.das.geometry"))
