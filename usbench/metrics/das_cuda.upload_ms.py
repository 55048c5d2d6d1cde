"""das_cuda.upload_ms: host wall milliseconds a request in the program's
span ``qups.das_cuda.operands`` (``das_sum``, ``das_lut_sum`` and the keep
kernel's weights: the geometry made float32 on the card), the waits and
copies inside it included, since a copy from pageable memory holds the
host; the profiler's host records."""
from usbench import spans


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return spans.per_request_ms(run, spans.host_us(tr, "qups.das_cuda.operands", waits=True))
