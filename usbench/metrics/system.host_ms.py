"""system.host_ms: host milliseconds a request spends in the entry call
(``UltrasoundSystem.DAS`` / ``.greens``, the benchmark's ``usbench.entry``
range) outside the CUDA calls that wait on the card or copy with it: host
geometry, planning and dispatch. Mean over the window's requests; the
profiler's host records."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    us = tr.host_us("usbench.entry")
    return None if us is None else us * 1e-3 / len(run.requests)
