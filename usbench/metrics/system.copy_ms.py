"""system.copy_ms: device milliseconds a request of host-device copies
(the profiler's HtoD and DtoH memcpy records): the geometry the entry
uploads and the image coming back."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    us = tr.device_us(lambda n: n.startswith(("Memcpy HtoD", "Memcpy DtoH")))
    return us * 1e-3 / len(run.requests)
