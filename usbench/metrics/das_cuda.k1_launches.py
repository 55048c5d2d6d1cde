"""das_cuda.k1_launches: K1 launches a request (``das_kernel``,
``das_frames_kernel``, ``das_keep_kernel``; csrc/das.cu): the program's
spans ``qups.das_cuda.k1`` in the window, one a launch, over the window's
requests."""
from usbench import spans


def read(run):
    tr = run.trace
    n = None if tr is None else spans.count(tr, "qups.das_cuda.k1")
    return None if n is None else n / len(run.requests)
