"""das_cuda.layout_ms: device milliseconds a request of the layout kernel
(``layout_kernel``, csrc/das.cu), which writes the traces into the
stencil layout the DAS kernels read."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    us = tr.device_us(lambda n: "layout_kernel" in n)
    return us * 1e-3 / len(run.requests) if us else None
