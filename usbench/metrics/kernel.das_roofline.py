"""kernel.das_roofline: the least time of the window's DAS calls (frozen
counts, usbench/counts/das.py, against the card's published peaks), each
counted from the traces the entry handed it (length, real or complex,
remodulated or not), over the device time of the DAS kernels
(``das_kernel``, ``das_frames_kernel``, csrc/das.cu), in percent."""
import re

from usbench.counts import das

KERNELS = re.compile(r"\bdas_(frames_)?kernel\b")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = tr.device_us(lambda n: KERNELS.search(n) is not None) * 1e-6
    calls = [c for r in run.requests if r.ok for c in r.calls.das]
    if not busy or not calls:
        return None
    return 100.0 * sum(das.bound_s(**c) for c in calls) / busy
