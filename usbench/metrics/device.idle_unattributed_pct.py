"""device.idle_unattributed_pct: of the card's idle time in the entry call
(gaps whose midpoint lies in ``usbench.entry``), the share in percent that
no program span below ``qups.das`` or ``qups.greens`` puts down to a phase:
idle the program's spans leave unexplained (``usbench/spans.py``)."""
from usbench import spans


def read(run):
    tr = run.trace
    return None if tr is None or not tr.device else spans.idle_unattributed_pct(tr)
