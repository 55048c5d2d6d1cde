"""Whether what the timed path produced is correct.

A sample of the window's requests drawn from the seed (the traffic's
``check_requests``) is judged: each one's image at pixels drawn from the
seed (the traffic's ``check_pixels``), every frame, against the plain
reference of its entry (``reference/<entry>.py``) on the same input. The
number compared is

    image_err = max |image - reference| / max |reference|

over a request's checked pixels and frames, the worst request of the run;
its limit is the cell's (``limits/<cell>.json``).

The control, which the limit was set to fail: the entry's own
(``entries/<entry>.py``'s ``control``: the program on its own path at the
lower precision) where it has one, else the reference itself with its taps
rounded to the traffic's ``control`` precision (``precisions/<name>.py``)
in the program's place.
"""
from __future__ import annotations

import numpy as np

from . import spec


def reference(cell: spec.Cell, x, idx: np.ndarray, device, taps=None) -> np.ndarray:
    """The reference image (K, F) of input ``x`` at flat pixel indices
    ``idx``, its taps through ``taps``."""
    ref = spec.module("reference", cell.traffic["entry"], cell.base)
    return ref.image(cell.config, cell.traffic, x, idx, device=device, taps=taps)


def control(cell: spec.Cell, x, idx: np.ndarray, device) -> np.ndarray:
    """The control's image (K, F) of input ``x`` at ``idx``."""
    entry = spec.module("entries", cell.traffic["entry"], cell.base)
    if hasattr(entry, "control"):
        return entry.control(cell.config, cell.traffic, x, idx, device)
    rnd = spec.module("precisions", cell.traffic["control"], cell.base).round
    return reference(cell, x, idx, device, taps=rnd)


def image_err(values: np.ndarray, ref: np.ndarray) -> float:
    """max |values - ref| / max |ref|."""
    scale = float(np.max(np.abs(ref)))
    values = np.asarray(values)
    return float(np.max(np.abs(values.astype(np.result_type(values, ref)) - ref)) / scale)
