"""Tracing and timing helpers.

Port of :mod:`qups_tpu.utils.profiling` on ``torch.profiler``: ``trace``
records the host and, where a CUDA card is present, the device into a
Chrome trace (open it in ``chrome://tracing`` or Perfetto; no tensorboard
package needed); ``annotate`` names a region of that trace; ``Timer`` keeps
named wall-clock sections and, given a CUDA tensor to wait for, stops its
clock only once that tensor's device has finished.

The port's own spans go through ``annotate``, named ``qups.<layer>[.<phase>]``
(``qups.das``, ``qups.das.geometry``, ``qups.das_cuda.k1``, ...): ranges of
whatever ``torch.profiler`` session is recording, on the clock of its device
records, nested on the host as the calls nest. With no profiler recording a
span costs one check.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block into ``logdir/trace.json`` (a Chrome trace), with
    CUDA activity where a card is present. The device is synchronised before
    the profiler stops, so kernels still queued at the end are recorded::

        with qups_tpu_torch.utils.trace("prof"):
            with qups_tpu_torch.utils.annotate("das"):
                img = us.DAS(chd)

    Yields the ``torch.profiler.profile`` object (``key_averages()`` and
    ``events()`` read it after the block).
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    """Named wall-clock sections with device synchronisation.

    >>> tm = Timer()
    >>> with tm("beamform", sync=img_like):
    ...     img = f(x)
    >>> tm.times  # {"beamform": seconds}

    ``sync`` is a tensor (or a list of tensors) whose CUDA device is
    synchronised before the clock stops; host tensors and other values need
    no wait.
    """

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for t in sync if isinstance(sync, (list, tuple)) else (sync,):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    torch.cuda.synchronize(t.device)
            self.times[name] = self.times.get(name, 0.0) + (time.perf_counter() - t0)


_OFF = contextlib.nullcontext()  # the span of every annotate while no profiler records


def annotate(name: str):
    """A named region of the profiler's trace:
    ``with annotate("das"): ...``. While no profiler records, the one
    shared no-op context manager, which records nothing.

    On the card the range also has a device side (the profiler's
    ``gpu_user_annotation``), from the first to the last record launched
    inside it and not inside a range nested in it: the profiler gives each
    kernel to the innermost range around its launch."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
