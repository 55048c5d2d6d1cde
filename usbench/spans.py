"""The program's own spans in a traced window, read from a ``TraceView``.

The port names its spans ``qups.<layer>[.<phase>]`` (``qups_tpu_torch.utils.
annotate``): ``torch.profiler`` ranges, recorded by the profiler that
records the device and on its clock. Their host side is among the main
thread's host records (``TraceView.cpu``), nested as the calls nest; the
device side of those that have one is among ``TraceView.annotations``, from
the first to the last device record launched in the range and not in a
range nested in it (the profiler gives a kernel to the innermost range
around its launch). ``TraceView.host_us`` reads only the benchmark's own
``usbench.*`` ranges; these read any name. Each returns None where no such
span ran, as in a program without them.
"""
from __future__ import annotations

import bisect

from .trace import _union

PREFIX = "qups."
ENTRY = "usbench.entry"
ROOTS = ("qups.das", "qups.greens")  # the entry calls; phases are the spans below them


def ranges(tr, *names) -> list:
    """The host ranges (start, end) of the spans ``names`` that start in the
    window, in start order."""
    want = set(names)
    return sorted((s, t) for s, t, n in tr.cpu if n in want and tr.w0 <= s <= tr.w1)


def host_us(tr, *names, waits: bool = False):
    """Host microseconds inside the spans ``names`` (their union, so a span
    nested in another counts once), outside the records that wait on the
    card or copy with it (``TraceView.waits``) unless ``waits``."""
    spans = _union(ranges(tr, *names))
    if not spans:
        return None
    starts = [a for a, _ in tr.waits]
    total = 0.0
    for s, t in spans:
        total += t - s
        if waits:
            continue
        k = max(bisect.bisect_right(starts, s) - 1, 0)
        for a, b in tr.waits[k:]:
            if a >= t:
                break
            total -= max(0.0, min(t, b) - max(s, a))
    return total


def count(tr, name: str):
    """How many spans ``name`` started in the window."""
    n = len(ranges(tr, name))
    return n or None


def per_request_ms(run, us):
    """Microseconds over the window as milliseconds a request."""
    return None if us is None or not run.requests else us * 1e-3 / len(run.requests)


def _around(tr, times) -> list:
    """For each time (sorted), the names of the main thread's host records
    around it, outermost first."""
    cpu = sorted(tr.cpu, key=lambda r: (r[0], -r[1]))
    stack, k, out = [], 0, []
    for x in times:
        while k < len(cpu) and cpu[k][0] <= x:
            while stack and stack[-1][1] < cpu[k][0]:
                stack.pop()
            stack.append(cpu[k])
            k += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        out.append([r[2] for r in stack])
    return out


def idle_unattributed_pct(tr):
    """The share, in percent, of the idle time whose gap's midpoint lies in
    the benchmark's entry range (``usbench.entry``) that no program span
    below the entry calls (``qups.das``, ``qups.greens``) puts down to a
    phase: a gap counts as put down when a ``qups.*`` span other than those
    two is around its midpoint. None where the window holds no entry call
    with a span, or no idle time in the entry."""
    if not any(n in ROOTS for _, _, n in tr.cpu):
        return None
    gaps = sorted(tr.gaps(), key=lambda g: g[0] + g[1])
    names = _around(tr, [(s + t) / 2 for s, t in gaps])
    inside = bare = 0.0
    for (s, t), around in zip(gaps, names):
        if ENTRY not in around:
            continue
        inside += t - s
        if not any(n.startswith(PREFIX) and n not in ROOTS for n in around):
            bare += t - s
    return 100.0 * bare / inside if inside else None
