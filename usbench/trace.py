"""The traced window, read from ``torch.profiler``'s events in memory.

Device records are the kernels, copies and sets the card ran (the
profiler's CUDA events that are not user annotations); the benchmark's own
spans are its ``record_function`` ranges, named ``usbench.*``: the window,
and in each request ``usbench.request`` with ``usbench.dsp``,
``usbench.entry`` and ``usbench.to_host`` inside it. Host records that
wait on the card or copy with it are the CUDA runtime's and driver's
synchronising calls and memory copies (``WAITS``). Times are the profiler's
microseconds, device records clipped to the window.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

WINDOW = "usbench.window"
NAME_CHARS = 120  # a device record's name in the breakdown, at most
WAITS = re.compile(r"^cu(da)?\w*(Synchronize|Memcpy)")


def _device_type(e) -> str:
    return getattr(e.device_type, "name", str(e.device_type)).upper()


def _union(intervals):
    """Sorted disjoint intervals covering ``intervals``."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


class TraceView:
    def __init__(self, events):
        events = list(events)
        win = [e for e in events if e.name == WINDOW and _device_type(e) == "CPU"]
        if not win:
            raise ValueError(f"the trace holds no {WINDOW!r} range")
        self.w0, self.w1 = win[0].time_range.start, win[0].time_range.end
        self.thread = win[0].thread
        self.device = []        # (name, start, end), clipped to the window
        self.annotations = defaultdict(list)  # device side of a named range
        self.spans = defaultdict(list)        # host side of the benchmark's ranges
        self.cpu = []           # (start, end, name) of the main thread's host records
        self.waits = []         # (start, end) of host records that wait on the card
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if _device_type(e) == "CUDA":
                if getattr(e, "is_user_annotation", False) or e.name.startswith("usbench."):
                    self.annotations[e.name].append((s, t))
                elif "Activity Buffer" not in e.name:
                    s, t = max(s, self.w0), min(t, self.w1)
                    if t > s:
                        self.device.append((e.name, s, t))
            elif _device_type(e) == "CPU":
                if e.name.startswith("usbench."):
                    self.spans[e.name].append((s, t))
                elif WAITS.match(e.name):
                    self.waits.append((s, t))
                if e.thread == self.thread:
                    self.cpu.append((s, t, e.name))
        self.busy = _union((s, t) for _, s, t in self.device)
        self.waits = _union(self.waits)

    @property
    def window_us(self) -> float:
        return self.w1 - self.w0

    @property
    def busy_us(self) -> float:
        return sum(t - s for s, t in self.busy)

    def device_us(self, pred) -> float:
        """Device microseconds of the records whose name satisfies ``pred``."""
        return sum(t - s for n, s, t in self.device if pred(n))

    def range_device_us(self, name: str):
        """Device microseconds of the records inside the device-side spans
        of the benchmark's range ``name``; None where the trace holds no
        such span."""
        spans = _union(self.annotations.get(name, ()))
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, t in self.device:
            k = bisect.bisect_right(starts, s) - 1
            while 0 <= k < len(spans) and spans[k][0] < t:
                total += max(0.0, min(t, spans[k][1]) - max(s, spans[k][0]))
                k += 1
        return total

    def host_us(self, name: str):
        """Host microseconds inside the benchmark's range ``name`` outside
        the records that wait on the card or copy with it; None where the
        range never ran."""
        if name not in self.spans:
            return None
        total = 0.0
        for s, t in _union(self.spans[name]):
            total += t - s
            k = bisect.bisect_right([a for a, _ in self.waits], s) - 1
            for a, b in self.waits[max(k, 0):]:
                if a >= t:
                    break
                total -= max(0.0, min(t, b) - max(s, a))
        return total

    def gaps(self):
        """The idle intervals of the window, (start, end)."""
        out, prev = [], self.w0
        for s, t in self.busy:
            if s > prev:
                out.append((prev, s))
            prev = max(prev, t)
        if self.w1 > prev:
            out.append((prev, self.w1))
        return out

    def _host_at(self, times):
        """For each time (sorted), what the main thread did: the innermost
        benchmark range and the innermost host record around it."""
        cpu = sorted(self.cpu, key=lambda r: (r[0], -r[1]))
        stack, k, out = [], 0, []
        for x in times:
            while k < len(cpu) and cpu[k][0] <= x:
                while stack and stack[-1][1] < cpu[k][0]:
                    stack.pop()
                stack.append(cpu[k])
                k += 1
            while stack and stack[-1][1] < x:
                stack.pop()
            inner = [r[2] for r in stack]
            ours = [n for n in inner if n.startswith("usbench.")]
            label = ours[-1] if ours else "outside the benchmark's ranges"
            if inner and inner[-1] != label:
                label += " > " + inner[-1]
            out.append(label)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device records that took most time, and the idle time by
        what the host was doing, in seconds, ``top`` of each."""
        ops = defaultdict(float)
        for n, s, t in self.device:
            ops[n[:NAME_CHARS]] += (t - s) * 1e-6
        gaps = self.gaps()
        idle = defaultdict(float)
        order = sorted(range(len(gaps)), key=lambda j: (gaps[j][0] + gaps[j][1]) / 2)
        labels = self._host_at([(gaps[j][0] + gaps[j][1]) / 2 for j in order])
        for j, label in zip(order, labels):
            idle[label[:NAME_CHARS]] += (gaps[j][1] - gaps[j][0]) * 1e-6
        pick = lambda d: [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(ops), "idle_gaps": pick(idle)}
