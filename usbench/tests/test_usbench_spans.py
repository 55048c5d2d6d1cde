"""The readers of the program's own spans (``usbench/spans.py`` and the
metrics that use it) on a synthetic trace: host time outside the waits,
nested and repeated ranges, device time under a range's device side,
launch counts over requests, the idle time the spans put down to a phase,
and no number where the program has no spans."""
from types import SimpleNamespace

import pytest

from usbench import spans, spec
from usbench.trace import TraceView

NEW = ("system.geometry_ms", "das_cuda.upload_ms", "das_cuda.k1_launches",
       "system.greens_plan_ms", "greens_freq.synth_ms", "system.focus_tx_ms",
       "device.idle_unattributed_pct")


def _ev(name, s, t, dev="CPU", thread=1, user=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=t),
                           device_type=SimpleNamespace(name=dev), thread=thread,
                           is_user_annotation=user)


def _dev(name, s, t):
    return _ev(name, s, t, dev="CUDA")


def _side(name, s, t):  # the device side of a user range
    return _ev(name, s, t, dev="CUDA", user=True)


def _trace():
    """Two requests in a window of 200 us: a DAS, then a simulation and a
    DAS."""
    return TraceView([
        _ev("usbench.window", 0, 200),
        # request 1: DAS
        _ev("usbench.request", 0, 100), _ev("usbench.entry", 0, 90), _ev("qups.das", 0, 90),
        _ev("qups.das.geometry", 2, 12), _ev("cudaStreamSynchronize", 5, 8, thread=2),
        _ev("qups.das.geometry", 14, 20),
        _ev("qups.das_cuda.operands", 20, 30), _ev("cudaMemcpyAsync", 22, 28),
        _dev("Memcpy HtoD (Pageable -> Device)", 22, 28),
        _ev("qups.das_cuda.layout", 30, 31), _dev("void layout_kernel<1>(float const*)", 31, 33),
        _ev("qups.das_cuda.k1", 40, 41), _ev("qups.das_cuda.k1", 41, 42),
        _dev("void das_kernel<0, 1>(QArgs)", 42, 60), _dev("void das_kernel<0, 1>(QArgs)", 60, 80),
        _side("qups.das_cuda.k1", 42, 80),
        # request 2: a simulation, then DAS
        _ev("usbench.request", 100, 200), _ev("usbench.entry", 100, 190),
        _ev("qups.greens", 100, 150), _ev("qups.greens.problem", 100, 104),
        _ev("qups.greens_freq.plan", 104, 106),
        _ev("qups.greens_freq.synth", 110, 112), _side("qups.greens_freq.synth", 121, 129),
        _dev("void irfft", 121, 129),
        _ev("qups.focus_tx", 112, 118), _ev("qups.focus_tx.plan", 112, 113),
        _side("qups.focus_tx", 131, 139), _dev("void einsum", 131, 139),
        _ev("qups.das", 150, 190), _ev("qups.das_cuda.k1", 160, 161),
        _dev("void das_kernel<0, 1>(QArgs)", 162, 185), _side("qups.das_cuda.k1", 162, 185),
    ])


def _run(tv, requests=2):
    return SimpleNamespace(trace=tv, requests=list(range(requests)))


def test_host_time_leaves_out_the_waits_and_sums_repeated_ranges():
    tv = _trace()
    assert spans.host_us(tv, "qups.das.geometry") == (12 - 2 - 3) + (20 - 14)
    assert spans.host_us(tv, "qups.das_cuda.operands") == 10 - 6  # the copy waits
    assert spans.host_us(tv, "qups.das_cuda.operands", waits=True) == 10
    assert spec.reader("system.geometry_ms")(_run(tv)) == pytest.approx(13e-3 / 2)
    assert spec.reader("das_cuda.upload_ms")(_run(tv)) == pytest.approx(10e-3 / 2)


def test_a_range_nested_in_another_counts_once():
    tv = _trace()
    assert spans.host_us(tv, "qups.focus_tx", "qups.focus_tx.plan") == 6
    assert spans.host_us(tv, "qups.das", "qups.das.geometry") == \
        spans.host_us(tv, "qups.das")
    # the three planning spans of a simulation, plus focusTx's inside qups.focus_tx
    assert spec.reader("system.greens_plan_ms")(_run(tv)) == pytest.approx((4 + 2 + 1) * 1e-3 / 2)


def test_device_time_under_a_ranges_device_side():
    tv = _trace()
    assert tv.range_device_us("qups.greens_freq.synth") == 8
    assert spec.reader("greens_freq.synth_ms")(_run(tv)) == pytest.approx(8e-3 / 2)
    assert spec.reader("system.focus_tx_ms")(_run(tv)) == pytest.approx(8e-3 / 2)
    # the spans' device sides are not device records: the busy union holds none
    assert not [n for n, _, _ in tv.device if n.startswith("qups.")]
    assert tv.busy_us == 6 + 2 + 38 + 8 + 8 + 23


def test_launches_are_the_k1_spans_over_the_requests():
    tv = _trace()
    assert spans.count(tv, "qups.das_cuda.k1") == 3
    assert spec.reader("das_cuda.k1_launches")(_run(tv)) == pytest.approx(1.5)
    kernels = [n for n, _, _ in tv.device if "das_kernel" in n]
    assert spec.reader("das_cuda.k1_launches")(_run(tv)) * 2 == len(kernels)


def test_idle_in_the_entry_is_put_down_to_the_span_around_its_midpoint():
    # gaps (midpoint): 0-22 (11, in qups.das.geometry), 28-31 (29.5,
    # qups.das_cuda.operands), 33-42 (37.5, bare qups.das), 80-121 (100.5,
    # qups.greens.problem), 129-131 (130, bare qups.greens), 139-162
    # (150.5, bare qups.das), 185-200 (192.5, outside the entry)
    tv = _trace()
    inside = 22 + 3 + 9 + 41 + 2 + 23
    bare = 9 + 2 + 23
    assert spans.idle_unattributed_pct(tv) == pytest.approx(100 * bare / inside)
    assert spec.reader("device.idle_unattributed_pct")(_run(tv)) == pytest.approx(
        100 * bare / inside)


def test_a_gap_outside_the_entry_counts_nowhere():
    tv = TraceView([_ev("usbench.window", 0, 100), _ev("usbench.entry", 0, 50),
                    _ev("qups.das", 0, 50), _ev("qups.das.geometry", 0, 40),
                    _dev("void das_kernel<0, 1>(QArgs)", 40, 50)])
    assert spans.idle_unattributed_pct(tv) == 0.0  # 0-40 put down, 50-100 outside
    tv = TraceView([_ev("usbench.window", 0, 100), _ev("usbench.request", 0, 100),
                    _ev("qups.das", 0, 50), _dev("void das_kernel<0, 1>(QArgs)", 40, 50)])
    assert spans.idle_unattributed_pct(tv) is None  # no entry range: no idle in it


def test_no_number_where_the_program_has_no_spans():
    # a program without the spans, as the parent of this change: every reader
    # of them returns None and none raises
    tv = TraceView([_ev("usbench.window", 0, 100), _ev("usbench.request", 0, 90),
                    _ev("usbench.entry", 0, 80), _ev("cudaMemcpyAsync", 2, 6),
                    _dev("Memcpy HtoD (Pageable -> Device)", 2, 6),
                    _dev("void das_kernel<0, 1>(QArgs)", 10, 70)])
    for name in NEW:
        assert spec.reader(name)(_run(tv)) is None, name
        assert spec.reader(name)(SimpleNamespace(trace=None, requests=[1])) is None, name
