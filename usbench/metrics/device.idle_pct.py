"""device.idle_pct: the share of the traced window in which the card ran
no kernel and no copy (the union of the profiler's device records)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
