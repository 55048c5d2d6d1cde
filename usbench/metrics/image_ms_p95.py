"""image_ms_p95: the 95th percentile over all requests of the window of
the time from the entry call to the image on the host, host clock."""
import numpy as np


def read(run):
    return float(np.percentile([r.latency_s for r in run.requests], 95)) * 1e3
