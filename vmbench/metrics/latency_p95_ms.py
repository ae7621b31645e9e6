"""95th percentile, over every request answered in the window, of the
time from just before its submit to the return of the wave that
answered it (host clock, ms)."""

import numpy as np


def read(run):
    if not len(run.latencies_s):
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
