"""Share of the traced window in which no operation ran on the device:
1 - the union of the profiler's device intervals over the window."""


def read(run):
    prof = run.profile
    if prof is None or prof.busy_s is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
