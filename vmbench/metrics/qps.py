"""Requests answered in the window over the window's host-clock seconds."""


def read(run):
    if run.window_s <= 0 or not len(run.latencies_s):
        return None
    return len(run.latencies_s) / run.window_s
