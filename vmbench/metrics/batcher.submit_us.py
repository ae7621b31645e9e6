"""Host time of one ``ContinuousBatcher.submit`` (the program's
``batcher.submit`` span: the engine lock, the predicate compile from the
cache, the enqueue), over the window's untraced waves (us a request).
None where the program keeps no such span."""


def read(run):
    n = run.wave_times.get("span.batcher.submit.n")
    if not n:
        return None
    return run.wave_times["span.batcher.submit.ms"] * 1e3 / n
