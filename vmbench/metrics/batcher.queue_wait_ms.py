"""Mean time a request waits in the batcher's queue, from its arrival
(the end of its ``submit``) to the admission that takes it into a wave
(the program's ``batcher.queue_wait`` total over its count, in
``wave_times``), over the window's untraced waves (host clock, ms a
request).  None where the program keeps no such total."""


def read(run):
    n = run.wave_times.get("span.batcher.queue_wait.n")
    if not n:
        return None
    return run.wave_times["span.batcher.queue_wait.ms"] / n
