"""Host ms per wave in the packed executor: ``PackedRuntime.dispatch``
and ``fetch`` (the program's ``executor.dispatch`` and ``executor.fetch``
spans) less the fetch's wait for the device (``executor.device_wait``),
over the window's untraced waves.  ``executor.dispatch_ms`` reads a part
of it.  None where the program keeps no such spans."""

SPANS = ("dispatch", "fetch", "device_wait")


def read(run):
    wt = run.wave_times
    keys = [f"span.executor.{s}.ms" for s in SPANS]
    if not run.waves or any(k not in wt for k in keys):
        return None
    dispatch, fetch, wait = (wt[k] for k in keys)
    return (dispatch + fetch - wait) / run.waves
