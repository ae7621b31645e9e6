"""Host ms per wave that ``PackedRuntime.fetch`` waits for the wave's
device work and copies (the program's ``executor.device_wait`` span),
over the window's untraced waves.  None where the program keeps no such
span."""


def read(run):
    key = "span.executor.device_wait.ms"
    if not run.waves or key not in run.wave_times:
        return None
    return run.wave_times[key] / run.waves
