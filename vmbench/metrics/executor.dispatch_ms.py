"""Host ms per wave the packed executor spends assembling and launching
the wave's device work (``wave_times`` ``upload_ms`` + ``launch_ms``),
over the window's untraced waves.  ``merge_ms`` is left out: it also
holds the wait for the device."""


def read(run):
    if not run.waves or "launch_ms" not in run.wave_times:
        return None
    return (run.wave_times["upload_ms"]
            + run.wave_times["launch_ms"]) / run.waves
