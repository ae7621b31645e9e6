"""Requests answered per wave, over the window's untraced waves; waves
are counted through the batcher's ``on_wave_start`` hook."""


def read(run):
    return run.answered / run.waves if run.waves else None
