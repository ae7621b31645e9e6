"""Process start to the opening of the window: imports, inputs, build,
upload, kernel build or load, warm-up waves (host clock, s)."""


def read(run):
    return run.setup_s
