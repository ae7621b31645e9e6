"""``torch.cuda.max_memory_allocated()`` from the start of the index
build to the close of the window, in GiB."""


def read(run):
    return run.peak_bytes / float(1 << 30) if run.peak_bytes else None
