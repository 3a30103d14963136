"""``torch.cuda.max_memory_allocated()`` over the whole run, set-up
included, in GiB: the card a user needs for the case."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30
