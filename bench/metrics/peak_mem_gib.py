"""``torch.cuda.max_memory_allocated`` over the program's set-up and the
window, in GiB (the benchmark's own graph generation before it is not
counted)."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None
