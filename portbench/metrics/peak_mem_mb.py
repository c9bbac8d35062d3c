"""``torch.cuda.max_memory_allocated()`` over set-up and window, in MB (10**6
bytes), after ``reset_peak_memory_stats()`` at the run's start."""


def read(run):
    return run.peak_bytes / 1e6 if run.peak_bytes > 0 else None
