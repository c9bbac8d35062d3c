"""Host milliseconds of one ``compute()`` up to its values on the host, the mean
over the profiled epochs."""
import statistics


def read(run):
    t = run.traced
    return statistics.fmean(t.compute_host_ms) if t is not None and t.compute_host_ms else None
