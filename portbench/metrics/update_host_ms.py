"""Host milliseconds of one ``update`` call (the collection's fused update and
its graph replay), the mean over the profiled epochs."""
import statistics


def read(run):
    t = run.traced
    return statistics.fmean(t.update_host_ms) if t is not None and t.update_host_ms else None
