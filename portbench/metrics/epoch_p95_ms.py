"""The 95th percentile, over every epoch of the window, of the time from the
epoch's first update call to its computed values on the host."""
import statistics


def read(run):
    if len(run.epoch_ms) < 2:
        return None
    return statistics.quantiles(run.epoch_ms, n=100, method="inclusive")[94]
