"""Device milliseconds of one update: the kernels, copies and fills launched
inside the profiled ``update`` calls, over their number."""


def read(run):
    t = run.traced
    if t is None or t.trace is None or not t.trace.ops or t.trace.count("update") == 0:
        return None
    us = t.trace.device_us("update")
    return us / t.trace.count("update") / 1e3 if us > 0 else None
