"""The share of the profiled part's wall time, from its first call's start to
its last call's end, in which no kernel, copy or fill runs on the device."""


def read(run):
    t = run.traced
    if t is None or t.trace is None or not t.trace.ops or not t.trace.ranges:
        return None
    lo, hi = t.trace.window_us
    return 100.0 * (1.0 - t.trace.busy_us() / (hi - lo))
