"""CUDA graph replays an update: the program's ``graph.replays`` counter over the
profiled epochs, divided by their updates."""


def read(run):
    t = run.traced
    if t is None or t.updates == 0 or run.device_kind == "cpu":
        return None
    return t.replays / t.updates
