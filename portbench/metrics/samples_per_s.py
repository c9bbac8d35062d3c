"""Samples of the evaluation set absorbed per second: every sample of the
window's epochs over the whole window, computes and resets included."""


def read(run):
    return run.samples / run.window_s if run.window_s > 0 else None
