"""Seconds from the process's start to the first timed update: imports, the
kernels' build where a checkout has none, the inputs, the capture and one
warm epoch."""


def read(run):
    return run.setup_s
