"""Seconds from process start to the first timed unit: imports, CUDA
context, kernel load or build, input generation, warm-up."""


def read(run):
    return run.setup_s
