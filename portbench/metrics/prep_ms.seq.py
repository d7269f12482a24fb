"""Milliseconds a pair on the prep thread preparing a target (the
program's ``prep`` spans), mean over the untraced pairs of the window."""
from portbench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, {"prep"})
