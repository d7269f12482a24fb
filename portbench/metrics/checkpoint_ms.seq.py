"""Milliseconds a pair writing the sequence's checkpoint (the program's
``checkpoint`` spans), mean over the untraced pairs of the window."""
from portbench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, {"checkpoint"})
