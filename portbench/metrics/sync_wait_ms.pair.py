"""Milliseconds a pair in the outer loop's device-to-host reads: the LM
solves' status reads and each chunk's one read of its rows (the program's
``lm_read`` and ``chunk_read`` spans), mean over the untraced pairs."""
from portbench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, {"lm_read", "chunk_read"})
