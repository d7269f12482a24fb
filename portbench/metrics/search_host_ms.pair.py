"""Milliseconds a pair on the host enqueueing the outer loop's searches
(the program's ``search`` spans, one an outer iteration), mean over the
untraced pairs."""
from portbench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, {"search"})
