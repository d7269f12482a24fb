"""Milliseconds a pair planning the pooled engine on the host (the
program's ``pool_plan`` spans: in ``prepare_target``, or the ctor's own
plan), mean over the untraced pairs."""
from portbench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, {"pool_plan"})
