"""Milliseconds a pair in the ctor's pool build (the program's
``pool_build`` span: the build, or the wait on a staged one, and the
row-demand estimate), mean over the untraced pairs."""
from portbench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, {"pool_build"})
