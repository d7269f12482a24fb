"""Milliseconds a pair building the target's hash grid on the host (the
program's ``grid_build`` span inside ``prepare_target``), mean over the
untraced pairs."""
from portbench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, {"grid_build"})
