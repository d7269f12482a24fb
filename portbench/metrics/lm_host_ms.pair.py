"""Milliseconds a pair on the host in the EM-LM solves less their graph
captures and status reads (the self time of the program's ``lm`` spans),
mean over the untraced pairs."""
from portbench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, {"lm"}, part="self")
