"""Outer-loop chunks redone a pair: at a larger pooled budget, or moved to
the grid engine (the program's ``redo`` count), mean over the untraced
pairs."""
from portbench.harness import program_spans


def read(run):
    return program_spans.per_unit(run, "redo")
