"""Pairs a call that the grid engine redid after a pooled budget overflow
(the program's ``redo_pairs`` count on rank 0), mean over the untraced
calls; None without the batched path's spans."""
from portbench.drivers import batch


def read(run):
    return batch.count_per_call(run, "redo_pairs")
