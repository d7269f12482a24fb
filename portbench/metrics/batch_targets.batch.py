"""Distinct targets a call whose pool plan rank 0 made (the program's
``batch_targets`` count on rank 0): its own block's on a mesh, the whole
batch's where every rank plans every pair; mean over the untraced calls;
None without the batched path's spans."""
from portbench.drivers import batch


def read(run):
    return batch.count_per_call(run, "batch_targets")
