"""Milliseconds a call on rank 0 in the batch's host planning: the
targets' hash grids and the group pool plan (the program's ``batch_grid``
and ``batch_plan`` spans, a redo's grids too), mean over the untraced
calls; None without the batched path's spans."""
from portbench.drivers import batch


def read(run):
    return batch.span_ms(run, {"batch_grid", "batch_plan"})
