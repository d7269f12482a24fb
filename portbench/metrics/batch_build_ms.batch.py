"""Milliseconds a call on rank 0 building the batch's inputs: padding and
uploads, the pool prepacks, their stacking, the demand estimate and this
rank's block (the program's ``batch_build`` spans), mean over the
untraced calls; None without the batched path's spans."""
from portbench.drivers import batch


def read(run):
    return batch.span_ms(run, {"batch_build"})
