"""Milliseconds a call on rank 0 in the batch's outer loop over its block
of pairs (the program's ``batch_loop`` span), mean over the untraced
calls; None without the batched path's spans."""
from portbench.drivers import batch


def read(run):
    return batch.span_ms(run, {"batch_loop"})
