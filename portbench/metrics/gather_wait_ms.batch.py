"""Milliseconds a call on rank 0 from the end of its own loop until the
whole batch's result is back: the all_gather and the overflow read, that
is the wait on the slowest rank (the program's ``batch_gather`` span),
mean over the untraced calls; None without the batched path's spans."""
from portbench.drivers import batch


def read(run):
    return batch.span_ms(run, {"batch_gather"})
