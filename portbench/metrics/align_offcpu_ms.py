"""Milliseconds a pair the thread in ``align()`` is off the CPU: the wall
time of the program's ``align`` spans less the thread's CPU time over
them (blocked on the device, or on the interpreter lock while another
thread runs), mean over the untraced pairs. Reads every
``align_offcpu_ms.<traffic>`` metric."""
from portbench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, {"align"}, part="offcpu")
