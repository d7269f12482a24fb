"""The select kernels' (B4 ``select_bitonic``, B1 ``select_windows``) share
of their roofline, in %: the search's least time over the traced pairs'
outer iterations (``portbench/roofline.py``, counted from the inputs) over
the profiler's device time of those kernels."""

NAMES = ("select_bitonic", "select_windows")


def read(run):
    s = run.tracer.summary
    least = run.extras.get("select_least_s")
    if s is None or least is None:
        return None
    kernel_s = sum(v for name, v in s.by_name.items() if any(n in name for n in NAMES))
    if kernel_s <= 0:
        return None
    return 100.0 * least / kernel_s
