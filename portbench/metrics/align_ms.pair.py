"""Milliseconds a pair in ``align()`` and the synchronize after it: the
harness's span, mean over the untraced pairs."""


def read(run):
    units = [u for u in run.untraced() if u["ok"]]
    if not units:
        return None
    return 1e3 * sum(u["spans"]["align"] for u in units) / len(units)
