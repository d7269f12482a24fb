"""Milliseconds a pair capturing the LM solve's CUDA graphs (the program's
``LMBlocks.capture_seconds``), mean over the untraced pairs."""


def read(run):
    units = [u for u in run.untraced() if u["ok"]]
    if not units:
        return None
    return 1e3 * sum(u["counters"]["capture_s"] for u in units) / len(units)
