"""The 90th percentile of the seconds of every pair of the window, each
timed on its own."""
import statistics


def read(run):
    times = [u["end"] - u["start"] for u in run.units]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=10)[-1]
