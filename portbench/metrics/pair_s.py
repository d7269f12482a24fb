"""Seconds a pair: the window's wall time over the pairs completed in it
(closed loop, one client; each pair ends in a synchronize)."""


def read(run):
    units = run.units
    if not units:
        return None
    return (units[-1]["end"] - units[0]["start"]) / len(units)
