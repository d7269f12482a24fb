"""Registered pairs over the window's wall time: from the window's first
unit's start to the completion of its last unit (reads, prep and
checkpoints included)."""


def read(run):
    units = run.units
    if not units or units[-1]["end"] <= units[0]["start"]:
        return None
    return sum(u["pairs"] for u in units) / (units[-1]["end"] - units[0]["start"])
