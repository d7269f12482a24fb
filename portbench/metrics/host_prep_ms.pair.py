"""Milliseconds a pair in ``ProbabilisticRegistration.prepare_target`` (grid
build, pool plan): the harness's span, mean over the untraced pairs."""


def read(run):
    units = [u for u in run.untraced() if "prepare_target" in u["spans"]]
    if not units:
        return None
    return 1e3 * sum(u["spans"]["prepare_target"] for u in units) / len(units)
