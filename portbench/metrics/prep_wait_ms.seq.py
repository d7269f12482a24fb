"""Milliseconds the main thread waits a pair for the prep thread's target
(``OdometryResult.prep_wait_seconds``), mean over the pairs of the
``run_odometry`` calls the window completed."""


def read(run):
    waits = [w for c in run.extras.get("calls", []) for w in c["prep_wait_seconds"]]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
