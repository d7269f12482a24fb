"""The device's idle share of the traced window, in %: 100 x (1 - the
union of its operations' intervals / the window). Reads every
``device_idle_pct.<traffic>`` metric: each moves its own cells'
end-to-end metric, and the reading is the same."""


def read(run):
    s = run.tracer.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
