"""Host launch calls (kernel launches and CUDA graph launches) inside the
traced pairs' ``align()`` spans, per outer iteration run."""


def read(run):
    s = run.tracer.summary
    traced = [u for u in run.units if u["traced"] and u["ok"]]
    iterations = sum(u["counters"]["outer_iterations"] for u in traced)
    if s is None or not iterations:
        return None
    return (s.launches_in["align"] + s.graph_launches_in["align"]) / iterations
