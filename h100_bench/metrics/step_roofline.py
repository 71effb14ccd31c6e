"""step_roofline: the whole step's share of its roofline, in %: the least
time of one step (workcount.step_bound: the larger of the bytes of the
history, the Dirichlet data, the mass planes and the new field over the
HBM rate, and the configuration's operations over the f32 peak) over
step.device_ms. The count depends on the cell alone, whatever computes
the step."""

import workcount


def read(run):
    t = run.trace
    if t is None or t.steps == 0 or t.busy_s <= 0:
        return None
    least_ms, _ = workcount.step_bound(run.config, run.n_nodes)
    return 100.0 * least_ms / (t.busy_s * 1e3 / t.steps)
