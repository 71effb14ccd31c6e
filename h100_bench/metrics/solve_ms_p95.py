"""solve_ms_p95: the 95th percentile over every trajectory of the window
of the host-clock time from the call to solve() to the synchronise that
ends it, in ms: the time to a solution a user waits for."""

import statistics


def read(run):
    ms = [(s.done - s.called) * 1e3 for s in run.solves]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
