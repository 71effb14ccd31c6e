"""dof_steps_per_s: nodes x steps of every trajectory the window
completed, over the host-clock time from the window's start to the last
completion (the gaps between solves included)."""


def read(run):
    if not run.solves:
        return None
    work = run.n_nodes * sum(s.steps for s in run.solves)
    return work / (run.solves[-1].done - run.window_start)
