"""driver.enqueue_us: the host's time from each solve()'s call to its
return, before the synchronise that ends it, over the time steps, in µs a
step, over the window's solves outside the traced stretch. It is the
host's pace, hidden wherever the card is slower; where a solve enqueues
more launches than the launch queue holds, the host blocks and it reads
the card's pace."""


def read(run):
    solves = [s for s in run.solves if not s.traced] or run.solves
    steps = sum(s.steps for s in solves)
    if not steps:
        return None
    return sum(s.returned - s.called for s in solves) * 1e6 / steps
