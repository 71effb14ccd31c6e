"""step.device_ms: the device time of every kernel, copy and set in the
traced stretch (the union of their spans), over the time steps in it.
It reads the same whatever kernels a later change fuses, splits or
renames."""


def read(run):
    t = run.trace
    if t is None or t.steps == 0 or t.busy_s <= 0:
        return None
    return t.busy_s * 1e3 / t.steps
