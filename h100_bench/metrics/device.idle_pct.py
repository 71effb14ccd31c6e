"""device.idle_pct: the share of the traced stretch's wall time (host
clock, from before its first solve() to the synchronise after its last)
in which no device activity ran, in %: 1 - the union of the device spans
over the wall time (workcount.busy_us, chip_smoke._busy_us)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
