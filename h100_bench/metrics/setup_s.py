"""setup_s: the host-clock time from the start of the run's process
(before its imports) to the start of the window: imports, the library
load (its build in a fresh checkout), build(), the inputs and one warm-up
trajectory."""


def read(run):
    return run.setup_s
