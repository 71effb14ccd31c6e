"""setup.build_s: the harness's span around the program's build() of the
cell's problem (mesh, operators, constants), in seconds."""


def read(run):
    spans = [t1 - t0 for name, t0, t1 in run.spans if name == "build"]
    return spans[0] if spans else None
