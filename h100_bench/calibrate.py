"""Readings from which the limits of a cell's comparison are set.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1-12 \
        [--control reference_bf16|program_bf16_planes --control-seeds 1-3] \
        [--eager-check]

In one process, at the cell's own size and on its device: the problem is
built once as a run builds it; for each seed the traffic of a run with
that seed is made, and its first ``check_trajectories`` trajectories are
solved by the program (the window's timed path) and by the plain
reference in the configuration's precision, and compared as a run
compares them (``run.compare``, the worst over the trajectories). That is
the lower reading of each number. A control puts something else in the
program's place on the same inputs: ``reference_bf16``, the plain
reference computed in bfloat16 throughout (the precision below f32), or
``program_bf16_planes``, the program with its own lower-precision path
switched on (``tiled_bf16_planes``: the tiled kernel streams its solver
planes in bf16). Its readings are the upper readings. ``--eager-check``
compares the reference replayed from a CUDA graph with the same reference
run op by op, on the first seed's first trajectory (they must agree bit
for bit).

Each reading is one JSON line on standard output.
The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import run  # noqa: E402


def seeds_of(text):
    """'1-12' or '5,7,9' -> [ints]."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def build_problem(cell, device, **over):
    import importlib

    model_name, cls_name, kw = cell.program_config()
    model = importlib.import_module(f"{run.PROGRAM}.models.{model_name}")
    return model.build(getattr(model, cls_name)(**dict(kw, **over)),
                       device=device)


def program_solve(prob, u0):
    import torch

    prob.u0 = u0
    u = prob.solve().u.reshape(-1).clone()
    if u.device.type == "cuda":
        torch.cuda.synchronize(u.device)
    return u


def worst(pairs):
    """The worst of run.compare over (got, reference) pairs."""
    out = {}
    for got, ref in pairs:
        for key, v in run.compare(got, ref).items():
            out[key] = max(out.get(key, v), v)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control", default="",
                   help="reference_bf16, program_bf16_planes or both, "
                        "comma-separated")
    p.add_argument("--control-seeds", default="1-3")
    p.add_argument("--eager-check", action="store_true")
    args = p.parse_args(argv)
    import torch

    from traffic import Traffic

    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    cell = run.Cell(bench, args.workload)
    device = torch.device("cuda")
    dtype = getattr(torch, cell.config["solver"]["dtype"])
    n_traj = cell.traffic["check_trajectories"]

    def emit(rec):
        print(json.dumps(dict(rec, workload=args.workload)), flush=True)

    prob = build_problem(cell, device)
    scheme = cell.reference.scheme(cell.config, cell.traffic, dtype, device)
    emit(dict(kind="setup", program_steps=prob.num_steps,
              reference_steps=scheme.num_steps, program_dt=prob.dt,
              reference_dt=scheme.dt, card=run._card()))
    program_solve(prob, Traffic(cell.traffic, cell.reference, 0, dtype,
                                device).u0(0))            # warm-up
    refs = {}
    for seed in seeds_of(args.seeds):
        gen = Traffic(cell.traffic, cell.reference, seed, dtype, device)
        t0 = time.perf_counter()
        got = [program_solve(prob, gen.u0(k)) for k in range(n_traj)]
        t1 = time.perf_counter()
        refs[seed] = [scheme.trajectory(gen.u0(k)) for k in range(n_traj)]
        torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        emit(dict(kind="program", seed=seed, trajectories=n_traj,
                  program_s=t1 - t0, reference_s=t2 - t1,
                  **worst(zip(got, refs[seed]))))
        if args.eager_check and seed == seeds_of(args.seeds)[0]:
            eager = scheme.trajectory(gen.u0(0), graphed=False)
            emit(dict(kind="eager_check", seed=seed,
                      bit_equal=bool(torch.equal(eager, refs[seed][0])),
                      **run.compare(eager, refs[seed][0])))
    for control in filter(None, args.control.split(",")):
        if control == "program_bf16_planes":
            prob = build_problem(cell, device, tiled_bf16_planes=True)
            solve = lambda u0: program_solve(prob, u0)
        elif control == "reference_bf16":
            low = cell.reference.scheme(cell.config, cell.traffic,
                                        torch.bfloat16, device)
            solve = lambda u0: low.trajectory(u0).to(dtype)
        else:
            raise ValueError(f"unknown control {control!r}")
        for seed in seeds_of(args.control_seeds):
            gen = Traffic(cell.traffic, cell.reference, seed, dtype, device)
            ref = refs.get(seed) or [scheme.trajectory(gen.u0(k))
                                     for k in range(n_traj)]
            got = [solve(gen.u0(k)) for k in range(n_traj)]
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            emit(dict(kind="control", control=control, seed=seed,
                      trajectories=n_traj, finite=finite,
                      **worst(zip(got, ref))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
