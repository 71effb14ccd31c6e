"""Run one cell of the benchmark of conservation_fem_tpu_torch once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number that decides ``correct`` with its limit. The same checks are the
last lines of standard error.

Everything that belongs to one cell lives in files found by name from
``BENCHMARK.json``: the configuration (its ``file``), the plain reference
(``reference/<config>.py``), the traffic (``traffic/<traffic>.json``),
the limits of the comparison (``limits/<cell>.json``) and one reader per
metric (``metrics/<metric>.py``, a function ``read(run)`` that returns a
number or None). A cell, a configuration or a metric is added by adding
files and entries; this file does not change.

A run: set-up (import, library load, build() of the cell's problem,
inputs, one warm-up trajectory), then a closed loop with one client for
``--seconds``: trajectories back to back, each a ``problem.solve()`` from
its own initial data and a synchronise. With ``--trace 1`` torch.profiler
records the first trajectories of the window (``trace_seconds`` of the
traffic, at least one trajectory). After the window: the peak device
memory, the import check, the program's state freed, then the plain
reference over a sample of the window's trajectories drawn from the seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import NamedTuple  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the harness's own modules, and the program from the checkout's root
for _path in (ROOT, HERE):
    if _path not in sys.path:
        sys.path.insert(0, _path)

PROGRAM = "conservation_fem_tpu_torch"
# top-level module names no process of the benchmark may hold, compared
# whole: the JAX package is "conservation_fem_tpu", the program
# "conservation_fem_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "conservation_fem_tpu")
SPAN_PREFIX = "bench."
OP_NAME_CHARS = 120     # a device op's name in the breakdown, at most
BREAKDOWN_ENTRIES = 10


def forbidden_modules(names=None):
    """The FORBIDDEN top-level names among ``names`` (default: the modules
    this process holds), each module's name cut at its first dot."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None
                                         else names)}
    return sorted(tops & set(FORBIDDEN))


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


class Cell:
    """One entry of BENCHMARK.json's workloads and every file it names."""

    def __init__(self, bench, name, here=HERE, root=ROOT):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name, self.chips = name, self.entry["chips"]
        cfg = [c for c in bench["configs"]
               if c["name"] == self.entry["config"]][0]
        self.config_name = cfg["name"]
        self.config = load_json(os.path.join(root, cfg["file"]))
        self.traffic = load_json(
            os.path.join(here, "traffic", self.entry["traffic"] + ".json"))
        limits = os.path.join(here, "limits", name + ".json")
        self.limits = load_json(limits) if os.path.exists(limits) else {}
        self.reference = load_module(
            os.path.join(here, "reference", self.config_name + ".py"),
            f"bench_reference_{self.config_name}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
        self.readers = {
            m["name"]: load_module(
                os.path.join(here, "metrics", m["name"] + ".py"),
                "bench_metric_" + m["name"].replace(".", "_"))
            for m in self.end_to_end + self.per_layer}

    def program_config(self):
        """(port model module name, config class name, keyword arguments)
        of the cell's problem."""
        c, t = self.config, self.traffic
        kw = dict(c["solver"], mesh_size=t["mesh"], T=t["T"])
        if "dt_rule" in c:
            kw["dt"] = self.reference.time_step(c, t["mesh"])
        return c["model"], c["config_class"], kw


class Spans:
    """The harness's host spans (name, start, end) on time.perf_counter;
    with ``annotate`` each one is also a torch.profiler annotation named
    SPAN_PREFIX + name."""

    def __init__(self, annotate=False):
        self.spans, self.annotate = [], annotate

    @contextlib.contextmanager
    def __call__(self, name):
        ctx = contextlib.nullcontext()
        if self.annotate:
            import torch

            ctx = torch.profiler.record_function(SPAN_PREFIX + name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans.append((name, t0, time.perf_counter()))


class Solve(NamedTuple):
    index: int        # the trajectory's row of the traffic
    called: float     # perf_counter at the call to solve()
    returned: float   # at its return
    done: float       # after the synchronise that ends it
    steps: int
    traced: bool


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _trace_summary(prof, host_lo, host_hi, steps):
    """The traced stretch's numbers, from the profiler's events."""
    import workcount

    dev = workcount.device_events(prof, SPAN_PREFIX)
    host = workcount.host_events(prof, SPAN_PREFIX)
    busy = workcount.busy_us(dev) / 1e6
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    gaps_by = {}
    if host:
        lo = min(s for s, _, _ in host)
        hi = max(e for _, e, _ in host)
        for a, b in workcount.idle_gaps(dev, lo, hi):
            mid = 0.5 * (a + b)
            inner = [h for h in host if h[0] <= mid <= h[1]]
            label = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                     else SPAN_PREFIX + "loop")
            gaps_by[label] = gaps_by.get(label, 0.0) + (b - a) / 1e6
    gaps = sorted(gaps_by.items(), key=lambda kv: -kv[1])
    return SimpleNamespace(
        steps=steps, window_s=host_hi - host_lo, busy_s=busy,
        device_ops=[[n[:OP_NAME_CHARS], s] for n, s in
                    ops[:BREAKDOWN_ENTRIES]],
        idle_gaps=[[n, s] for n, s in gaps[:BREAKDOWN_ENTRIES]])


def _card():
    """'name, power limit' of the first card, from nvidia-smi (None if it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def compare(u, ref):
    """The numbers that judge one trajectory's final field u against the
    reference's, in f64: ``l2rel``, the relative L2 distance, and
    ``maxrel``, the largest pointwise distance over the reference's
    largest magnitude. A field that is not finite reads inf on both."""
    import torch

    if not bool(torch.isfinite(u).all()):
        return dict(l2rel=float("inf"), maxrel=float("inf"))
    r = ref.double().reshape(-1)
    d = (u.double().reshape(-1) - r).abs()
    return dict(l2rel=float(d.norm() / r.norm()),
                maxrel=float(d.max() / r.abs().max()))


def run_cell(bench, workload, seed, seconds, trace, device="cuda",
             t_start=None, traffic=None, tamper=None, log=None):
    """Run one cell once and return the result's dict (without printing).

    traffic: a dict that replaces the cell's traffic file (tests run the
    harness on the CPU at small sizes); tamper(problem): called after the
    build, before the warm-up (tests break the timed path there)."""
    import torch

    from traffic import WARMUP, Traffic

    t_start = T_START if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = Cell(bench, workload)
    if traffic is not None:
        cell.traffic = traffic
    device = torch.device(device)
    spans = Spans(annotate=bool(trace))
    model_name, cls_name, kw = cell.program_config()
    with spans("import"):
        model = importlib.import_module(f"{PROGRAM}.models.{model_name}")
    if device.type == "cuda":
        with spans("library"):
            from conservation_fem_tpu_torch.ops import _build

            _build.lib()
    with spans("build"):
        prob = model.build(getattr(model, cls_name)(**kw), device=device)
    dtype = getattr(torch, cell.config["solver"]["dtype"])
    with spans("inputs"):
        gen = Traffic(cell.traffic, cell.reference, seed, dtype, device)
        pts = prob.points
        if not (torch.equal(pts[:, 0], gen.x) and torch.equal(pts[:, 1],
                                                               gen.y)):
            raise RuntimeError("the program's nodes are not the harness's "
                               "grid in the same order")
    if tamper is not None:
        tamper(prob)
    with spans("warmup"):
        prob.u0 = gen.u0(WARMUP)
        prob.solve()
        _sync(device)
    setup_s = time.perf_counter() - t_start
    found = forbidden_modules()
    if found:
        return dict(forbidden=found)
    gc.collect()
    gc.freeze()

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    recording = prof is not None
    steps = prob.num_steps
    solves, outs = [], []
    stretch = None

    def stop_recording():
        prof.__exit__(None, None, None)
        return (t0, solves[-1].done, len(solves) * steps)

    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        if recording and solves and (
                time.perf_counter() - t0 >= cell.traffic["trace_seconds"]):
            stretch, recording = stop_recording(), False
        with spans("prep"):
            prob.u0 = gen.u0(k)
        called = time.perf_counter()
        with spans("solve"):
            res = prob.solve()
        returned = time.perf_counter()
        with spans("sync"):
            _sync(device)
        done = time.perf_counter()
        outs.append(res.u.reshape(-1).clone())
        solves.append(Solve(k, called, returned, done, steps, recording))
        k += 1
    _sync(device)
    if recording:               # the whole window was traced
        stretch, recording = stop_recording(), False
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        return dict(forbidden=found)
    trace_info = _trace_summary(prof, *stretch) if prof is not None else None
    prog_steps = prob.num_steps
    del prob, res
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the plain reference over a sample drawn from the seed
    bad = [s.index for s, u in zip(solves, outs)
           if not bool(torch.isfinite(u).all())]
    failed = len(bad)
    scheme = cell.reference.scheme(cell.config, cell.traffic, dtype, device)
    n_check = min(cell.traffic["check_trajectories"], len(solves))
    sample = sorted(random.Random(seed).sample(range(len(solves)), n_check))
    numbers = dict(steps=float(abs(prog_steps - scheme.num_steps)))
    t_ref = time.perf_counter()
    for i in sample:
        got = compare(outs[i], scheme.trajectory(gen.u0(solves[i].index)))
        for key in cell.limits:
            numbers[key] = max(numbers.get(key, 0.0), got[key])
    ref_s = time.perf_counter() - t_ref
    limits = dict(cell.limits, steps=0.0)
    checks = {k: dict(value=v, limit=limits.get(k)) for k, v in
              numbers.items()}
    correct = (failed == 0 and len(solves) > 0
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))

    run = SimpleNamespace(
        config=cell.config, traffic=cell.traffic, n_nodes=gen.n_nodes,
        steps=steps, spans=spans.spans, solves=solves, window_start=t0,
        setup_s=setup_s, trace=trace_info)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=cell.chips, memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=len(solves), failed=failed,
               metrics=metrics, device=dev)
    if trace_info is not None:
        dev["busy_s"] = trace_info.busy_s
        dev["window_s"] = trace_info.window_s
        out["breakdown"] = dict(device_ops=trace_info.device_ops,
                                idle_gaps=trace_info.idle_gaps)
    out["checks"] = checks
    log(f"cell {workload}: seed {seed}, {len(solves)} trajectories of "
        f"{steps} steps on {gen.n_nodes} nodes in {seconds} s; set-up "
        f"{setup_s:.3f} s; reference {ref_s:.3f} s over {n_check}; "
        f"not finite: {bad[:20]}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = Cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    card = _card()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    out = run_cell(bench, args.workload, args.seed, args.seconds, args.trace)
    if "forbidden" in out:
        print(f"modules the benchmark may not load: {out['forbidden']}",
              file=sys.stderr)
        return 4
    out["device"]["card"] = card
    checks = out["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
