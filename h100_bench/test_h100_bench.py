"""CPU tests of the benchmark harness (``python -m pytest
h100_bench/test_h100_bench.py`` from the repository root). The harness
runs here on the port's plain paths at small grids; tests that need the
card carry the ``cuda`` marker and skip without one."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import run  # noqa: E402
import workcount  # noqa: E402
from traffic import Traffic  # noqa: E402

BENCH = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# small grids at which the harness runs on the CPU: (mesh, T)
SMALL = {"kpp_rv_f32": (4, 0.05), "burgers_rv_f32": (8, 0.1)}
KPP, BURGERS = "kpp_mesh512", "burgers_mesh200"   # cells run small here
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "flax", "conservation_fem_tpu",
                     "conservation_fem_tpu_torch")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_traffic(cell_name, **over):
    cell = run.Cell(BENCH, cell_name)
    mesh, T = SMALL[cell.config_name]
    return dict(cell.traffic, mesh=mesh, T=T, check_trajectories=2,
                trace_seconds=0.2, **over)


def run_small(cell_name, seed=2**31 + 7, trace=0, tamper=None, seconds=0.5):
    import time

    return run.run_cell(BENCH, cell_name, seed, seconds, trace, device="cpu",
                        t_start=time.perf_counter(),
                        traffic=small_traffic(cell_name), tamper=tamper,
                        log=lambda msg: None)


# -- the file and its names -------------------------------------------------


def test_names_units_and_shape_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert BENCH["paths"] == ["h100_bench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100_bench/")
        assert c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    e2e = BENCH["end_to_end"]
    assert "setup_s" in [m["name"] for m in e2e]
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in [e["name"] for e in e2e]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in e2e + BENCH["per_layer"]:
        assert UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200
        assert "\n" not in entry["why"] and "\t" not in entry["why"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for name in CELLS:
        cell = run.Cell(BENCH, name)
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert cell.limits, f"{name}: no limits/{name}.json"


# -- files found by name ------------------------------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_harness_finds_each_cell_by_name(name):
    cell = run.Cell(BENCH, name)
    assert cell.config["model"] in ("kpp", "burgers")
    assert {"mesh", "T", "perturbation", "check_trajectories",
            "trace_seconds"} <= set(cell.traffic)
    assert callable(cell.reference.scheme)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.readers[m["name"]].read)


def test_a_stray_added_cell_and_metric_are_found_without_an_edit(tmp_path):
    shutil.copytree(HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "h100_bench"
    (here / "traffic" / "mesh8_T0.02.json").write_text(json.dumps(
        dict(run.load_json(here / "traffic" / "mesh512_T0.1.json"), mesh=8,
             T=0.02)))
    (here / "metrics" / "extra.count.py").write_text(
        "def read(run):\n    return float(len(run.solves))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name="kpp_mesh8", config="kpp_rv_f32",
                                   traffic="mesh8_T0.02", chips=1, why="x"))
    bench["per_layer"].append(dict(
        name="extra.count", unit="1", better="higher", source="host_clock",
        layer="harness", moves="dof_steps_per_s", workloads=["kpp_mesh8"]))
    cell = run.Cell(bench, "kpp_mesh8", here=str(here), root=str(tmp_path))
    assert cell.traffic["mesh"] == 8
    assert [m["name"] for m in cell.per_layer] == ["extra.count"]
    assert cell.readers["extra.count"].read(
        type("R", (), {"solves": [1, 2]})) == 2.0


# -- the frozen arithmetic ----------------------------------------------------


@pytest.mark.parametrize("name, mesh, printed", [
    ("kpp_mesh512", 64, "0.00198"), ("kpp_mesh512", 512, "0.12558"),
    ("burgers_mesh200", 200, "0.00145"), ("burgers_mesh800", 800, "0.02309")])
def test_step_bounds_reproduce_the_printed_ones(name, mesh, printed):
    """PERF.md's table of kernels: the bound of one step, by operations."""
    cell = run.Cell(BENCH, name)
    x, y = cell.reference.axes(mesh)
    ms, by = workcount.step_bound(cell.config, len(x) * len(y))
    assert by == "operations"
    assert f"{ms:.5f}" == printed


def test_busy_union_and_idle_gaps_on_hand_made_spans():
    spans = [(0.0, 2.0, "a"), (1.0, 3.0, "b"), (5.0, 6.0, "c"),
             (5.5, 5.7, "d"), (9.0, 9.5, "e")]
    assert workcount.busy_us(spans) == pytest.approx(3.0 + 1.0 + 0.5)
    assert workcount.idle_gaps(spans, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0),
                                                     (9.5, 10.0)]
    assert workcount.idle_gaps(spans, -1.0, 2.5) == [(-1.0, 0.0)]
    assert workcount.busy_us([]) == 0.0


# -- the reference against the port -------------------------------------------


@pytest.mark.parametrize("name", [KPP, BURGERS])
def test_reference_matches_the_port_on_the_cpu(name):
    """KPP at mesh 4 and Burgers at mesh 8: the port's timed path (its plain
    versions here) and the plain reference agree to f32 rounding, with the
    same dt and steps."""
    import calibrate

    cell = run.Cell(BENCH, name)
    cell.traffic = small_traffic(name)
    dtype = torch.float32
    prob = calibrate.build_problem(cell, "cpu")
    scheme = cell.reference.scheme(cell.config, cell.traffic, dtype, "cpu")
    assert (prob.num_steps, prob.dt) == (scheme.num_steps, scheme.dt)
    gen = Traffic(cell.traffic, cell.reference, 11, dtype, "cpu")
    for k in range(2):
        got = calibrate.program_solve(prob, gen.u0(k))
        d = run.compare(got, scheme.trajectory(gen.u0(k)))
        assert d["l2rel"] < 1e-6 and d["maxrel"] < 1e-5


def test_traffic_is_fixed_by_the_seed_and_vanishes_on_the_frame():
    cell = run.Cell(BENCH, "burgers_mesh200")
    tr = small_traffic("burgers_mesh200")
    a = Traffic(tr, cell.reference, 2**31 + 5, torch.float32, "cpu")
    b = Traffic(tr, cell.reference, 2**31 + 5, torch.float32, "cpu")
    c = Traffic(tr, cell.reference, 2**31 + 6, torch.float32, "cpu")
    assert torch.equal(a.u0(3), b.u0(3))
    assert not torch.equal(a.u0(3), c.u0(3))
    assert not torch.equal(a.u0(3), a.u0(4))
    n1 = tr["mesh"] + 1
    d = (a.u0(3) - a.base).reshape(n1, n1)
    assert d.abs().max() > 0
    for edge in (d[0], d[-1], d[:, 0], d[:, -1]):
        assert edge.abs().max() == 0


# -- a run's last line --------------------------------------------------------


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_shape(trace):
    out = run_small(BURGERS, trace=trace, seconds=2.0)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = run.Cell(BENCH, BURGERS)
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    for name, m in out["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    if trace:
        assert {"window_s", "busy_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == set(units)
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                        "--workload", KPP, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                        KPP, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


# -- what may be imported -----------------------------------------------------


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(
        ["jax.numpy", "conservation_fem_tpu.ops.mesh", "numpy",
         "conservation_fem_tpu_torch.models.kpp", "jaxlib", "flax.linen",
         "jaxtyping", "conservation_fem_tpu_torchx"]) == [
        "conservation_fem_tpu", "flax", "jax", "jaxlib"]
    assert run.forbidden_modules(["conservation_fem_tpu_torch"]) == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_yardstick_imports_nothing_of_the_program_or_jax():
    files = ["workcount.py", "traffic.py"] + [
        os.path.join(d, f) for d in ("reference", "metrics")
        for f in os.listdir(os.path.join(HERE, d)) if f.endswith(".py")]
    for f in files:
        for name in _imports(os.path.join(HERE, f)):
            assert name.split(".")[0] not in FORBIDDEN_IMPORTS, (f, name)


def test_a_run_holds_no_jax_and_the_reference_no_program():
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {HERE!r})\n"
        "from reference import kpp_rv_f32, burgers_rv_f32, p1_structured\n"
        "import workcount, traffic\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert not tops & {'conservation_fem_tpu_torch', "
        "'conservation_fem_tpu', 'jax'}, tops\n"
        "import run\n"
        "b = run.load_json(run.os.path.join(run.ROOT, 'BENCHMARK.json'))\n"
        "tr = dict(run.Cell(b, 'kpp_mesh512').traffic, mesh=4, T=0.03,\n"
        "          check_trajectories=1)\n"
        "out = run.run_cell(b, 'kpp_mesh512', 3, 0.2, 0, device='cpu',\n"
        "                   t_start=time.perf_counter(), traffic=tr)\n"
        "assert 'forbidden' not in out and out['attempted'] > 0\n"
        "assert 'conservation_fem_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


# -- the control and the faults must come out as not correct ------------------


def _replace_solve(prob, fn):
    """Make prob.solve() return fn(prob) as its final field."""
    from types import SimpleNamespace

    prob.solve = lambda **kw: SimpleNamespace(u=fn(prob))


# where the control is run here: (mesh, T) a test can hold, at which the
# control reads above the cell's limits (Burgers: 7.9e-3-8.3e-3 l2rel at
# mesh 32 against the limit 6e-3; at mesh 8 it reads below)
CONTROL_SIZE = {KPP: (4, 0.05), BURGERS: (32, 0.5)}


@pytest.mark.parametrize("name", [KPP, BURGERS])
def test_the_control_comes_out_not_correct(name):
    """The plain reference computed in bfloat16, in the program's place."""
    import time

    cell = run.Cell(BENCH, name)
    mesh, T = CONTROL_SIZE[name]
    tr = dict(small_traffic(name), mesh=mesh, T=T)
    low = cell.reference.scheme(cell.config, tr, torch.bfloat16, "cpu")
    tamper = lambda p: _replace_solve(
        p, lambda q: low.trajectory(q.u0).to(torch.float32))
    out = run.run_cell(BENCH, name, 2**31 + 7, 0.5, 0, device="cpu",
                       t_start=time.perf_counter(), traffic=tr,
                       tamper=tamper, log=lambda msg: None)
    assert out["correct"] is False
    assert max(c["value"] / c["limit"] for c in out["checks"].values()
               if c["limit"]) > 1.0


def _unchanged_step(prob):
    prob.step = lambda carry, t, g=None: (carry, None)


def _half_grid_step(prob):
    """Each step leaves the upper half of the rows at their old values."""
    step = prob.step
    n1x, n1y = prob._shape2

    def half(carry, t, g=None):
        new, m = step(carry, t, g)
        u = new[0].reshape(n1x, n1y).clone()
        u[n1x // 2:] = carry[0].reshape(n1x, n1y)[n1x // 2:]
        return (u.reshape(-1),) + tuple(new[1:]), m
    prob.step = half


def _altered_answer(prob):
    """Each solve's answer off by 1 % where it is produced."""
    solve = prob.solve

    def altered(**kw):
        res = solve(**kw)
        return res._replace(u=res.u * 1.01)
    prob.solve = altered


@pytest.mark.parametrize("fault", [_unchanged_step, _half_grid_step,
                                   _altered_answer])
@pytest.mark.parametrize("name", [KPP, BURGERS])
def test_a_broken_timed_path_comes_out_not_correct(name, fault):
    assert run_small(name)["correct"] is True
    assert run_small(name, tamper=fault)["correct"] is False


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_graphed_reference_equals_eager_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = run.Cell(BENCH, "burgers_mesh200")
    tr = small_traffic("burgers_mesh200", mesh=64)
    scheme = cell.reference.scheme(cell.config, tr, torch.float32, "cuda")
    gen = Traffic(tr, cell.reference, 5, torch.float32, "cuda")
    assert torch.equal(scheme.trajectory(gen.u0(0), graphed=True),
                       scheme.trajectory(gen.u0(0), graphed=False))
