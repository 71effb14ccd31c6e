"""The slice as a whole: the port's KPP-RV solve against the JAX package
(f64, mesh 4-8, a few steps; from u0 and from a JAX mid-trajectory carry),
the f32 bench configuration against the committed f64 anchor, the CLI,
the unported options, and the import boundary."""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu_torch import __main__ as tmain
from conservation_fem_tpu_torch.models import kpp as tkpp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f64 trajectories of a few steps: both packages run the same algorithm,
# summing in other orders; 1e-11 is the JAX package's own bound for its
# fused-vs-XLA trajectory identity
TOL = 1e-11
BENCH = dict(cg_iters=6, newton_iters=2, newton_linear_iters=4,
             modified_newton=True, newton_final_residual=False)

CONFIGS = {
    "adaptive_mesh4": dict(mesh_size=4),
    "adaptive_kernels_mesh4": dict(mesh_size=4),
    "bench_fixed_mesh8": dict(mesh_size=8, **BENCH),
    "bench_fixed_kernels_mesh6": dict(mesh_size=6, **BENCH),
    "cheby_fixed_mesh4": dict(mesh_size=4, cg_iters=10, newton_iters=2,
                              newton_linear_iters=16, modified_newton=True,
                              inner_solver="cheby"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these grids are small, and the test run shares
    the cores among several pytest worker processes, where torch's thread
    pool only oversubscribes them (the mesh-32 run took ~80x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name, **over):
    kernels = "kernels" in name
    cfg = tkpp.KPPConfig(**{**CONFIGS[name], **over}, use_kernels=kernels)
    return tkpp.build(cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_solve(items):
    return np.asarray(jkpp.build(jkpp.KPPConfig(**dict(items), T=0.03))
                      .solve().u)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_solve_from_u0_matches_jax(name):
    """3 steps from the initial condition (the kernels variants run the
    wrappers, which take the plain versions on CPU tensors)."""
    ref = _jax_solve(tuple(sorted(CONFIGS[name].items())))
    got = _port(name, T=0.03).solve().u.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@functools.lru_cache(maxsize=None)
def _jax_carries(name, steps):
    """(problem, its jitted step, the JAX carries after 0 .. `steps` steps
    of CONFIGS[name], T = 1: the shock forms)."""
    p = jkpp.build(jkpp.KPPConfig(**CONFIGS[name]))
    step = jax.jit(p.step)
    carries = [(p.u0,) * 3]
    for k in range(steps):
        carries.append(step(carries[-1], jnp.asarray((k + 1.0) * p.dt))[0])
    return p, step, carries


@pytest.mark.parametrize("name", ["adaptive_mesh4", "bench_fixed_mesh8",
                                  "bench_fixed_kernels_mesh6"])
def test_solve_from_jax_carry_matches_jax(name):
    """Start the port from a JAX state 20 steps in (set_carry) and run 3
    more steps on both sides."""
    p, step, carries = _jax_carries(name, 20)
    carry = carries[20]
    u = np.asarray(carry[0])
    assert u.max() - u.min() > 5.0
    q = _port(name, T=0.03)
    q.set_carry(*(np.asarray(c) for c in carry))
    for k in range(3):
        carry, _ = step(carry, jnp.asarray((21.0 + k) * p.dt))
    got = q.solve().u.numpy()
    np.testing.assert_allclose(got, np.asarray(carry[0]), rtol=0, atol=TOL)
    assert np.abs(got - u).max() > 1e-2


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX checkpointed run (every 3 steps) stopped after 6 steps writes
    an .npz; the port resumes from it (4 steps, T = 0.1) and ends within
    1e-12 of JAX's uninterrupted trajectory after 10 steps."""
    from conservation_fem_tpu_torch.utils.checkpoint import load_checkpoint

    p, _, carries = _jax_carries("adaptive_mesh4", 20)
    path = str(tmp_path / "kpp.npz")
    n = p.num_steps
    p.num_steps = 6
    try:
        p.solve(checkpoint_path=path, checkpoint_every=3)
    finally:
        p.num_steps = n
    assert load_checkpoint(path).step == 6
    q = _port("adaptive_mesh4", T=0.1)
    steps = []
    step = q.step
    q.step = lambda *a: steps.append(1) or step(*a)
    u = q.solve(checkpoint_path=path, checkpoint_every=3, resume=True).u
    assert len(steps) == 4
    np.testing.assert_allclose(u.numpy(), np.asarray(carries[10][0]), rtol=0,
                               atol=1e-12)


def test_structured_data_from_jax_drives_the_port():
    """The JAX StructuredData fields, carried over with
    structured_data_from_numpy, give the same step as the port's own."""
    from conservation_fem_tpu_torch.ops.structured import (
        structured_data_from_numpy)

    pj = jkpp.build(jkpp.KPPConfig(mesh_size=4, **BENCH))
    fields = {k: (v if isinstance(v, int) else np.asarray(v))
              for k, v in pj.sd._asdict().items()}
    q = _port("bench_fixed_mesh8", mesh_size=4, T=0.01)
    ref = q.solve().u
    q.sd = structured_data_from_numpy(fields, "cpu", torch.float64)
    torch.testing.assert_close(q.solve().u, ref, rtol=0, atol=1e-14)


def test_f32_bench_config_meets_the_anchor_gate():
    """bench.py:_config at mesh 32 in f32, T = 1.0 (100 steps), through
    the kernel wrappers (plain versions on CPU): L2rel <= 1e-2 against the
    committed f64 anchor, the bench's own gate."""
    p = tkpp.build(tkpp.KPPConfig(mesh_size=32, dtype="float32", dt=0.01,
                                  use_kernels=True, **BENCH), device="cpu")
    assert p._fused_mode() == "single" and p.num_steps == 100
    u = p.solve().u.double().numpy()
    ref = np.load(os.path.join(REPO, "golden",
                               "kpp_rv_anchor_mesh32.npy")).astype(np.float64)
    assert np.isfinite(u).all() and 0.5 <= u.min() and u.max() <= 12.0
    rel = np.linalg.norm(u - ref) / np.linalg.norm(ref)
    assert rel <= 1e-2, rel


def test_multistep_solve_matches_step_by_step():
    """fused_substeps: K steps per wrapper call (10 = 2 x 4 + 2) gives
    the same trajectory as one call per step (same plain code, exact)."""
    p = _port("bench_fixed_kernels_mesh6", T=0.1)
    ref = p.solve().u
    p.cfg = dataclasses.replace(p.cfg, fused_substeps=4)
    assert p._fused_multistep_ok()
    torch.testing.assert_close(p.solve().u, ref, rtol=0, atol=0)


def test_record_metrics_and_cli(capsys):
    """record_metrics stacks one entry per step; the CLI prints one JSON
    line for the kpp subcommand."""
    p = tkpp.build(tkpp.KPPConfig(mesh_size=2, T=0.03, record_metrics=True),
                   device="cpu")
    res = p.solve()
    assert res.metrics["newton_converged"].shape == (3,)
    assert bool(res.metrics["newton_converged"].all())
    assert tmain.main(["kpp", "--mesh_size", "2", "--T", "0.02",
                       "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["num_steps"] == 2 and out["newton_all_converged"]
    assert out["device"] == "cpu"


def test_cli_runs_si_and_the_ell_backend(capsys):
    """--stabilization si on the stencil backend, and --backend ell (the
    ELL step on the structured mesh), each one JSON line equal to the same
    build called directly."""
    assert tmain.main(["kpp", "--stabilization", "si", "--Cm", "0.5",
                       "--mesh_size", "2", "--T", "0.02", "--device",
                       "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["stabilization"], out["backend"]) == ("si", "stencil")
    assert tmain.main(["kpp", "--backend", "ell", "--mesh_size", "2",
                       "--T", "0.04", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["backend"] == "ell" and out["n_nodes"] == 81
    p = tkpp.build(tkpp.KPPConfig(mesh_size=2, T=0.04, backend="ell"),
                   device="cpu")
    assert not hasattr(p, "sd")
    u = p.solve().u
    assert out["u_min"] == float(u.min()) and out["u_max"] == float(u.max())


@pytest.mark.parametrize("over,item", [
    (dict(xla_bf16_planes=True), "queue 2 item 5c"),
    (dict(tiled_bf16_planes=True), "queue 2 item 5c"),
    (dict(backend="ell", ell_matvec_backend="banded"), "queue 1 item 13")])
def test_unported_options_raise(over, item):
    """Options the port once refused, each ported since under the ROADMAP
    item named: they build and step a finite solution (f32, where the bf16
    planes take effect). The banded backend's run against the gather
    backend: tests/test_torch_blocked_model.py; the bf16 planes against
    the JAX package: tests/test_torch_bf16_planes.py."""
    p = tkpp.build(tkpp.KPPConfig(mesh_size=2, T=0.02, dtype="float32",
                                  **over), device="cpu")
    assert bool(torch.isfinite(p.solve().u).all())


@pytest.mark.parametrize("over", [
    dict(stabilization="si"), dict(smooth_l=1.0),
    dict(precise_reductions=True), dict(backend="ell")])
def test_ported_options_build_step_and_match_jax(over):
    """SI, the smoothing, precise_reductions (f64: the same solve) and the
    ELL backend: 3 steps at mesh 2 against the JAX package."""
    cfg = dict(mesh_size=2, T=0.03, **over)
    ref = np.asarray(jkpp.build(jkpp.KPPConfig(**cfg)).solve().u)
    p = tkpp.build(tkpp.KPPConfig(**cfg), device="cpu")
    assert hasattr(p, "sd") == (over.get("backend") != "ell")
    got = p.solve().u.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert np.abs(got - p.u0.numpy()).max() > 0.5


def test_mesh_source_and_host_mesh_take_the_ell_backend():
    """mesh_source (a DOLFINx .h5 mesh) and host_mesh run the ELL backend
    under backend="auto", as in the JAX package; the stencil backend
    refuses them."""
    pytest.importorskip("h5py")
    from conservation_fem_tpu_torch.ops import mesh as tmesh

    path = os.path.join(REPO, "golden", "kpp_rv8.h5")
    cfg = dict(mesh_source=path, T=0.02)
    ref = np.asarray(jkpp.build(jkpp.KPPConfig(**cfg)).solve().u)
    p = tkpp.build(tkpp.KPPConfig(**cfg), device="cpu")
    assert not hasattr(p, "sd") and p.num_steps == 2
    np.testing.assert_allclose(p.solve().u.numpy(), ref, rtol=0, atol=TOL)
    host = tmesh.rectangle_mesh((-2, -2), (2, 2), nx=8, ny=8)
    assert not hasattr(tkpp.build(tkpp.KPPConfig(T=0.01), device="cpu",
                                  host_mesh=host), "sd")
    with pytest.raises(ValueError, match="structured mesh only"):
        tkpp.build(tkpp.KPPConfig(backend="stencil", T=0.01), device="cpu",
                   host_mesh=host)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkpp.build(tkpp.KPPConfig(mesh_size=2), device="cuda")


def test_build_targets_the_card_by_default():
    """No device given means the card: without one, build raises rather
    than falling back to the CPU; so does the CLI without --device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkpp.build(tkpp.KPPConfig(mesh_size=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["kpp", "--mesh_size", "2", "--T", "0.02"])


def test_package_imports_without_jax():
    """In a fresh interpreter, importing every module of the port pulls in
    neither jax nor the JAX package nor triton nor h5py (nor matplotlib
    nor PIL: the utilities and the example scripts import with the three
    blocked), and builds
    nothing."""
    code = (
        "import sys\n"
        "for name in ('h5py', 'matplotlib', 'PIL'):\n"
        "    sys.modules[name] = None\n"
        "import conservation_fem_tpu_torch\n"
        "import conservation_fem_tpu_torch.__main__\n"
        "import conservation_fem_tpu_torch.utils\n"
        "from conservation_fem_tpu_torch.models import kpp\n"
        "from conservation_fem_tpu_torch.ops import _build, fused_step, "
        "stencil_kernels\n"
        "from conservation_fem_tpu_torch.models import burgers\n"
        "from conservation_fem_tpu_torch.ops import assembly, bc, dg, "
        "helpers, mesh, precision, spmv, stabilization\n"
        "from conservation_fem_tpu_torch import native_ext, parallel\n"
        "from conservation_fem_tpu_torch.parallel import "
        "blocked_advection_sharded, blocked_pk_sharded, blocked_sharded, "
        "stokes_sharded\n"
        "from conservation_fem_tpu_torch.utils import baseline_proxy, "
        "checkpoint, guards, interpolate, io, metrics, plotting, "
        "streaming, sweeps\n"
        "from conservation_fem_tpu_torch.examples import make_figures, "
        "tutorial\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and "
        "m.split('.')[0] in ('jax', 'jaxlib', 'conservation_fem_tpu', "
        "'triton', 'h5py', 'matplotlib', 'PIL')]\n"
        "assert not bad, bad\n"
        "assert _build._lib is None and native_ext._lib is None\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
