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


def _jax_carry(cfg, steps):
    """A JAX mid-trajectory carry after `steps` steps (shock formed)."""
    p = jkpp.build(cfg)
    step = jax.jit(p.step)
    carry = (p.u0,) * 3
    for k in range(steps):
        carry, _ = step(carry, jnp.asarray((k + 1.0) * p.dt))
    return p, step, carry


@pytest.mark.parametrize("name", ["adaptive_mesh4", "bench_fixed_mesh8",
                                  "bench_fixed_kernels_mesh6"])
def test_solve_from_jax_carry_matches_jax(name):
    """Start the port from a JAX state 20 steps in (set_carry) and run 3
    more steps on both sides."""
    p, step, carry = _jax_carry(jkpp.KPPConfig(**CONFIGS[name]), 20)
    u = np.asarray(carry[0])
    assert u.max() - u.min() > 5.0
    q = _port(name, T=0.03)
    q.set_carry(*(np.asarray(c) for c in carry))
    for k in range(3):
        carry, _ = step(carry, jnp.asarray((21.0 + k) * p.dt))
    got = q.solve().u.numpy()
    np.testing.assert_allclose(got, np.asarray(carry[0]), rtol=0, atol=TOL)
    assert np.abs(got - u).max() > 1e-2


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


@pytest.mark.parametrize("over", [
    dict(stabilization="si"), dict(smooth_l=1.0),
    dict(precise_reductions=True), dict(xla_bf16_planes=True),
    dict(tiled_bf16_planes=True), dict(backend="ell")])
def test_unported_options_raise(over):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tkpp.build(tkpp.KPPConfig(mesh_size=2, **over), device="cpu")


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
    neither jax nor the JAX package nor triton, and builds nothing."""
    code = (
        "import sys\n"
        "import conservation_fem_tpu_torch\n"
        "import conservation_fem_tpu_torch.__main__\n"
        "from conservation_fem_tpu_torch.models import kpp\n"
        "from conservation_fem_tpu_torch.ops import _build, fused_step, "
        "stencil_kernels\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'conservation_fem_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert _build._lib is None\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
