"""The port's ELL step (models/scalar_hyperbolic.HyperbolicProblem.step)
against the JAX package's: KPP RV, SI and GFEM on irregular_mesh(nx=8,
seed=1), adaptive and fixed-iteration solvers, 3 steps in f64 within
1e-11; from a JAX mid-trajectory carry; precise_reductions in f32 (2
steps, L2rel <= 1e-5 against the JAX run); the f64-accumulated dot; and
the per-step metrics."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.ops import precision as jprec
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import precision as tprec

# f64, a few steps, the same algorithm summed in other orders: the JAX
# package's own bound for its backend-identity trajectories
TOL = 1e-11
FIXED = dict(modified_newton=True, cg_iters=10, newton_iters=3,
             newton_linear_iters=8)
STEPS = dict(dt=0.02, T=0.06)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run shares the cores among several
    pytest worker processes, where torch's thread pool only
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _meshes():
    return (jmesh.irregular_mesh((-2, -2), (2, 2), nx=8, seed=1),
            tmesh.irregular_mesh((-2, -2), (2, 2), nx=8, seed=1))


def _pair(**over):
    jm, tm = _meshes()
    cfg = dict(backend="ell", **{**STEPS, **over})
    return (jkpp.build(jkpp.KPPConfig(**cfg), host_mesh=jm),
            tkpp.build(tkpp.KPPConfig(**cfg), device="cpu", host_mesh=tm))


@pytest.mark.parametrize("solvers", ["adaptive", "fixed"])
@pytest.mark.parametrize("stabilization", ["rv", "si", "gfem"])
def test_kpp_ell_step_matches_jax(stabilization, solvers):
    pj, pt = _pair(stabilization=stabilization,
                   **(FIXED if solvers == "fixed" else {}))
    assert type(pt).__name__ == "HyperbolicProblem"
    ref = np.asarray(pj.solve().u)
    got = pt.solve().u.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    # the solve moved the state
    assert np.abs(got - pt.u0.numpy()).max() > 0.5


def test_kpp_ell_from_jax_carry():
    """set_carry from a JAX state 3 steps in; 2 more steps on both
    sides."""
    pj, pt = _pair(stabilization="rv", dt=0.02, T=0.1)
    step = jax.jit(pj.step)
    carry = (pj.u0,) * 3
    for k in range(3):
        carry, _ = step(carry, jnp.asarray((k + 1.0) * pj.dt))
    pt.set_carry(*(np.asarray(c) for c in carry), start_step=3)
    for k in range(3, 5):
        carry, _ = step(carry, jnp.asarray((k + 1.0) * pj.dt))
    np.testing.assert_allclose(pt.solve().u.numpy(), np.asarray(carry[0]),
                               rtol=0, atol=TOL)


def test_precise_reductions_f32_matches_jax():
    """The f32 fixed config with f64-accumulated dots, 2 steps: L2rel <=
    1e-5 against the JAX package's run of the same config (f32 roundoff
    in other orders, not yet grown by the shock)."""
    pj, pt = _pair(dtype="float32", precise_reductions=True, dt=0.02,
                   T=0.04, **FIXED)
    ref = np.asarray(pj.solve().u, np.float64)
    got = pt.solve().u.double().numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= 1e-5, rel
    assert pt._dot is tprec.dot_acc64


def test_dot_acc64_is_the_f64_dot_cast_down():
    rng = np.random.default_rng(3)
    a32, b32 = (torch.tensor(rng.normal(size=1000), dtype=torch.float32)
                for _ in range(2))
    got = tprec.dot_acc64(a32, b32)
    assert got.dtype == torch.float32
    assert got == torch.sum(a32.double() * b32.double()).float()
    assert tprec.sum_acc64(a32) == torch.sum(a32.double()).float()
    ref = jprec.dot_acc64(jnp.asarray(a32.numpy()), jnp.asarray(b32.numpy()))
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    a64 = a32.double()
    assert tprec.dot_acc64(a64, a64) == torch.sum(a64 * a64)


def test_record_metrics_and_dirichlet_rows():
    """record_metrics stacks the JAX package's keys per step; the
    Dirichlet rows hold g = pi/4 after every step."""
    _, pt = _pair(stabilization="rv", record_metrics=True)
    res = pt.solve()
    assert set(res.metrics) == {"eps_max", "newton_iters",
                                "newton_converged", "residual_norm",
                                "u_min", "u_max"}
    assert res.metrics["eps_max"].shape == (3,)
    assert bool(res.metrics["newton_converged"].all())
    bnd = pt.host_mesh.boundary_mask
    np.testing.assert_array_equal(res.u.numpy()[bnd], np.pi / 4)
