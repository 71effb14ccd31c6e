"""The port's Pk Burgers (models/burgers.py with degree 2 and 3, through
models/pk_hyperbolic.PkHyperbolicProblem) against the JAX package's, f64
on the CPU: P2 SI and RV at mesh 8 and P3 SI at mesh 4, adaptive and the
fixed-Chebyshev config, to T = 0.1; trajectories within 1e-10 (the SI
sigmoid and the Newton solves amplify the 1e-12 solver roundoff: ~1e-13
measured), the L1 and L2 errors against the exact solution within 1e-10;
and the step counts of the JAX package at N = 8, 12, 20, 32 in f64 and f32
(dt = CFL min h_CG / degree^2, the trap of the f32 projection)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import burgers as jb
from conservation_fem_tpu.ops.helpers import get_nodal_h
from conservation_fem_tpu.ops.mesh import rectangle_mesh as jrect
from conservation_fem_tpu_torch.models import burgers as tb

TOL = 1e-10
FIXED = dict(modified_newton=True, cg_iters=12, newton_iters=2,
             newton_linear_iters=10, inner_solver="cheby")
CASES = {
    "p2_si_m8": dict(degree=2, mesh_size=8, stabilization="si"),
    "p2_rv_m8": dict(degree=2, mesh_size=8, stabilization="rv"),
    "p3_si_m4": dict(degree=3, mesh_size=4, stabilization="si"),
    "p2_si_m8_fixed_cheby": dict(degree=2, mesh_size=8, stabilization="si",
                                 **FIXED),
}


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
def _jax_run(case):
    p = jb.build(jb.BurgersConfig(T=0.1, **CASES[case]))
    r = p.solve()
    t = r.num_steps * r.dt
    return (np.asarray(r.u), r.dt, r.num_steps,
            float(jb.l1_error_vs_exact(p, r.u, t)),
            float(jb.l2_error_vs_exact(p, r.u, t)))


@pytest.mark.parametrize("case", list(CASES))
def test_pk_burgers_matches_jax(case):
    u, dt, steps, l1, l2 = _jax_run(case)
    p = tb.build(tb.BurgersConfig(T=0.1, **CASES[case]), device="cpu")
    assert type(p).__name__ == "PkHyperbolicProblem"
    assert (p.dt, p.num_steps) == (dt, steps)
    r = p.solve()
    np.testing.assert_allclose(r.u.numpy(), u, rtol=0, atol=TOL)
    t = r.num_steps * r.dt
    assert abs(float(tb.l1_error_vs_exact(p, r.u, t)) - l1) <= TOL
    assert abs(float(tb.l2_error_vs_exact(p, r.u, t)) - l2) <= TOL
    assert l1 > 1e-3


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N", [8, 12, 20, 32])
def test_step_counts_match_jax(N, dtype):
    h = float(get_nodal_h(jrect((0, 0), (1, 1), nx=N).device_arrays(
        jnp.dtype(dtype))).min())
    for degree in (2, 3):
        dt_jax = 0.5 * h / degree**2
        cfg = tb.BurgersConfig(mesh_size=N, degree=degree, dtype=dtype)
        p = tb.build(cfg, device="cpu")
        assert p.num_steps == int(np.ceil(0.5 / dt_jax)), (degree, p.dt,
                                                           dt_jax)
        assert p.u0.numel() == (degree * N + 1) ** 2


def test_per_degree_chebyshev_bounds():
    for degree, mass, lin in ((2, (0.35, 2.1), (0.3, 2.2)),
                              (3, (0.25, 2.1), (0.2, 2.2))):
        p = tb.build(tb.BurgersConfig(mesh_size=4, degree=degree, T=0.05),
                     device="cpu")
        assert (p.cfg.cheby_mass_bounds, p.cfg.cheby_lin_bounds) == (mass,
                                                                     lin)


def test_pk_options_that_raise():
    # the lattice backend is ported (test_torch_lattice.py): it builds
    p = tb.build(tb.BurgersConfig(mesh_size=4, degree=2,
                                  ell_matvec_backend="lattice"),
                 device="cpu")
    assert p._lattice[0].full
    # the blocked Pk backend is ported (ROADMAP queue 1 item 13;
    # tests/test_torch_blocked_model.py holds it against the JAX package)
    p = tb.build(tb.BurgersConfig(mesh_size=4, degree=2,
                                  ell_matvec_backend="blocked"),
                 device="cpu")
    assert p.plan.nd == 6 and len(p.dof_perm) == p.u0.numel()
    with pytest.raises(ValueError, match="P1 only"):
        tb.build(tb.BurgersConfig(mesh_size=4, degree=2, backend="stencil"),
                 device="cpu")
    with pytest.raises(ValueError, match="degree"):
        tb.build(tb.BurgersConfig(mesh_size=4, degree=4), device="cpu")


@pytest.mark.parametrize("case", ["p2_si_m8", "p2_rv_m8",
                                  "p2_si_m8_fixed_cheby"])
def test_pk_burgers_blocked_matches_jax(case):
    """The blocked Pk step (RCM-permuted dofs, the ELL kernels' plain
    versions here) against the JAX package's run of the same case, through
    dof_perm (the JAX package holds its own blocked backend to this run
    at 1e-12, tests/test_blocked_pk.py)."""
    u, dt, steps, l1, l2 = _jax_run(case)
    p = tb.build(tb.BurgersConfig(T=0.1, ell_matvec_backend="blocked",
                                  **CASES[case]), device="cpu")
    assert type(p).__name__ == "BlockedPkHyperbolicProblem"
    assert (p.dt, p.num_steps) == (dt, steps)
    r = p.solve()
    np.testing.assert_allclose(r.u.numpy()[p.dof_perm], u, rtol=0,
                               atol=TOL)
    t = r.num_steps * r.dt
    assert abs(float(tb.l2_error_vs_exact(p, r.u, t)) - l2) <= TOL
