"""The port's linear advection (models/linear_advection.py) against the JAX
package's, f64 on the CPU: every step (rv_cell with both scatters) on
disk_mesh(1/8) to T = 0.1, the square domain and the discontinuous IC, the
fixed-iteration and Chebyshev configs; trajectories within 1e-11 (the
same algorithm summed in other orders, ~15 steps of solves to 1e-12),
equal dt and step counts, L2 errors within 1e-11. Also the options that
raise, the card as the default device, the convergence harness and the
CLI."""

import functools
import json

import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import linear_advection as jla
from conservation_fem_tpu.utils import convergence as jconv
from conservation_fem_tpu_torch import __main__ as tmain
from conservation_fem_tpu_torch.models import linear_advection as tla
from conservation_fem_tpu_torch.ops.mesh import rcm_permutation
from conservation_fem_tpu_torch.utils import convergence as tconv

TOL = 1e-11
SHORT = dict(mesh_size=8, T=0.1)
FIXED = dict(cg_iters=10, krylov_iters=8)
CHEBY = dict(cg_iters=8, krylov_iters=12, inner_solver="cheby")

CASES = {
    "gfem": dict(stabilization="gfem"),
    "rv_node": dict(stabilization="rv_node"),
    "rv_node_simple": dict(stabilization="rv_node_simple"),
    "rv_cell_last": dict(stabilization="rv_cell"),
    "rv_cell_max": dict(stabilization="rv_cell", rv_cell_scatter="max"),
    "si": dict(stabilization="si"),
    "rk4": dict(stabilization="rk4"),
    "square_rv_node": dict(stabilization="rv_node", domain="square"),
    "discont_rv_cell": dict(stabilization="rv_cell", discontinuous_ic=True),
    "rv_node_fixed": dict(stabilization="rv_node", **FIXED),
    "rv_node_cheby": dict(stabilization="rv_node", **CHEBY),
    "rk4_cheby": dict(stabilization="rk4", **CHEBY),
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
    r = jla.run(jla.AdvectionConfig(**SHORT, **CASES[case]))
    return np.asarray(r.u), float(r.error_l2), r.dt, r.num_steps


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(case):
    u, err, dt, steps = _jax_run(case)
    r = tla.run(tla.AdvectionConfig(**SHORT, **CASES[case]), device="cpu")
    assert (r.dt, r.num_steps) == (dt, steps)
    np.testing.assert_allclose(r.u.numpy(), u, rtol=0, atol=TOL)
    assert abs(float(r.error_l2) - err) <= TOL
    # the solve moved the state
    assert float(r.error_l2) > 1e-3


def test_rv_cell_scatters_differ():
    """"last" and "max" give different viscosities, so different states."""
    a = _jax_run("rv_cell_last")[0]
    b = _jax_run("rv_cell_max")[0]
    assert np.abs(a - b).max() > 1e-8


def test_steps_and_time_step_match_jax_at_full_size():
    """dt and ceil(T/dt) of the f64 reference config at mesh 4 ... 32 (the
    convergence sweep), from the row-sum inf-norm of w, and the IC."""
    for n in (4, 8, 16, 32):
        pj = jla.build(jla.AdvectionConfig(mesh_size=n))
        pt = tla.build(tla.AdvectionConfig(mesh_size=n), device="cpu")
        assert (pt.dt, pt.num_steps) == (pj.dt, pj.num_steps)
        # tanh of two libraries: within an ulp or two
        np.testing.assert_allclose(pt.u0.numpy(), np.asarray(pj.u0),
                                   rtol=0, atol=1e-15)


@pytest.mark.parametrize("backend", ["banded", "blocked"])
def test_unported_backends_raise_naming_item_13(backend):
    """Ported since (ROADMAP queue 1 item 13): both backends run the gather
    backend's trajectory, blocked in RCM numbering; rv_cell's
    last-cell-wins scatter is refused on blocked, as in the JAX
    package."""
    cfg = dict(mesh_size=4, T=0.1, stabilization="rv_node")
    pg = tla.build(tla.AdvectionConfig(**cfg), device="cpu")
    ref = tla.solve(pg).u.numpy()
    p = tla.build(tla.AdvectionConfig(**cfg, ell_matvec_backend=backend),
                  device="cpu")
    u = tla.solve(p).u.numpy()
    if backend == "blocked":
        u = u[rcm_permutation(pg.host_mesh)]
        with pytest.raises(NotImplementedError, match="last-cell-wins"):
            tla.build(tla.AdvectionConfig(mesh_size=4, stabilization="rv_cell",
                                          ell_matvec_backend=backend),
                      device="cpu")
    np.testing.assert_allclose(u, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("case", ["rv_node", "rv_cell_max", "si",
                                  "rv_node_cheby"])
def test_blocked_matches_jax(case):
    """The blocked backend (RCM numbering, the ELL kernels' plain versions
    here) against the JAX package's run of the same case, through the RCM
    permutation (the JAX package holds its own blocked backend to this run
    at 1e-11, tests/test_blocked_advection.py)."""
    u, err, dt, steps = _jax_run(case)
    p = tla.build(tla.AdvectionConfig(**SHORT, **CASES[case],
                                      ell_matvec_backend="blocked"),
                  device="cpu")
    assert (p.dt, p.num_steps) == (dt, steps)
    r = tla.solve(p)
    perm = rcm_permutation(tla.build(tla.AdvectionConfig(**SHORT),
                                     device="cpu").host_mesh)
    np.testing.assert_allclose(r.u.numpy()[perm], u, rtol=0, atol=TOL)
    assert abs(float(r.error_l2) - err) <= TOL


def test_unknown_options_raise():
    for over in (dict(stabilization="rv"), dict(domain="ring"),
                 dict(rv_cell_scatter="first"), dict(inner_solver="gmres"),
                 dict(ell_matvec_backend="lattice")):
        with pytest.raises(ValueError):
            tla.build(tla.AdvectionConfig(mesh_size=4, **over), device="cpu")


def test_build_targets_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tla.build(tla.AdvectionConfig(mesh_size=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tla.run(mesh_size=4)
    for workload in ("advection", "convergence"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmain.main([workload])


@pytest.mark.parametrize("errors", [
    [0.17, 0.061, 0.019, 0.0044],
    [1.0, 0.5, 0.25, 0.125],
    [0.3, 0.09, 0.05],
])
def test_run_convergence_matches_jax(errors):
    sizes = (4, 8, 16, 32)[:len(errors)]
    table = dict(zip(sizes, errors))
    rj = jconv.run_convergence(table.__getitem__, sizes)
    rt = tconv.run_convergence(table.__getitem__, sizes)
    np.testing.assert_array_equal(rt.hmaxes, rj.hmaxes)
    np.testing.assert_array_equal(rt.errors, rj.errors)
    assert rt.slope == rj.slope and rt.fit == rj.fit
    np.testing.assert_array_equal(rt.rates(), rj.rates())


def test_cli_advection(capsys):
    assert tmain.main(["advection", "--mesh_size", "8", "--T", "0.1",
                       "--stabilization", "rv_node", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _, err, _, steps = _jax_run("rv_node")
    assert (out["workload"], out["stabilization"], out["mesh_size"],
            out["num_steps"], out["device"]) == ("advection", "rv_node", 8,
                                                 steps, "cpu")
    assert abs(out["L2_error_vs_ic"] - err) <= TOL
