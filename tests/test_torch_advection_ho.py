"""The port's Pk advection (models/advection_ho.py) against the JAX
package's, f64 on the CPU, to T = 0.1: P2 gfem, rv, rv_simple and si at
mesh 4 and 8, P3 rv_simple at mesh 4, the curved boundary, the
discontinuous IC and the Chebyshev config; trajectories within 1e-10,
equal dt and step counts, L2 errors within 1e-10. The port starts from
the JAX package's u0, which its own IC meets within 1e-15 (tanh of two
libraries): P3 SI grows an IC perturbation of 4e-16 to ~1e-9 in 8 steps in
the JAX package itself (its own run from u0 + 4e-16 noise), while from the
same u0 the two packages agree within 2e-14. Also the options that raise,
the card as the default device and the CLI."""

import functools
import json

import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import advection_ho as jho
from conservation_fem_tpu_torch import __main__ as tmain
from conservation_fem_tpu_torch.models import advection_ho as tho

TOL = 1e-10
SHORT = dict(T=0.1)
CASES = {
    "p2_gfem_m4": dict(degree=2, mesh_size=4),
    "p2_gfem_m8": dict(degree=2, mesh_size=8),
    "p2_rv_m4": dict(degree=2, mesh_size=4, stabilization="rv"),
    "p2_rv_simple_m4": dict(degree=2, mesh_size=4, stabilization="rv_simple"),
    "p2_si_m4": dict(degree=2, mesh_size=4, stabilization="si"),
    "p2_rv_m8": dict(degree=2, mesh_size=8, stabilization="rv"),
    "p3_rv_simple_m4": dict(degree=3, mesh_size=4, stabilization="rv_simple"),
    "p2_gfem_m4_curved": dict(degree=2, mesh_size=4, curved_boundary=True),
    "p3_si_m4_curved": dict(degree=3, mesh_size=4, stabilization="si",
                            curved_boundary=True),
    "p2_rv_m4_discont": dict(degree=2, mesh_size=4, stabilization="rv",
                             discontinuous_ic=True),
    "p2_rv_m4_cheby": dict(degree=2, mesh_size=4, stabilization="rv",
                           cg_iters=8, krylov_iters=12,
                           inner_solver="cheby"),
    "p1_gfem_m4_square": dict(degree=1, mesh_size=4, domain="square"),
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
    p, u, err = jho.run(jho.HOAdvectionConfig(**SHORT, **CASES[case]))
    return np.asarray(u), err, p.dt, p.num_steps, np.asarray(p.u0)


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(case):
    u, err, dt, steps, u0 = _jax_run(case)
    p = tho.build(tho.HOAdvectionConfig(**SHORT, **CASES[case]),
                  device="cpu")
    assert (p.dt, p.num_steps) == (dt, steps)
    np.testing.assert_allclose(p.u0.numpy(), u0, rtol=0, atol=1e-15)
    p.u0 = torch.tensor(u0)
    ut, et = tho.solve(p)
    np.testing.assert_allclose(ut.numpy(), u, rtol=0, atol=TOL)
    assert abs(float(et) - err) <= TOL and err > 1e-3


def test_curved_boundary_changes_the_run():
    a = _jax_run("p2_gfem_m4")[0]
    b = _jax_run("p2_gfem_m4_curved")[0]
    assert a.shape == b.shape and np.abs(a - b).max() > 1e-6


def test_unported_and_unknown_options_raise():
    # the blocked backend is ported (ROADMAP queue 1 item 13;
    # tests/test_torch_blocked_model.py holds it against the gather run)
    p = tho.build(tho.HOAdvectionConfig(mesh_size=4,
                                        ell_matvec_backend="blocked"),
                  device="cpu")
    assert p.plan is not None and p.plan.nd == 6
    for over in (dict(stabilization="rv_node"), dict(degree=4),
                 dict(domain="ring"), dict(ell_matvec_backend="banded")):
        with pytest.raises(ValueError):
            tho.build(tho.HOAdvectionConfig(mesh_size=4, **over),
                      device="cpu")


def test_build_targets_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tho.build(tho.HOAdvectionConfig(mesh_size=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tho.run(mesh_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["advection_ho", "--mesh_size", "4"])


def test_cli_advection_ho(capsys):
    assert tmain.main(["advection_ho", "--mesh_size", "4", "--T", "0.1",
                       "--stabilization", "rv", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["workload"], out["degree"], out["stabilization"],
            out["device"]) == ("advection_ho", 2, "rv", "cpu")
    assert abs(out["L2_error_vs_ic"] - _jax_run("p2_rv_m4")[1]) <= TOL


@pytest.mark.parametrize("case", ["p2_rv_m8", "p2_si_m4", "p2_rv_m4_cheby"])
def test_blocked_matches_jax(case):
    """The blocked backend (RCM dof order, the ELL kernels' plain versions
    here) against the JAX package's run of the same case, through the dof
    permutation; from the JAX package's u0, as above."""
    u, err, dt, steps, u0 = _jax_run(case)
    p = tho.build(tho.HOAdvectionConfig(**SHORT, **CASES[case],
                                        ell_matvec_backend="blocked"),
                  device="cpu")
    assert (p.dt, p.num_steps) == (dt, steps)
    perm = p.space_perm
    start = np.empty_like(u0)
    start[perm] = u0
    p.u0 = torch.tensor(start)
    ut, et = tho.solve(p)
    np.testing.assert_allclose(ut.numpy()[perm], u, rtol=0, atol=TOL)
    assert abs(float(et) - err) <= TOL
