"""The port's compressible Euler (models/euler.py, utils/riemann_exact.py,
ops/structured.directional_convection_coefs) against the JAX package's,
f64 on the CPU: the exact Riemann solver to 1e-14; primitives, flux and
wavespeed to 1e-14; dt, the step count and the resolved CRV; trajectories
within 1e-11 of the JAX package's (Sod nx 16 on both backends, riemann2d
nx 12 on the ELL backend, RK2 and RK3: each JAX run once, shared; a JAX
stencil run costs ~5 s of compilation here) and the port's stencil and
ELL backends within 1e-12 of each other on all of them; the uniform
state kept exactly; Sod nx 100 within 1e-10 of golden/euler_sod100.h5;
the Sod density error within 1e-12 of the JAX package's."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import euler as je
from conservation_fem_tpu.ops import structured as jst
from conservation_fem_tpu.ops.mesh import rectangle_mesh as jrect
from conservation_fem_tpu.utils import riemann_exact as jre
from conservation_fem_tpu_torch import __main__ as tmain
from conservation_fem_tpu_torch.models import euler as te
from conservation_fem_tpu_torch.ops import structured as tst
from conservation_fem_tpu_torch.ops.mesh import rectangle_mesh as trect
from conservation_fem_tpu_torch.utils import riemann_exact as tre

TOL = 1e-11
# (problem, nx, backend, rk_order) of the JAX runs; the port runs both
# backends of each and is held to the JAX run of the same backend
JAX_RUNS = [("sod", 16, "auto", 2), ("sod", 16, "ell", 3),
            ("riemann2d", 12, "ell", 2), ("riemann2d", 12, "ell", 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_run(problem, nx, backend, rk):
    p = je.build(problem=problem, nx=nx, backend=backend, rk_order=rk)
    r = je.solve(p)
    err = None
    if problem == "sod":
        err = je.sod_density_error(p, r.U, r.num_steps * r.dt)
    return np.asarray(r.U), p.dt, p.num_steps, p.cfg.CRV, err


@functools.lru_cache(maxsize=None)
def _port_run(problem, nx, backend, rk):
    p = te.build(problem=problem, nx=nx, backend=backend, rk_order=rk,
                 device="cpu")
    return p, te.solve(p)


def test_exact_riemann_solver_matches_jax():
    for left_right in [(1.0, 0.0, 1.0, 0.125, 0.0, 0.1),
                       (1.0, -2.0, 0.4, 1.0, 2.0, 0.4),
                       (1.0, 0.0, 1000.0, 1.0, 0.0, 0.01),
                       (5.99924, 19.5975, 460.894, 5.99242, -6.19633,
                        46.095)]:
        np.testing.assert_allclose(tre.solve_star(*left_right),
                                   jre.solve_star(*left_right), rtol=1e-14)
        xi = np.linspace(-25.0, 25.0, 401)
        for a, b in zip(tre.sample(xi, *left_right),
                        jre.sample(xi, *left_right)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)
    x = np.linspace(0.0, 1.0, 257)
    for t in (0.0, 0.1, 0.2):
        for a, b in zip(tre.sod_exact(x, t), jre.sod_exact(x, t)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)


def test_primitives_flux_wavespeed_match_jax():
    rng = np.random.default_rng(0)
    U = np.stack([rng.uniform(-0.1, 2.0, 500), rng.normal(size=500),
                  rng.normal(size=500), rng.uniform(0.0, 4.0, 500)], axis=1)
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    for a, b in zip(te.primitives(Ut, 1.4, 1e-10),
                    je.primitives(Uj, 1.4, 1e-10)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                   atol=1e-14)
    for a, b in zip(te.flux(Ut, 1.4, 1e-10), je.flux(Uj, 1.4, 1e-10)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                   atol=1e-14)
    np.testing.assert_allclose(te.wavespeed(Ut, 1.4, 1e-10).numpy(),
                               np.asarray(je.wavespeed(Uj, 1.4, 1e-10)),
                               rtol=1e-14, atol=1e-14)
    # the grid layout (components first) gives the same values
    Ug = Ut.T.reshape(4, 20, 25)
    np.testing.assert_array_equal(
        te.wavespeed(Ug, 1.4, 1e-10, axis=0).reshape(-1).numpy(),
        te.wavespeed(Ut, 1.4, 1e-10).numpy())


def test_directional_convection_coefs_match_jax():
    nx, ny = 6, 4
    sdj = jst.build_structured(jrect((0, 0), (1, 0.5), nx=nx, ny=ny), nx,
                               ny, jnp.float64)
    sdt = tst.build_structured(trect((0, 0), (1, 0.5), nx=nx, ny=ny), nx,
                               ny, torch.float64, "cpu")
    for a, b in zip(tst.directional_convection_coefs(sdt),
                    jst.directional_convection_coefs(sdj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-14)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_time_step_matches_jax(dtype):
    jp = je.build(problem="riemann2d", nx=24, dtype=dtype, backend="ell")
    tp = te.build(problem="riemann2d", nx=24, dtype=dtype, device="cpu")
    assert (tp.dt, tp.num_steps) == (jp.dt, jp.num_steps)
    assert tp.cfg.CRV == jp.cfg.CRV == 4.0
    assert tp.U0.dtype == getattr(torch, dtype)


def test_sod_build_matches_jax():
    _, dt, steps, crv, _ = _jax_run("sod", 16, "auto", 2)
    p, _ = _port_run("sod", 16, "auto", 2)
    assert (p.dt, p.num_steps, p.cfg.CRV) == (dt, steps, crv)
    assert crv == 1.0
    # the Sod tube freezes its x-ends only and slips on its y-walls
    x = p.mesh.points[:, 0]
    assert bool((p.bc_mask == (p.mesh.boundary_mask
                               & ((x == 0.0) | (x == 1.0)))).all())
    assert bool((p.slip_mask == (p.mesh.boundary_mask & ~p.bc_mask)).all())


@pytest.mark.parametrize("problem,nx,backend,rk", JAX_RUNS)
def test_trajectory_matches_jax(problem, nx, backend, rk):
    U, dt, steps, _, _ = _jax_run(problem, nx, backend, rk)
    p, r = _port_run(problem, nx, backend, rk)
    assert (r.dt, r.num_steps) == (dt, steps)
    np.testing.assert_allclose(r.U.numpy(), U, rtol=0, atol=TOL)
    assert float((r.U - p.U0).abs().max()) > 1e-2


@pytest.mark.parametrize("problem,nx", [("sod", 16), ("riemann2d", 12)])
@pytest.mark.parametrize("rk", [2, 3])
def test_stencil_backend_matches_ell(problem, nx, rk):
    _, r1 = _port_run(problem, nx, "auto", rk)
    _, r2 = _port_run(problem, nx, "ell", rk)
    np.testing.assert_allclose(r1.U.numpy(), r2.U.numpy(), rtol=0,
                               atol=1e-12)


def test_uniform_state_exactly_preserved():
    for backend in ("auto", "ell"):
        p = te.build(problem="uniform", nx=6, backend=backend, device="cpu")
        r = te.solve(p)
        assert float((r.U - p.U0).abs().max()) < 1e-12


def test_sod_density_error_matches_jax():
    _, _, _, _, err = _jax_run("sod", 16, "auto", 2)
    p, r = _port_run("sod", 16, "auto", 2)
    assert abs(te.sod_density_error(p, r.U, r.num_steps * r.dt) - err) \
        <= 1e-12


def test_sod100_matches_golden_h5():
    from conservation_fem_tpu.utils.io import read_h5_series

    p = te.build(problem="sod", nx=100, device="cpu")
    r = te.solve(p)
    for k in range(4):
        _, vals = read_h5_series("golden/euler_sod100.h5", f"U{k}")
        assert np.abs(r.U[:, k].numpy() - vals[-1]).max() < 1e-10, k
    assert te.sod_density_error(p, r.U, r.num_steps * r.dt) < 0.035


def test_options_and_device():
    with pytest.raises(ValueError, match="backend"):
        te.build(problem="sod", nx=8, backend="stencil", device="cpu")
    with pytest.raises(ValueError, match="rk_order"):
        te.build(problem="sod", nx=8, rk_order=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            te.build(problem="sod", nx=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmain.main(["euler", "--nx", "8"])


def test_cli_prints_its_json_line(capsys):
    import json

    assert tmain.main(["euler", "--problem", "sod", "--nx", "16",
                       "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["workload"] == "euler" and out["num_steps"] == 16
    assert 0.0 < out["L1_rho_error"] < 0.1
