"""The port's Stokes/IPCS (models/stokes.py, ops/facets.py) against the
JAX package's, f64 on the CPU: the boundary facet data equal; the built
operators (P2 mass, viscous and edge blocks, P1 stiffness, masks, initial
state) and the host coupling matrices within 1e-13; auto_kip equal;
trajectories within 1e-10 of the JAX package's for a few steps on the ell
backend (nx 4), the lattice backend (nx 4), the lattice backend with
multigrid (nx 8) and with fixed Krylov counts (nx 4), each JAX run once;
the refusals of multigrid on ell and of the grid backend."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import stokes as js
from conservation_fem_tpu.ops.facets import boundary_facet_data as jfacets
from conservation_fem_tpu.ops.mesh import rectangle_mesh as jrect
from conservation_fem_tpu.ops.spaces import build_space as jspace
from conservation_fem_tpu_torch import __main__ as tmain
from conservation_fem_tpu_torch.models import stokes as ts
from conservation_fem_tpu_torch.ops.facets import \
    boundary_facet_data as tfacets
from conservation_fem_tpu_torch.ops.mesh import rectangle_mesh as trect
from conservation_fem_tpu_torch.ops.spaces import build_space as tspace

TOL = 1e-10
RUNS = {
    "ell_nx4": dict(nx=4, num_steps=5, T=0.1),
    "lattice_nx4": dict(nx=4, num_steps=5, T=0.1, backend="lattice"),
    "lattice_mg_nx8": dict(nx=8, num_steps=4, T=0.08, backend="lattice",
                           multigrid=True),
    "lattice_fixed_nx4": dict(nx=4, num_steps=5, T=0.1, backend="lattice",
                              krylov_iters=6),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _built(case):
    """(JAX (problem, facets), port (problem, facets)) of a RUNS case."""
    return (js.build(**RUNS[case]),
            ts.build(**RUNS[case], device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_solve(case):
    r = js.solve(_built(case)[0])
    return np.asarray(r.u), np.asarray(r.p), r.error_l2


def test_facet_data_matches_jax():
    fj = jfacets(jspace(jrect((0, 0), (1, 1), nx=4), 2))
    ft = tfacets(tspace(trect((0, 0), (1, 1), nx=4), 2))
    assert len(ft.edge_cell) == 16
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ft.length.sum(), 4.0)


def test_built_operators_match_jax():
    (jp, _), (tp, _) = _built("ell_nx4")
    assert tp.dt == jp.dt
    for name in ("M2", "visc", "edge", "K1", "p_bc_val", "u0", "p0"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)), rtol=0,
                                   atol=1e-13, err_msg=name)
    for name in ("wall_mask", "p_bc_mask"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))


def test_host_coupling_matches_jax():
    (jp, jfd), (tp, tfd) = _built("ell_nx4")
    cj, ct = js.host_coupling_coo(jp, jfd), ts.host_coupling_coo(tp, tfd)
    assert sorted(ct) == sorted(cj)
    for key in cj:
        for (rj, cj_, vj), (rt, ct_, vt) in zip(cj[key], ct[key]):
            np.testing.assert_array_equal(rt, rj)
            np.testing.assert_array_equal(ct_, cj_)
            np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-13)


@pytest.mark.parametrize("over", [
    dict(), dict(krylov_iters=25), dict(krylov_iters=25, nx=64),
    dict(krylov_iters=5, multigrid=True), dict(krylov_iters_pressure=7),
    dict(krylov_iters=6, nx=64, multigrid=True)])
def test_auto_kip_matches_jax(over):
    assert ts.auto_kip(ts.StokesConfig(**over)) == js.auto_kip(
        js.StokesConfig(**over))


@pytest.mark.parametrize("case", list(RUNS))
def test_trajectory_matches_jax(case):
    u, p, err = _jax_solve(case)
    r = ts.solve(_built(case)[1])
    np.testing.assert_allclose(r.u.numpy(), u, rtol=0, atol=TOL)
    np.testing.assert_allclose(r.p.numpy(), p, rtol=0, atol=TOL)
    assert abs(r.error_l2 - err) <= TOL
    assert r.num_steps == RUNS[case]["num_steps"]
    assert float(r.u[0].max()) > 0.1


def test_refusals():
    p, fd = ts.build(nx=4, num_steps=2, multigrid=True, device="cpu")
    with pytest.raises(NotImplementedError, match="lattice"):
        ts.step_buffers(p, fd)
    # backend="grid" runs since item 15c (the row-sharded step on one
    # block), within roundoff of the lattice backend
    grid = ts.solve(cfg=ts.StokesConfig(nx=4, num_steps=2, backend="grid"),
                    device="cpu")
    lattice = ts.solve(cfg=ts.StokesConfig(nx=4, num_steps=2,
                                           backend="lattice"), device="cpu")
    assert (grid.u - lattice.u).abs().max() < 1e-9
    with pytest.raises(ValueError, match="backend"):
        ts.build(nx=4, backend="stencil", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.build(nx=4)


def test_cli_prints_its_json_line(capsys):
    import json

    assert tmain.main(["stokes", "--nx", "4", "--num_steps", "10",
                       "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["workload"] == "stokes" and out["num_steps"] == 10
    assert 0.0 < out["L2_error_vs_poiseuille"] < 1.0
