"""The port's geometric multigrid (ops/multigrid.py) against the JAX
package's, f64 on the CPU, on the pinned P1 Poisson of the Stokes
pressure solve (nx 16) and the 2x2 Stokes momentum block (nx 8): the
hierarchy (MGStatic, planes, damping, coarse inverse) equal to JAX's; one
V-cycle on the same right-hand side within 1e-12 of JAX's; the MG-PCG
iteration count equal to JAX's; the cycle a symmetric operator (a valid
CG preconditioner). coarse_max 30 gives a real hierarchy at these sizes
(17 -> 9 -> 5 and a dense 5 x 5)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.ops import assembly as jasm
from conservation_fem_tpu.ops import lattice as jlat
from conservation_fem_tpu.ops import multigrid as jmg
from conservation_fem_tpu.ops.krylov import cg as jcg
from conservation_fem_tpu.ops.mesh import rectangle_mesh as jrect
from conservation_fem_tpu_torch.models import stokes as ts
from conservation_fem_tpu_torch.ops import assembly as tasm
from conservation_fem_tpu_torch.ops import lattice as tlat
from conservation_fem_tpu_torch.ops import multigrid as tmg
from conservation_fem_tpu_torch.ops.krylov import cg as tcg
from conservation_fem_tpu_torch.ops.mesh import rectangle_mesh as trect


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _poisson(nx, coarse_max):
    """The pinned Poisson operator and its hierarchy, both packages:
    (plan, (JAX matvec, static, arrays), (port matvec, static, arrays))."""
    jhost = jrect((0, 0), (1, 1), nx=nx)
    thost = trect((0, 0), (1, 1), nx=nx)
    bc = np.asarray(jhost.boundary_mask)
    K1 = np.asarray(jasm.assemble_stiffness(jhost.device_arrays(jnp.float64)))
    plan = jlat.build_plan(np.asarray(jhost.points))
    tplan = tlat.build_plan(thost.points)
    out = [plan]
    for lat_, mg, host, bcg, where, asarr, kw in (
            (jlat, jmg, jhost, jlat.to_grid(plan, jnp.asarray(bc)),
             jnp.where, jnp.asarray, {}),
            (tlat, tmg, thost, tlat.to_grid(tplan, torch.from_numpy(bc)),
             torch.where, torch.from_numpy, {"device": "cpu"})):
        p = plan if lat_ is jlat else tplan
        op = lat_.lattice_op(p, host, K1)

        def A(xf, op=op, bcg=bcg, where=where, p=p):
            x = xf.reshape(p.nI, p.nJ)
            return where(bcg, x, op(where(bcg, 0.0, x))).reshape(-1)

        static, arrs = mg.build_mg(p, host.patch_cols, host.patch_mask,
                                   [[K1]], bc, coarse_max=coarse_max, **kw)
        out.append((A, static, arrs))
    return tuple(out)


def _arrays_match(tarrs, jarrs, static):
    for l in range(len(static.shapes)):
        np.testing.assert_array_equal(tarrs["dinv"][l].numpy(),
                                      np.asarray(jarrs["dinv"][l]))
        for s in range(static.ncomp):
            for d in range(static.ncomp):
                if jarrs["planes"][l][s][d] is None:
                    assert tarrs["planes"][l][s][d] is None
                    continue
                np.testing.assert_allclose(
                    tarrs["planes"][l][s][d].numpy(),
                    np.asarray(jarrs["planes"][l][s][d]), rtol=0, atol=1e-14)
    np.testing.assert_allclose(tarrs["cinv"].numpy(),
                               np.asarray(jarrs["cinv"]), rtol=1e-13,
                               atol=1e-13)


def test_poisson_hierarchy_and_vcycle_match_jax():
    plan, (_, jstat, jarrs), (_, tstat, tarrs) = _poisson(16, 30)
    assert tstat == jstat
    assert tstat.shapes == ((17, 17), (9, 9)) and tstat.coarse_shape == (5, 5)
    _arrays_match(tarrs, jarrs, tstat)
    b = np.random.default_rng(0).standard_normal((1, plan.nI, plan.nJ))
    got = tmg.vcycle(tstat, tarrs, torch.from_numpy(b)).numpy()
    want = np.asarray(jax.jit(lambda b: jmg.vcycle(jstat, jarrs, b))(
        jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.abs(want).max() > 1e-3


def test_stokes_momentum_hierarchy_and_vcycle_match_jax():
    """The 2x2 momentum block (nonsymmetric boundary-edge coupling) of the
    Stokes step at nx 8, wall rows pinned."""
    tp, fd = ts.build(nx=8, num_steps=4, T=0.08, backend="lattice",
                      device="cpu")
    A = ts.step_buffers(tp, fd)[1]["A"]       # the same values both sides
    sp = tp.sp
    blocks = lambda f: [[f(A[s, d]) for d in range(2)] for s in range(2)]
    plan2 = jlat.build_plan(tp.vspace.dof_coords)
    tplan2 = tlat.build_plan(tp.vspace.dof_coords)
    jstat, jarrs = jmg.build_mg(plan2, sp.patch_cols.numpy(),
                                sp.patch_mask.numpy(),
                                blocks(lambda a: a.numpy()),
                                tp.wall_mask.numpy(), coarse_max=30)
    tstat, tarrs = tmg.build_mg(tplan2, sp.patch_cols, sp.patch_mask,
                                blocks(lambda a: a), tp.wall_mask,
                                coarse_max=30, device="cpu")
    assert tstat == jstat and len(tstat.shapes) >= 2
    _arrays_match(tarrs, jarrs, tstat)
    b = np.random.default_rng(1).standard_normal((2, plan2.nI, plan2.nJ))
    got = tmg.vcycle(tstat, tarrs, torch.from_numpy(b)).numpy()
    want = np.asarray(jax.jit(lambda b: jmg.vcycle(jstat, jarrs, b))(
        jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("coarse_max", [30, 700])
def test_mg_pcg_count_matches_jax(coarse_max):
    """MG-PCG on the pinned Poisson at nx 16 (coarse_max 700: the dense
    solve alone, the default at this size) to rtol 1e-10."""
    plan, (jA, jstat, jarrs), (tA, tstat, tarrs) = _poisson(16, coarse_max)
    b = np.random.default_rng(2).standard_normal(plan.nI * plan.nJ)
    jpre = jmg.preconditioner(jstat, jarrs)
    jsol = jax.jit(lambda b: jcg(jA, b, precond=jpre, rtol=1e-10))(
        jnp.asarray(b))
    tsol = tcg(tA, torch.from_numpy(b), precond=tmg.preconditioner(
        tstat, tarrs), rtol=1e-10)
    assert tsol.iters == int(jsol.iters)
    assert tsol.iters <= (9 if coarse_max == 30 else 2)
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x), rtol=0,
                               atol=1e-10)


def test_vcycle_is_symmetric():
    plan, _, (_, tstat, tarrs) = _poisson(16, 30)
    pre = tmg.preconditioner(tstat, tarrs)
    rng = np.random.default_rng(0)
    b1, b2 = (torch.from_numpy(rng.standard_normal(plan.nI * plan.nJ))
              for _ in range(2))
    s1 = float(pre(b1) @ b2)
    s2 = float(b1 @ pre(b2))
    assert abs(s1 - s2) <= 1e-12 * abs(s1)


def test_mg_needs_a_full_lattice_and_odd_grids():
    m = trect((0, 0), (1, 1), nx=5)
    K1 = tasm.assemble_stiffness(m.device_arrays(torch.float64, "cpu"))
    plan = tlat.build_plan(m.points)
    holed = tlat.LatticePlan(plan.nI, plan.nJ, plan.idx, plan.dof_at, False)
    with pytest.raises(NotImplementedError, match="full lattice"):
        tmg.build_mg(holed, m.patch_cols, m.patch_mask, [[K1]],
                     m.boundary_mask, device="cpu")
    # an even grid (66 x 66 points) cannot coarsen, and its dense solve
    # would exceed the limit
    m = trect((0, 0), (1, 1), nx=65)
    K1 = tasm.assemble_stiffness(m.device_arrays(torch.float64, "cpu"))
    with pytest.raises(ValueError, match="odd"):
        tmg.build_mg(tlat.build_plan(m.points), m.patch_cols, m.patch_mask,
                     [[K1]], m.boundary_mask, device="cpu")
