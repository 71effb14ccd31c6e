"""The port's lattice-stencil operators (ops/lattice.py) against the JAX
package's, f64 on the CPU: the plans of P1/P2/P3 spaces on rectangle
meshes equal; the offsets and planes of their mass and stiffness within
1e-14; lattice products within 1e-13 of the port's ELL SpMV; a lattice
with holes (P1 dofs on a 2x grid), the per-step relayout
(ell_to_planes_fn) and the COO converter on an embedded plan; and the
lattice backend of the scalar and Pk steps (Burgers P1 on the ELL step
and P2 SI) within 1e-12 of the port's gather path and 1e-11 of the JAX
package's lattice run."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import burgers as jb
from conservation_fem_tpu.ops import assembly as jasm
from conservation_fem_tpu.ops import assembly_pk as japk
from conservation_fem_tpu.ops import lattice as jlat
from conservation_fem_tpu.ops.mesh import rectangle_mesh as jrect
from conservation_fem_tpu.ops.spaces import build_space as jspace
from conservation_fem_tpu_torch.models import burgers as tb
from conservation_fem_tpu_torch.ops import assembly as tasm
from conservation_fem_tpu_torch.ops import assembly_pk as tapk
from conservation_fem_tpu_torch.ops import lattice as tlat
from conservation_fem_tpu_torch.ops.mesh import rectangle_mesh as trect
from conservation_fem_tpu_torch.ops.spaces import build_space as tspace
from conservation_fem_tpu_torch.ops.spmv import ell_matvec

# (degree, nx, ny): P1 on a 7 x 5 rectangle, P2 on 6 x 4, P3 on 4 x 4
SPACES = [(1, 7, 5), (2, 6, 4), (3, 4, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spaces(k, nx, ny):
    """(JAX arrays, port arrays, coords, {name: (JAX ELL, port ELL)})."""
    if k == 1:
        jm = jrect(nx=nx, ny=ny).device_arrays(jnp.float64)
        tm = trect(nx=nx, ny=ny).device_arrays(torch.float64, "cpu")
        ops = {"mass": (jasm.assemble_mass(jm), tasm.assemble_mass(tm)),
               "stiffness": (jasm.assemble_stiffness(jm),
                             tasm.assemble_stiffness(tm))}
        return jm, tm, np.asarray(jm.points), ops
    js = jspace(jrect(nx=nx, ny=ny), k).device_arrays(jnp.float64)
    ts = tspace(trect(nx=nx, ny=ny), k).device_arrays(torch.float64, "cpu")
    ops = {"mass": (japk.assemble_mass(js), tapk.assemble_mass(ts)),
           "stiffness": (japk.assemble_stiffness(js),
                         tapk.assemble_stiffness(ts))}
    return js, ts, np.asarray(js.dof_coords), ops


def _plans_equal(a, b):
    assert (a.nI, a.nJ, a.full) == (b.nI, b.nJ, b.full)
    np.testing.assert_array_equal(a.idx, b.idx)
    np.testing.assert_array_equal(a.dof_at, b.dof_at)


@pytest.mark.parametrize("k,nx,ny", SPACES)
def test_plans_and_planes_match_jax(k, nx, ny):
    js, ts, coords, ops = _spaces(k, nx, ny)
    jplan, tplan = jlat.build_plan(coords), tlat.build_plan(coords)
    _plans_equal(tplan, jplan)
    assert tplan.full and (tplan.nI, tplan.nJ) == (k * nx + 1, k * ny + 1)
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal(coords.shape[0]))
    for name, (Aj, At) in ops.items():
        oj, pj = jlat.to_planes(jplan, np.asarray(js.patch_cols),
                                np.asarray(Aj))
        ot, pt = tlat.to_planes(tplan, ts.patch_cols, At)
        assert ot == oj, name
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-14)
        op = tlat.lattice_op(tplan, ts, At)
        y = tlat.from_grid(tplan, op(tlat.to_grid(tplan, x)))
        np.testing.assert_allclose(y.numpy(), ell_matvec(ts, At, x).numpy(),
                                   rtol=0, atol=1e-13)
    if k == 1:
        # the P1 Laplacian on this triangulation is the 5-point stencil
        assert len(tlat.lattice_op(tplan, ts, ops["stiffness"][1])
                   .offsets) == 5


def test_ell_matvec_sums_each_row_in_slot_order():
    """The ELL SpMV sums a row's products in slot order 0..K-1 on the CPU,
    in f32 too, as the JAX package's row sum does (ops/spmv.py; the f32
    step counts of test_torch_burgers.py depend on it)."""
    m = trect(nx=9, ny=7).device_arrays(torch.float32, "cpu")
    rng = np.random.default_rng(11)
    A = torch.from_numpy(rng.standard_normal(m.patch_cols.shape)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(m.points.shape[0])
                         .astype(np.float32))
    G = A * x[m.patch_cols]
    want = G[:, 0]
    for k in range(1, G.shape[1]):
        want = want + G[:, k]
    assert torch.equal(ell_matvec(m, A, x), want)


def test_lattice_with_holes_p1_on_a_2x_grid():
    """P1 dofs on every second point of a 2x grid: the holes read 0 and
    carry zero planes, so the product equals the ELL one."""
    m = trect(nx=5, ny=3).device_arrays(torch.float64, "cpu")
    K = tasm.assemble_stiffness(m)
    plan = tlat.build_plan(m.points)
    holed = tlat.LatticePlan(
        nI=2 * plan.nI, nJ=2 * plan.nJ,
        idx=(plan.idx // plan.nJ) * 2 * (2 * plan.nJ)
        + (plan.idx % plan.nJ) * 2,
        dof_at=np.full(4 * plan.nI * plan.nJ, -1, np.int64), full=False)
    op = tlat.lattice_op(holed, m, K)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        m.points.shape[0]))
    g = tlat.to_grid(holed, x, fill=7.0)
    assert int((g == 7.0).sum()) == 4 * plan.nI * plan.nJ - plan.idx.size
    got = tlat.from_grid(holed, op(tlat.to_grid(holed, x)))
    np.testing.assert_allclose(got.numpy(), ell_matvec(m, K, x).numpy(),
                               rtol=0, atol=1e-13)


def test_ell_to_planes_matches_jax_and_host():
    js, ts, coords, ops = _spaces(2, 5, 4)
    Aj = ops["stiffness"][0]
    At = torch.from_numpy(np.array(Aj))    # the same values on both sides
    conv_j = jlat.ell_to_planes_fn(jlat.build_plan(coords), js)
    tplan = tlat.build_plan(coords)
    conv_t = tlat.ell_to_planes_fn(tplan, ts)
    assert conv_t.offsets == conv_j.offsets
    lop = conv_t(At)
    np.testing.assert_array_equal(lop.planes.numpy(),
                                  np.asarray(conv_j(Aj).planes))
    host = tlat.lattice_op(tplan, ts, At)
    x2 = tlat.to_grid(tplan, torch.from_numpy(
        np.random.default_rng(7).standard_normal(coords.shape[0])))
    np.testing.assert_allclose(lop(x2).numpy(), host(x2).numpy(), rtol=0,
                               atol=1e-13)


def test_coo_planes_on_an_embedded_plan_match_jax():
    """A rectangular P1 -> P2 operator, its P1 side embedded on the P2
    grid: offsets and planes equal JAX's, the product equals the COO
    product."""
    import scipy.sparse as sps

    nx = 4
    p2 = tlat.build_plan(tspace(trect(nx=nx, ny=nx), 2).dof_coords)
    p1 = tlat.build_plan(trect(nx=nx, ny=nx).points)
    emb = tlat.embed_plan(p1, 2, p2.nI, p2.nJ)
    jemb = jlat.embed_plan(jlat.LatticePlan(p1.nI, p1.nJ, p1.idx, p1.dof_at,
                                            p1.full), 2, p2.nI, p2.nJ)
    _plans_equal(emb, jemb)
    rng = np.random.default_rng(5)
    n2, n1 = p2.idx.size, p1.idx.size
    rows = rng.integers(0, n2, 300)
    near = (np.abs(p2.idx[rows] // p2.nJ - 2 * (p1.idx // p1.nJ)[:, None])
            <= 2) & (np.abs(p2.idx[rows] % p2.nJ
                            - 2 * (p1.idx % p1.nJ)[:, None]) <= 2)
    cols = np.array([rng.choice(np.flatnonzero(near[:, r]))
                     for r in range(rows.size)])
    vals = rng.standard_normal(rows.size)
    jp2 = jlat.LatticePlan(p2.nI, p2.nJ, p2.idx, p2.dof_at, p2.full)
    oj, pj = jlat.to_planes_coo(jp2, jemb, rows, cols, vals)
    ot, pt = tlat.to_planes_coo(p2, emb, rows, cols, vals)
    assert ot == oj
    np.testing.assert_array_equal(pt, pj)
    x = rng.standard_normal(n1)
    want = sps.coo_matrix((vals, (rows, cols)), shape=(n2, n1)) @ x
    op = tlat.LatticeOp(tuple(ot), torch.from_numpy(pt))
    got = tlat.from_grid(p2, op(tlat.to_grid(emb, torch.from_numpy(x))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


BURGERS = {"p1_ell_m8": dict(mesh_size=8, T=0.1, backend="ell"),
           "p2_si_m6": dict(mesh_size=6, degree=2, stabilization="si",
                            T=0.05)}


@functools.lru_cache(maxsize=None)
def _port_burgers(case, backend):
    cfg = tb.BurgersConfig(**BURGERS[case], ell_matvec_backend=backend)
    return tb.build(cfg, device="cpu").solve().u.numpy()


@pytest.mark.parametrize("case", list(BURGERS))
def test_burgers_lattice_backend_matches_gather(case):
    np.testing.assert_allclose(_port_burgers(case, "lattice"),
                               _port_burgers(case, "gather"), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("case", list(BURGERS))
def test_burgers_lattice_backend_matches_jax(case):
    uj = np.asarray(jb.build(jb.BurgersConfig(
        **BURGERS[case], ell_matvec_backend="lattice")).solve().u)
    u = _port_burgers(case, "lattice")
    np.testing.assert_allclose(u, uj, rtol=0, atol=1e-11)
    assert np.abs(u).max() > 0.1
