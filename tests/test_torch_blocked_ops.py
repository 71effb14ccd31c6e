"""The unstructured fast path's host code and operations (ops/tiling.py,
ops/blocked.py, ops/ell_kernels.py) against the JAX
package's, f64 on the CPU, on the same inputs (numpy-seeded):

  * the tile-slot layout of irregular_mesh(nx=60, seed=1) bit-equal to the
    JAX package's (slot map, padded mesh, slot_valid, tile stride), and
    WindowCoverageError raised for the same meshes and k;
  * the banded backend's ELL products and diagonal against the JAX
    package's diagonal storage, and the bandwidth, within 1e-12;
  * each ops/blocked.py function the models call against its JAX
    counterpart on an RCM-ordered rectangle_mesh(nx=12) (and the tiled
    plan's RV kernel with its phantom slots), within 1e-12: the port holds
    operators in ELL form and cell locals in cell order where the JAX
    package holds dense windows and component planes, so operators are
    compared through their products and diagonals, locals through what
    they assemble to.
The kernels' plain versions run here (CPU tensors); tests/
test_torch_cuda_blocked.py holds the kernels against them on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import burgers as jburgers
from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops import assembly as jasm
from conservation_fem_tpu.ops import banded as jband
from conservation_fem_tpu.ops import blocked as jblk
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.ops import tiling as jtile
from conservation_fem_tpu_torch.models import burgers as tburgers
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import assembly as tasm
from conservation_fem_tpu_torch.ops import blocked as tblk
from conservation_fem_tpu_torch.ops import ell_kernels as ek
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import tiling as ttile
from conservation_fem_tpu_torch.ops.spmv import ell_diag

TOL = 1e-12
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run shares the cores among several
    pytest worker processes, where torch's thread pool only
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


@pytest.fixture(scope="module")
def rect():
    """(JAX mesh, JAX plan, port mesh, port plan, fields) on the RCM
    rectangle_mesh(nx=12) of [-2,2]^2."""
    jm = jmesh.rectangle_mesh((-2, -2), (2, 2), nx=12)
    jm = jmesh.reorder_mesh(jm, jmesh.rcm_permutation(jm))
    tm = tmesh.rectangle_mesh((-2, -2), (2, 2), nx=12)
    tm = tmesh.reorder_mesh(tm, tmesh.rcm_permutation(tm))
    assert np.array_equal(jm.cells, tm.cells)
    jp = jblk.make_blocked_plan(jm, dtype=jnp.float64)
    tp = tblk.make_blocked_plan(tm, dtype=F64, device="cpu")
    rng = np.random.default_rng(0)
    n = tm.n_nodes
    f = dict(x=rng.standard_normal(n), u=rng.uniform(0.5, 11.0, n),
             eps=rng.uniform(0.0, 0.05, n), rh=rng.standard_normal(n),
             h=rng.uniform(0.05, 0.1, n), w=rng.standard_normal((n, 2)))
    return jm, jp, tm, tp, f


@pytest.fixture(scope="module")
def tiled():
    m = tmesh.irregular_mesh((-2, -2), (2, 2), nx=60, seed=1)
    mj = jmesh.irregular_mesh((-2, -2), (2, 2), nx=60, seed=1)
    return m, mj, ttile.tile_mesh(m), jtile.tile_mesh(mj)


def test_tile_layout_matches_jax(tiled):
    m, mj, (mt, slot), (mjt, slotj) = tiled
    assert np.array_equal(slot, slotj)
    got, want = ttile.tile_layout(m.points), jtile.tile_layout(mj.points)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert mt.tile_T == mjt.tile_T and mt.n_nodes == mjt.n_nodes
    assert np.array_equal(mt.slot_valid, mjt.slot_valid)
    assert np.array_equal(mt.cells, mjt.cells)
    assert np.array_equal(mt.points, mjt.points)
    assert np.array_equal(mt.boundary_mask, mjt.boundary_mask)
    assert bool(mt.boundary_mask[~mt.slot_valid].all())


@pytest.mark.parametrize("mesh", ["nx60", "small"])
@pytest.mark.parametrize("k", [None, 1, 2, 3])
def test_window_coverage_matches_jax(tiled, mesh, k):
    """WindowCoverageError where the JAX plan raises it
    (tests/test_blocked2d.py:91-96's mesh, and every k on nx = 60), the
    same window otherwise."""
    if mesh == "nx60":
        mt, mjt = tiled[2][0], tiled[3][0]
    else:
        mt, _ = ttile.tile_mesh(tmesh.irregular_mesh((0, 0), (1, 1), nx=12,
                                                     seed=0))
        mjt, _ = jtile.tile_mesh(jmesh.irregular_mesh((0, 0), (1, 1),
                                                      nx=12, seed=0))
    try:
        jp = jblk.make_tiled_plan(mjt, dtype=jnp.float64, k=k)
    except jblk.WindowCoverageError:
        with pytest.raises(tblk.WindowCoverageError):
            tblk.make_tiled_plan(mt, dtype=F64, k=k, device="cpu")
        return
    tp = tblk.make_tiled_plan(mt, dtype=F64, k=k, device="cpu")
    assert (tp.B, tp.n) == (jp.B, jp.n)
    assert np.array_equal(tp.row_valid.numpy(), np.asarray(jp.row_valid))


def test_banded_matches_jax(rect):
    """The banded backend's products (the ELL SpMV, plain and constrained,
    and the ELL diagonal for Jacobi) against the JAX package's diagonal
    storage on the same RCM mesh, and the bandwidth against its plan's."""
    jm, _, tm, tp, f = rect
    jb = jband.make_banded_plan(jm)
    assert tblk.bandwidth(tm.patch_cols, tm.patch_mask) == jb.bandwidth
    A = jasm.assemble_stiffness(jm)
    band_j = jband.ell_to_banded(jb, A)
    x, bc = f["x"], tm.boundary_mask
    y_j = jband.banded_matvec(band_j, jnp.asarray(x))
    assert np.abs(ek.ell_spmv(tp.mesh, _t(A), _t(x)).numpy()
                  - np.asarray(y_j)).max() <= TOL
    yc_j = jband.constrained_banded_matvec(band_j, jnp.asarray(x),
                                           jnp.asarray(bc))
    yc_t = ek.ell_spmv(tp.mesh, _t(A), _t(x), constrained=True)
    assert np.abs(yc_t.numpy() - np.asarray(yc_j)).max() <= TOL
    assert np.abs(ell_diag(tp.mesh, _t(A)).numpy()
                  - np.asarray(band_j[jb.bandwidth])).max() <= TOL


def _jax_case(name, jm, jp, f):
    """The JAX package's value of case ``name``."""
    C, blocks = jp.C, jp.blocks
    x, u, eps = (jnp.asarray(f[k]) for k in ("x", "u", "eps"))
    area = jp.area_b.reshape(-1)
    grads = jp.grads_b.reshape(-1, 3, 2)
    fpx, fpy = jkpp.flux_prime_xy
    mass9 = jblk.mass_locals_components(jp)
    mass = jblk.assemble_matrix_components(jp, mass9)
    L_keps = jblk.eps_locals_components(jp, eps)
    if name == "spmv_mass":
        return jblk.spmv(jp, mass, x)
    if name == "diag_mass":
        return jblk.diag_of(jp, mass)
    if name == "stiffness_bc":
        K = jblk.assemble_matrix(jp, jasm.local_stiffness(area, grads)
                                 .reshape(blocks, C, 3, 3))
        return jblk.constrained_matvec(jp, jblk.apply_bc_matrix(jp, K), x,
                                       jnp.asarray(jm.boundary_mask))
    if name == "scatter":
        return jblk.scatter_components(jp, jblk.gather_components(jp, x))
    if name == "conv_rhs":
        return jblk.conv_rhs_components(jp, u, fpx, fpy)
    if name == "conv_plus_keps":
        return jblk.conv_plus_locals_rhs_components(jp, u, fpx, fpy, L_keps)
    if name == "keps":
        return jblk.spmv(jp, jblk.assemble_matrix_components(jp, L_keps), x)
    if name == "newton_jacobian":
        L_J = mass9 + 0.005 * L_keps + 0.005 * \
            jblk.flux_jacobian_locals_components(jp, u, fpx, fpy)
        J = jblk.assemble_matrix_components(jp, L_J)
        return jnp.concatenate([jblk.spmv(jp, J, x), jblk.diag_of(jp, J)])
    if name in ("local_apply", "local_diag"):
        L = jasm.local_mass(area).reshape(blocks, C, 3, 3)
        return (jblk.local_apply(jp, L, x) if name == "local_apply"
                else jblk.local_diag(jp, L))
    if name == "patch_sum":
        return jblk.patch_sum(jp, x)
    if name == "smooth":
        return jblk.smooth_vector(jp, u, 4.0)
    if name == "si_alpha":
        K = jblk.apply_bc_matrix(jp, jblk.assemble_matrix(
            jp, jasm.local_stiffness(area, grads).reshape(blocks, C, 3, 3)))
        return jblk.si_alpha(jp, K, u)
    if name == "rv_linear":
        return jblk.rv_epsilon_linear(
            jp, 0.25, 1.0, u, u, jnp.linalg.norm(jnp.asarray(f["w"]),
                                                 axis=1),
            jnp.asarray(f["rh"]), jnp.asarray(f["h"]))
    if name == "rv_cell_max":
        wn = jnp.linalg.norm(jnp.asarray(f["w"]), axis=1)
        beta = jblk.gather_components(jp, wn).max(axis=1)
        return jblk.rv_epsilon_cell_max(jp, 0.25, 1.0, jnp.asarray(f["rh"]),
                                        beta, jnp.ones(jp.n, bool))
    raise KeyError(name)


def _port_case(name, tm, tp, f):
    x, u, eps = (_t(f[k]) for k in ("x", "u", "eps"))
    m = tp.mesh
    mass = tblk.assemble_matrix(tp, tblk.mass_locals_components(tp))
    flux = tkpp.FLUX
    if name == "spmv_mass":
        return tblk.spmv(tp, mass, x)
    if name == "diag_mass":
        return tblk.diag_of(tp, mass)
    if name == "stiffness_bc":
        K = tblk.assemble_matrix(tp, tasm.local_stiffness(m.area, m.grads))
        return tblk.constrained_matvec(tp, tblk.apply_bc_matrix(tp, K), x)
    if name == "scatter":
        return tblk.scatter_components(tp, tblk.gather_components(tp, x))
    if name == "conv_rhs":
        return tblk.conv_rhs_components(tp, u, flux)
    if name == "conv_plus_keps":
        return tblk.conv_plus_locals_rhs_components(tp, u, flux, eps)
    if name == "keps":
        return tblk.spmv(tp, tblk.assemble_matrix(
            tp, tblk.eps_locals_components(tp, eps)), x)
    if name == "newton_jacobian":
        J = tblk.assemble_matrix(tp, tblk.newton_locals(tp, u, eps, 0.005,
                                                        flux))
        return torch.cat([tblk.spmv(tp, J, x), tblk.diag_of(tp, J)])
    if name in ("local_apply", "local_diag"):
        L = tasm.local_mass(m.area)
        return (tblk.local_apply(tp, L, x) if name == "local_apply"
                else tblk.local_diag(tp, L))
    if name == "patch_sum":
        return tblk.patch_sum(tp, x)
    if name == "smooth":
        return tblk.smooth_vector(tp, u, 4.0)
    if name == "si_alpha":
        K = tblk.apply_bc_matrix(tp, tblk.assemble_matrix(
            tp, tasm.local_stiffness(m.area, m.grads)))
        return tblk.si_alpha(tp, K, u)
    if name == "rv_linear":
        return tblk.rv_epsilon_linear(tp, 0.25, 1.0, u, u,
                                      torch.linalg.norm(_t(f["w"]), dim=1),
                                      _t(f["rh"]), _t(f["h"]))
    if name == "rv_cell_max":
        wn = torch.linalg.norm(_t(f["w"]), dim=1)
        beta = tblk.gather_components(tp, wn).amax(dim=1)
        return tblk.rv_epsilon_cell_max(tp, 0.25, 1.0, _t(f["rh"]), beta,
                                        torch.ones(tp.n, dtype=torch.bool))
    raise KeyError(name)


CASES = ("spmv_mass", "diag_mass", "stiffness_bc", "scatter", "conv_rhs",
         "conv_plus_keps", "keps", "newton_jacobian", "local_apply",
         "local_diag", "patch_sum", "smooth", "si_alpha", "rv_linear",
         "rv_cell_max")


@pytest.mark.parametrize("name", CASES)
def test_blocked_op_matches_jax(rect, name):
    jm, jp, tm, tp, f = rect
    want = np.asarray(_jax_case(name, jm, jp, f))
    got = _port_case(name, tm, tp, f).numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= TOL * scale, name


@pytest.mark.parametrize("flux", ["kpp", "burgers"])
@pytest.mark.parametrize("precise", [False, True])
def test_rv_epsilon_nonlinear_matches_jax(rect, flux, precise):
    jm, jp, tm, tp, f = rect
    jnorm = (jkpp.flux_prime_norm if flux == "kpp"
             else jburgers.flux_prime_norm)
    tflux = tkpp.FLUX if flux == "kpp" else tburgers.FLUX
    u = f["u"] if flux == "kpp" else f["x"]
    want = jblk.rv_epsilon_nonlinear(
        jp, 0.5, 4.0, jnp.asarray(u), jnp.asarray(u[::-1].copy()), jnorm,
        jnp.asarray(f["rh"]), jnp.asarray(f["h"]), precise=precise)
    got = tblk.rv_epsilon_nonlinear(
        tp, 0.5, 4.0, _t(u), _t(u[::-1].copy()), tflux, _t(f["rh"]),
        _t(f["h"]), precise=precise)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def test_tiled_rv_epsilon_skips_phantom_slots(tiled):
    """The tiled plan's RV with its row_valid: phantom slots out of the
    mean and max and eps 0 on them, as in the JAX package."""
    (mt, _), (mjt, _) = tiled[2], tiled[3]
    jp = jblk.make_tiled_plan(mjt, dtype=jnp.float64)
    tp = tblk.make_tiled_plan(mt, dtype=F64, device="cpu")
    rng = np.random.default_rng(1)
    u, rh, h = (rng.uniform(0.5, 11.0, mt.n_nodes),
                rng.standard_normal(mt.n_nodes),
                rng.uniform(0.05, 0.1, mt.n_nodes))
    want = jblk.rv_epsilon_nonlinear(
        jp, 0.5, 4.0, jnp.asarray(u), jnp.asarray(u), jkpp.flux_prime_norm,
        jnp.asarray(rh), jnp.asarray(h), valid=jp.row_valid)
    got = tblk.rv_epsilon_nonlinear(tp, 0.5, 4.0, _t(u), _t(u), tkpp.FLUX,
                                    _t(rh), _t(h), valid=tp.row_valid)
    assert np.isfinite(got.numpy()).all()
    assert (got.numpy()[~mt.slot_valid] == 0).all()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def _port_patch_widths():
    """The K of the ELL structures the port builds: P1 on irregular,
    rectangle and disk meshes; the P2 and P3 spaces on them at mesh 4 and
    16."""
    from conservation_fem_tpu_torch.ops import spaces

    ks = {tmesh.irregular_mesh((-2, -2), (2, 2), nx=nx, seed=1).max_patch
          for nx in (8, 20)}
    ks |= {tmesh.rectangle_mesh((-2, -2), (2, 2), nx=8).max_patch,
           tmesh.disk_mesh(1 / 8).max_patch}
    for degree in (2, 3):
        for ms in (4, 16):
            for host in (tmesh.rectangle_mesh((-2, -2), (2, 2), nx=ms),
                         tmesh.irregular_mesh(nx=ms, seed=2),
                         tmesh.disk_mesh(1 / ms)):
                ks.add(spaces.build_space(host, degree).patch_cols.shape[1])
    return sorted(ks)


# the port's widths (and 11, that of the anchored meshes irr140 ... irr640),
# with even ones and wide ones beside them (a tile narrowed below
# TILE_ROWS)
SPMV_WIDTHS = sorted(set(_port_patch_widths()) | {11}) + [8, 10, 12, 20, 38,
                                                         64, 100]
SPMV_ROWS = (1, 31, 128, 1681, 19881, 410881)


@pytest.mark.parametrize("colsize", [4, 2], ids=["int32", "int16"])
@pytest.mark.parametrize("itemsize", [0, 4, 8])
@pytest.mark.parametrize("K", SPMV_WIDTHS)
def test_spmv_tile_plan(K, itemsize, colsize):
    """The tile plan of kernels A and D (csrc/ell.cu ell_tile_walk) for
    every width the port builds, A's f32 and f64 values and D's none
    (itemsize 0), int32 columns and int16 codes (odd K alone): two stages
    within shared memory, the bulk copies' sizes and every tile's source
    offsets on 16 bytes, a row stride that starts the threads' rows in
    different banks, and the rows after the whole tiles (read by the last
    CTA) fewer than a tile."""
    assert {7, 9, 19, 37} <= set(SPMV_WIDTHS)
    if colsize == 2 and K % 2 == 0:
        with pytest.raises(ValueError):
            ek.tile_plan(K, itemsize, colsize)
        return
    p = ek.tile_plan(K, itemsize, colsize)
    assert p.smem <= ek.SMEM_CAP
    assert p.smem == 16 + 2 * p.rows * p.stride * (itemsize + colsize)
    assert ek.TILE_MIN_ROWS <= p.rows <= ek.TILE_ROWS
    assert p.rows % 8 == 0
    assert p.stride % 2 == 1 and p.stride - K in (0, 1)
    for n in SPMV_ROWS:
        tiles = n // p.rows
        if p.stride == K:  # a tile lands by one bulk copy an array
            for s in (itemsize, colsize):
                assert p.rows * K * s % ek.BULK_ALIGN == 0
                assert all(t * p.rows * K * s % ek.BULK_ALIGN == 0
                           for t in (1, tiles - 1, tiles))
            # the second stage and the columns start on 16 bytes
            assert (16 + p.rows * K * itemsize) % ek.BULK_ALIGN == 0
        assert 0 <= n - tiles * p.rows < p.rows
    with pytest.raises(ValueError):
        ek.tile_plan(4001, itemsize, colsize)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_locals_tile_plan(itemsize):
    """Kernel C's tiles: shared memory within the limit, each tile's
    input ranges (3 int32 nodes, an area, 6 gradients a cell) and output
    ranges (3 and 9 locals) on 16 bytes, the cells after the whole tiles
    fewer than a tile."""
    c = ek.LOCALS_CELLS
    smem = ek.locals_smem(itemsize)
    assert smem == 16 + 2 * c * (12 + 7 * itemsize) + 12 * c * itemsize
    assert smem <= ek.SMEM_CAP
    for size in (12 * c, c * itemsize, 6 * c * itemsize,
                 3 * c * itemsize, 9 * c * itemsize):
        assert size % ek.BULK_ALIGN == 0
    # the output tile follows the stages on 16 bytes
    assert (16 + 2 * c * (12 + 7 * itemsize)) % ek.BULK_ALIGN == 0
    for M in (1, 72, 128, 3362, 819200):
        assert 0 <= M - M // c * c < c


@pytest.mark.parametrize("space", ["p1", "p2"])
def test_bc_flagged_columns_decode(space):
    """with_kernel_index's column copies for kernel A decode to
    patch_cols32 and flag exactly the boundary columns: the int32 copy
    as ~j, the int16 codes as 2 (j - i) + bc[j]; a mesh whose patches
    reach D16_REACH rows or more gets no int16 codes."""
    from conservation_fem_tpu_torch.ops import spaces

    host = tmesh.irregular_mesh((-2, -2), (2, 2), nx=12, seed=3)
    arrays = (host.device_arrays(F64, "cpu") if space == "p1" else
              spaces.build_space(host, 2).device_arrays(F64, "cpu"))
    m = tmesh.with_kernel_index(arrays)
    on_bc = m.boundary_mask[m.patch_cols]
    c = m.patch_cols_bc32
    assert c.dtype == torch.int32 and c.shape == m.patch_cols32.shape
    assert torch.equal(torch.where(c < 0, ~c, c), m.patch_cols32)
    assert torch.equal(c < 0, on_bc)
    assert bool(on_bc.any()) and not bool(on_bc.all())
    d = m.patch_cols_d16
    assert d.dtype == torch.int16 and d.shape == c.shape
    rows = torch.arange(d.shape[0])[:, None]
    assert torch.equal(rows + (d.long() >> 1), m.patch_cols32.long())
    assert torch.equal((d & 1).bool(), on_bc)
    far = tmesh.with_kernel_index(arrays._replace(
        patch_cols=torch.where(rows == 0, tmesh.D16_REACH, arrays.patch_cols),
        boundary_mask=torch.cat([arrays.boundary_mask,
                                 torch.zeros(tmesh.D16_REACH + 1 - len(
                                     arrays.boundary_mask), dtype=torch.bool)
                                 ])))
    assert far.patch_cols_d16 is None
