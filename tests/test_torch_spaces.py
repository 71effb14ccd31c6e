"""The port's Pk spaces (ops/spaces.py) and make_periodic against the JAX
package's, on the CPU: the quadrature rules, the tabulated basis, every
host array of build_space for k = 1, 2, 3 on a rectangle and on
disk_mesh(1/4) (the dof numbering integer for integer), the isoparametric
geometry with a curved boundary, rcm_dof_permutation and permute_dofs.
The host halves are the same numpy code, so equality is exact except
where f64 tensors are compared with the JAX arrays (1e-15)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.ops import spaces as jsp
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import spaces as tsp

HOST_FIELDS = ("dof_coords", "cell_dofs", "boundary_mask", "patch_cols",
               "patch_mask", "diag_slot", "cell_slots", "mat_perm",
               "mat_segs", "vec_perm", "vec_segs", "quad_pts", "quad_w",
               "phi", "dphi")
MESHES = {
    "rect": (lambda m: m.rectangle_mesh((0, 0), (1, 2), nx=3, ny=4)),
    "disk": (lambda m: m.disk_mesh(1 / 4)),
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


def _disk_projector(p):
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def _pair(mesh, k, **kw):
    return (jsp.build_space(MESHES[mesh](jmesh), k, **kw),
            tsp.build_space(MESHES[mesh](tmesh), k, **kw))


@pytest.mark.parametrize("exactness", [1, 2, 3, 4, 5, 6, 7])
def test_quadrature_rules_equal(exactness):
    pj, wj = jsp.quadrature(exactness)
    pt, wt = tsp.quadrature(exactness)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(wt, wj)
    assert abs(wt.sum() - 0.5) < 1e-15


@pytest.mark.parametrize("k", [1, 2, 3])
def test_tabulate_basis_equal_and_lagrange(k):
    rng = np.random.default_rng(k)
    pts = rng.uniform(0, 0.5, (7, 2))
    for a, b in zip(tsp.tabulate_basis(k, pts), jsp.tabulate_basis(k, pts)):
        np.testing.assert_array_equal(a, b)
    lat = tsp.reference_lattice(k)
    np.testing.assert_array_equal(lat, jsp.reference_lattice(k))
    phi, dphi = tsp.tabulate_basis(k, lat)
    np.testing.assert_allclose(phi, np.eye(len(lat)), atol=1e-12)
    # partition of unity: the gradients sum to zero
    np.testing.assert_allclose(dphi.sum(axis=1), 0.0, atol=1e-11)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_build_space_equals_jax(mesh, k):
    js, ts = _pair(mesh, k)
    assert (ts.ndof, ts.nloc, ts.degree) == (js.ndof, js.nloc, js.degree)
    for f in HOST_FIELDS:
        a, b = getattr(ts, f), getattr(js, f)
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_dof_numbering_layout():
    """Vertices first, then k-1 dofs per unique edge in lexicographic edge
    order, then the interior dofs cell by cell."""
    m = tmesh.disk_mesh(1 / 4)
    s = tsp.build_space(m, 3)
    n_vert, M = m.n_nodes, m.n_cells
    np.testing.assert_array_equal(s.cell_dofs[:, :3], m.cells)
    np.testing.assert_array_equal(s.dof_coords[:n_vert], m.points)
    edges = np.unique(np.sort(np.concatenate(
        [m.cells[:, [0, 1]], m.cells[:, [1, 2]], m.cells[:, [2, 0]]]),
        axis=1), axis=0)
    ed = s.dof_coords[n_vert:n_vert + 2 * len(edges)].reshape(-1, 2, 2)
    np.testing.assert_allclose(
        ed[:, 0], (2 * m.points[edges[:, 0]] + m.points[edges[:, 1]]) / 3,
        atol=1e-15)
    assert s.ndof == n_vert + 2 * len(edges) + M
    np.testing.assert_array_equal(s.cell_dofs[:, 9],
                                  n_vert + 2 * len(edges) + np.arange(M))


@pytest.mark.parametrize("k", [2, 3])
def test_isoparametric_geometry_equals_jax(k):
    js, ts = _pair("disk", k, boundary_projector=_disk_projector)
    np.testing.assert_array_equal(ts.dof_coords, js.dof_coords)
    bnd = ts.boundary_mask
    np.testing.assert_allclose(np.linalg.norm(ts.dof_coords[bnd], axis=1),
                               1.0, atol=1e-15)
    ja = js.device_arrays(jnp.float64)
    ta = ts.device_arrays(torch.float64, "cpu")
    for f in ("jinv_t_q", "detj_q", "jinv_t", "area", "cell_p0", "cell_e1",
              "cell_e2", "h_cell", "quad_w", "phi", "dphi", "dof_coords"):
        np.testing.assert_allclose(getattr(ta, f).numpy(),
                                   np.asarray(getattr(ja, f)), rtol=0,
                                   atol=1e-15, err_msg=f)
    for f in ("cell_dofs", "patch_cols", "diag_slot", "mat_perm",
              "vec_perm", "boundary_mask", "patch_mask"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), f)
    # the curved cells' geometry differs from the affine one; straight
    # interior cells keep it exactly
    detj_aff = 2.0 * ts.mesh.area
    curved = np.abs(ta.detj_q.numpy() - detj_aff[:, None]).max(axis=1)
    interior = ~bnd[ts.cell_dofs].any(axis=1)
    assert curved.max() > 1e-3 and curved[interior].max() < 1e-14
    # the sorted segment lengths the scatter takes
    assert int(ta.mat_lens.sum()) == ts.cell_dofs.shape[0] * ts.nloc**2
    assert ta.vec_lens.tolist() == np.bincount(ts.cell_dofs.ravel()).tolist()


@pytest.mark.parametrize("k", [2, 3])
def test_rcm_and_permute_dofs_equal_jax(k):
    js, ts = _pair("disk", k)
    perm = tsp.rcm_dof_permutation(ts)
    np.testing.assert_array_equal(perm, jsp.rcm_dof_permutation(js))
    pj, pt = jsp.permute_dofs(js, perm), tsp.permute_dofs(ts, perm)
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f), f)
    # bandwidth falls
    bw = lambda s: np.abs(s.patch_cols - np.arange(s.ndof)[:, None])[
        s.patch_mask].max()
    assert bw(pt) < bw(ts)


def test_make_periodic_equals_jax():
    jm = jmesh.make_periodic(jmesh.rectangle_mesh((0, 0), (1, 1), nx=4))
    tm = tmesh.make_periodic(tmesh.rectangle_mesh((0, 0), (1, 1), nx=4))
    assert tm.periodic and jm.periodic
    assert tm.n_nodes == 16 and not tm.boundary_mask.any()
    for f in ("points", "cells", "boundary_mask", "area", "grads", "h_cell",
              "patch_cols", "patch_mask", "diag_slot", "cell_slots",
              "mat_perm", "mat_segs", "vec_perm", "vec_segs"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), f)
    # one axis only: the y sides stay boundary
    jx = jmesh.make_periodic(jmesh.rectangle_mesh((0, 0), (1, 1), nx=4),
                             axes=(0,))
    tx = tmesh.make_periodic(tmesh.rectangle_mesh((0, 0), (1, 1), nx=4),
                             axes=(0,))
    np.testing.assert_array_equal(tx.boundary_mask, jx.boundary_mask)
    np.testing.assert_array_equal(tx.cells, jx.cells)


def test_make_periodic_refusals():
    tm = tmesh.make_periodic(tmesh.rectangle_mesh((0, 0), (1, 1), nx=4))
    with pytest.raises(NotImplementedError, match="make_periodic"):
        tsp.build_space(tm, 2)
    assert tsp.build_space(tm, 1).ndof == tm.n_nodes
    with pytest.raises(ValueError, match="no matching low-side node"):
        tmesh.make_periodic(tmesh.mesh_from_arrays(
            [[0, 0], [1, 0], [1, 1], [0, 0.5]], [[0, 1, 2], [0, 2, 3]]))
    with pytest.raises(ValueError, match="degree"):
        tsp.build_space(tmesh.disk_mesh(1 / 4), 4)
