"""Pk Lagrange function spaces (k = 1, 2, 3) on triangle meshes, the port
of conservation_fem_tpu/ops/spaces.py (its host half is numpy, copied
here; ``device_arrays`` ships it as tensors).

A FunctionSpace is host arrays:
  * dof_coords (ndof,2), cell_dofs (M,nloc) with nloc = (k+1)(k+2)/2;
  * the dof numbering, the JAX package's integer for integer: vertex dofs
    first (= the mesh's vertex ids), then k-1 dofs per unique edge in the
    order of np.unique of the sorted edges (lexicographic), each edge's
    dofs running from its lower- to its higher-numbered vertex (cells that
    traverse an edge backwards see them reversed), then the cell-interior
    dofs, cell by cell;
  * the boundary dof mask (boundary vertices and the dofs of boundary
    edges);
  * the ELL dof adjacency (patches) and the sorted scatter orderings, built
    as ops/mesh.py builds them for P1;
  * the reference basis tabulated at the points of a Dunavant rule exact
    to degree 2k, by monomial Vandermonde inversion in f64.

Geometry is isoparametric per quadrature point (``jinv_t_q``, ``detj_q``):
on straight cells it equals the affine map; with a ``boundary_projector``
the boundary dofs are snapped onto the true boundary and the boundary
cells curve.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device

from conservation_fem_tpu_torch.ops.mesh import (Mesh, _build_cell_slots,
                                                 _build_patches,
                                                 _scatter_orderings,
                                                 rcm_from_connectivity)

# Dunavant rules on the reference triangle {x >= 0, y >= 0, x + y <= 1},
# weights scaled to sum to 0.5 (the reference triangle's area)
_RULES = {}


def _rule(points, weights):
    w = np.asarray(weights, dtype=np.float64)
    p = np.asarray(points, dtype=np.float64)
    return p, w / w.sum() * 0.5


# degree 2 (3 points)
_RULES[2] = _rule(
    [[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]], [1, 1, 1])
# degree 4 (6 points)
_a1, _b1 = 0.445948490915965, 0.108103018168070
_a2, _b2 = 0.091576213509771, 0.816847572980459
_RULES[4] = _rule(
    [[_a1, _a1], [_b1, _a1], [_a1, _b1], [_a2, _a2], [_b2, _a2], [_a2, _b2]],
    [0.223381589678011] * 3 + [0.109951743655322] * 3)
# degree 6 (12 points)
_c1 = 0.063089014491502
_c2 = 0.249286745170910
_c3a, _c3b = 0.053145049844817, 0.310352451033784
_RULES[6] = _rule(
    [
        [_c1, _c1], [1 - 2 * _c1, _c1], [_c1, 1 - 2 * _c1],
        [_c2, _c2], [1 - 2 * _c2, _c2], [_c2, 1 - 2 * _c2],
        [_c3a, _c3b], [_c3b, _c3a],
        [1 - _c3a - _c3b, _c3a], [1 - _c3a - _c3b, _c3b],
        [_c3a, 1 - _c3a - _c3b], [_c3b, 1 - _c3a - _c3b],
    ],
    [0.050844906370207] * 3 + [0.116786275726379] * 3
    + [0.082851075618374] * 6)


def quadrature(exactness: int):
    """(points (Q,2), weights (Q,)): the smallest stored rule exact to at
    least the requested degree (the largest where none is)."""
    for d in sorted(_RULES):
        if d >= exactness:
            return _RULES[d]
    return _RULES[max(_RULES)]


def reference_lattice(k: int):
    """Lagrange nodes of the reference triangle in the canonical order: 3
    vertices, then the edges (v0-v1, v1-v2, v2-v0) with k-1 points each
    along the edge, then the interior lattice points."""
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    pts = [verts[0], verts[1], verts[2]]
    for a, b in ((0, 1), (1, 2), (2, 0)):
        for i in range(1, k):
            pts.append(verts[a] + (verts[b] - verts[a]) * i / k)
    for j in range(1, k):
        for i in range(1, k - j):
            pts.append(np.array([i / k, j / k]))
    return np.asarray(pts)


def _monomials(pts, k):
    """All monomials x^a y^b, a + b <= k, at pts (n,2) -> (n, nloc)."""
    x, y = pts[:, 0], pts[:, 1]
    cols = [x**a * y**b for a in range(k + 1) for b in range(k + 1 - a)]
    return np.stack(cols, axis=1)


def _monomial_grads(pts, k):
    x, y = pts[:, 0], pts[:, 1]
    dx, dy = [], []
    for a in range(k + 1):
        for b in range(k + 1 - a):
            dx.append(a * x ** max(a - 1, 0) * y**b if a > 0 else 0 * x)
            dy.append(b * x**a * y ** max(b - 1, 0) if b > 0 else 0 * x)
    return np.stack(dx, axis=1), np.stack(dy, axis=1)


def tabulate_basis(k: int, pts):
    """(phi (n,nloc), dphi (n,nloc,2)) of the Pk Lagrange basis at pts."""
    C = np.linalg.inv(_monomials(reference_lattice(k), k))  # column j: basis j
    phi = _monomials(pts, k) @ C
    gx, gy = _monomial_grads(pts, k)
    return phi, np.stack([gx @ C, gy @ C], axis=2)


def _build_adjacency(ndof: int, cell_dofs: np.ndarray):
    """(patch_cols, patch_mask, diag_slot, K) of the dof adjacency: each
    row's columns sorted, padded with the row index (ops/mesh.py's P1
    patches, on (M,nloc) connectivity)."""
    return _build_patches(ndof, np.asarray(cell_dofs, dtype=np.int64))


class SpaceArrays(NamedTuple):
    """A FunctionSpace as tensors on one device, read by assembly_pk and,
    duck-typed as a mesh, by the ELL products, the bc helpers and the
    stabilisation kernels (patch_cols, patch_mask, diag_slot,
    boundary_mask, the scatter orderings). Float fields in the compute
    dtype, index fields int64."""

    degree: int
    dof_coords: torch.Tensor     # (ndof,2)
    cell_dofs: torch.Tensor      # (M,nloc)
    boundary_mask: torch.Tensor  # (ndof,) bool
    patch_cols: torch.Tensor     # (ndof,K)
    patch_mask: torch.Tensor     # (ndof,K) bool
    diag_slot: torch.Tensor      # (ndof,)
    mat_perm: torch.Tensor
    mat_segs: torch.Tensor
    vec_perm: torch.Tensor
    vec_segs: torch.Tensor
    mat_lens: torch.Tensor       # (ndof*K,) sorted segment lengths
    vec_lens: torch.Tensor       # (ndof,)
    area: torch.Tensor           # (M,)
    jinv_t: torch.Tensor         # (M,2,2) affine J^{-T}
    cell_p0: torch.Tensor        # (M,2) first vertex (affine map offset)
    cell_e1: torch.Tensor        # (M,2) edge vectors (affine map columns)
    cell_e2: torch.Tensor        # (M,2)
    quad_pts: torch.Tensor       # (Q,2) reference coordinates
    quad_w: torch.Tensor         # (Q,) sums to 0.5
    phi: torch.Tensor            # (Q,nloc)
    dphi: torch.Tensor           # (Q,nloc,2)
    h_cell: torch.Tensor         # (M,)
    jinv_t_q: torch.Tensor       # (M,Q,2,2) isoparametric J^{-T}
    detj_q: torch.Tensor         # (M,Q) |det J|: dx = detj_q dxi
    # int32 copies for the hand-written ELL kernels (ops/mesh.
    # with_kernel_index; None on the gather path)
    patch_cols32: torch.Tensor | None = None
    patch_cols_bc32: torch.Tensor | None = None
    patch_cols_d16: torch.Tensor | None = None
    mat_perm32: torch.Tensor | None = None
    mat_off8: torch.Tensor | None = None
    mat_base32: torch.Tensor | None = None
    mat_tile32: torch.Tensor | None = None
    vec_perm32: torch.Tensor | None = None
    vec_off8: torch.Tensor | None = None
    vec_base32: torch.Tensor | None = None
    vec_tile32: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True, eq=False)
class FunctionSpace:
    mesh: Mesh
    degree: int
    dof_coords: np.ndarray     # (ndof,2)
    cell_dofs: np.ndarray      # (M,nloc) i64
    boundary_mask: np.ndarray  # (ndof,)
    patch_cols: np.ndarray
    patch_mask: np.ndarray
    diag_slot: np.ndarray
    cell_slots: np.ndarray     # (M,nloc,nloc)
    mat_perm: np.ndarray
    mat_segs: np.ndarray
    vec_perm: np.ndarray
    vec_segs: np.ndarray
    quad_pts: np.ndarray       # (Q,2)
    quad_w: np.ndarray         # (Q,) sums to 0.5
    phi: np.ndarray            # (Q,nloc)
    dphi: np.ndarray           # (Q,nloc,2)

    @property
    def ndof(self) -> int:
        return self.dof_coords.shape[0]

    @property
    def nloc(self) -> int:
        return self.cell_dofs.shape[1]

    def device_arrays(self, dtype=torch.float64, device=None) -> SpaceArrays:
        """The space as tensors on ``device`` (None: the card, raising
        without one; "cpu" for the CPU), floats in ``dtype`` (the
        geometry formed in f64 on the host, then cast)."""
        device = get_device(device)
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                      device=device)
        i = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64,
                                      device=device)
        jinv_t_q, detj_q = self._geometry_q()
        host = self.mesh
        pts, cells = host.points, host.cells
        n, K = self.patch_cols.shape
        return SpaceArrays(
            degree=self.degree,
            dof_coords=f(self.dof_coords), cell_dofs=i(self.cell_dofs),
            boundary_mask=torch.as_tensor(self.boundary_mask, device=device),
            patch_cols=i(self.patch_cols),
            patch_mask=torch.as_tensor(self.patch_mask, device=device),
            diag_slot=i(self.diag_slot),
            mat_perm=i(self.mat_perm), mat_segs=i(self.mat_segs),
            vec_perm=i(self.vec_perm), vec_segs=i(self.vec_segs),
            mat_lens=i(np.bincount(self.mat_segs, minlength=n * K)),
            vec_lens=i(np.bincount(self.vec_segs, minlength=n)),
            area=f(host.area), jinv_t=f(self._jinv_t()),
            cell_p0=f(pts[cells[:, 0]]),
            cell_e1=f(pts[cells[:, 1]] - pts[cells[:, 0]]),
            cell_e2=f(pts[cells[:, 2]] - pts[cells[:, 0]]),
            quad_pts=f(self.quad_pts), quad_w=f(self.quad_w),
            phi=f(self.phi), dphi=f(self.dphi), h_cell=f(host.h_cell),
            jinv_t_q=f(jinv_t_q), detj_q=f(detj_q))

    def _geometry_q(self):
        """(jinv_t_q (M,Q,2,2), detj_q (M,Q)): the isoparametric map x(xi)
        = sum_c phi_c(xi) X_c, X_c the (possibly boundary-projected) dof
        coordinates, at every quadrature point. The weight is |det J|, so
        clockwise cells assemble with the right sign; the signed det stays
        in J^{-T}."""
        X = self.dof_coords[self.cell_dofs]            # (M,nloc,2)
        J = np.einsum("mcd,qce->mqde", X, self.dphi)   # d x_d / d xi_e
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        if np.any(det == 0.0):
            raise ValueError("degenerate cell: zero Jacobian at a quad point")
        jinv_t = np.empty_like(J)
        jinv_t[..., 0, 0] = J[..., 1, 1]
        jinv_t[..., 0, 1] = -J[..., 1, 0]
        jinv_t[..., 1, 0] = -J[..., 0, 1]
        jinv_t[..., 1, 1] = J[..., 0, 0]
        return jinv_t / det[..., None, None], np.abs(det)

    def _jinv_t(self):
        """Per-cell affine J^{-T} (M,2,2)."""
        host = self.mesh
        p = host.points[host.cells[:, :3]]
        e1 = p[:, 1] - p[:, 0]
        e2 = p[:, 2] - p[:, 0]
        det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        # J = [[e1x, e2x], [e1y, e2y]]; J^{-T} = [[e2y, -e1y], [-e2x, e1x]]/det
        jinv_t = np.empty((p.shape[0], 2, 2))
        jinv_t[:, 0, 0] = e2[:, 1]
        jinv_t[:, 0, 1] = -e1[:, 1]
        jinv_t[:, 1, 0] = -e2[:, 0]
        jinv_t[:, 1, 1] = e1[:, 0]
        return jinv_t / det[:, None, None]


def _boundary_edge_dofs(n_vert, bnd_edge, k):
    """Ids of the dofs on the boundary edges (bnd_edge: mask over the
    unique edges)."""
    ids = np.nonzero(bnd_edge)[0] * (k - 1)
    return np.concatenate([n_vert + ids + (e - 1) for e in range(1, k)])


def build_space(mesh: Mesh, degree: int, quad_exactness: int | None = None,
                boundary_projector=None) -> FunctionSpace:
    """The Pk space on ``mesh``. boundary_projector: optional (n,2) ->
    (n,2) map onto the true curved boundary (p / |p| for the unit disk):
    with degree >= 2 the boundary dofs are projected and the boundary
    cells' geometry becomes isoparametric; straight interior cells keep
    the affine geometry exactly."""
    if degree not in (1, 2, 3):
        raise ValueError("degree must be 1, 2 or 3")
    if degree >= 2 and mesh.periodic:
        raise NotImplementedError(
            "Pk spaces on a make_periodic mesh: edge and interior dof "
            "coordinates and the cell geometry are recomputed from "
            "points[cells], which is wrong on seam cells; build the space "
            "on the unfolded mesh and identify the periodic dofs instead")
    k = degree
    cells = mesh.cells.astype(np.int64)
    n_vert = mesh.points.shape[0]
    M = cells.shape[0]
    nloc = (k + 1) * (k + 2) // 2

    # unique edges (lexicographic, the JAX package's np.unique(axis=0))
    edges_sorted = np.sort(np.concatenate(
        [cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=0),
        axis=1)
    uniq_edges, edge_ids, counts = np.unique(
        edges_sorted, axis=0, return_inverse=True, return_counts=True)
    n_edge = uniq_edges.shape[0]
    edge_ids = edge_ids.reshape(3, M).T        # (M,3): local edge -> edge id
    n_edge_dofs = (k - 1) * n_edge
    n_int = (k - 1) * (k - 2) // 2
    ndof = n_vert + n_edge_dofs + n_int * M

    dof_coords = np.empty((ndof, 2))
    dof_coords[:n_vert] = mesh.points
    for e in range(1, k):
        frac = e / k
        idx = n_vert + np.arange(n_edge) * (k - 1) + (e - 1)
        dof_coords[idx] = (mesh.points[uniq_edges[:, 0]] * (1 - frac)
                           + mesh.points[uniq_edges[:, 1]] * frac)
    if n_int:
        lat = reference_lattice(k)[3 + 3 * (k - 1):]       # (n_int,2)
        p0 = mesh.points[cells[:, 0]]
        e1 = mesh.points[cells[:, 1]] - p0
        e2 = mesh.points[cells[:, 2]] - p0
        for j, (lx, ly) in enumerate(lat):
            idx = n_vert + n_edge_dofs + np.arange(M) * n_int + j
            dof_coords[idx] = p0 + lx * e1 + ly * e2

    # cell_dofs in the canonical local order
    cell_dofs = np.empty((M, nloc), dtype=np.int64)
    cell_dofs[:, :3] = cells
    col = 3
    for le, (a, b) in enumerate(((0, 1), (1, 2), (2, 0))):
        eid = edge_ids[:, le]
        forward = cells[:, a] == uniq_edges[eid, 0]
        base = n_vert + eid * (k - 1)
        for e in range(1, k):
            cell_dofs[:, col] = np.where(forward, base + (e - 1),
                                         base + (k - 1 - e))
            col += 1
    for j in range(n_int):
        cell_dofs[:, col] = n_vert + n_edge_dofs + np.arange(M) * n_int + j
        col += 1

    boundary_mask = np.zeros(ndof, dtype=bool)
    boundary_mask[:n_vert] = mesh.boundary_mask
    if k > 1:
        boundary_mask[_boundary_edge_dofs(n_vert, counts == 1, k)] = True
    if boundary_projector is not None and k >= 2:
        dof_coords[boundary_mask] = boundary_projector(
            dof_coords[boundary_mask])

    qp, qw = quadrature(quad_exactness or 2 * k)
    phi, dphi = tabulate_basis(k, qp)
    return _finalize_space(mesh, k, dof_coords, cell_dofs, boundary_mask,
                           qp, qw, phi, dphi)


def _finalize_space(mesh, k, dof_coords, cell_dofs, boundary_mask,
                    qp, qw, phi, dphi) -> FunctionSpace:
    """Adjacency, cell slots and scatter orderings from the dof map
    (shared by build_space and permute_dofs)."""
    ndof = dof_coords.shape[0]
    patch_cols, patch_mask, diag_slot, K = _build_adjacency(ndof, cell_dofs)
    cell_slots = _build_cell_slots(cell_dofs, patch_cols, patch_mask)
    mat_perm, mat_segs, vec_perm, vec_segs = _scatter_orderings(
        cell_dofs, cell_slots, K)
    return FunctionSpace(
        mesh=mesh, degree=k, dof_coords=dof_coords, cell_dofs=cell_dofs,
        boundary_mask=boundary_mask, patch_cols=patch_cols,
        patch_mask=patch_mask, diag_slot=diag_slot, cell_slots=cell_slots,
        mat_perm=mat_perm, mat_segs=mat_segs, vec_perm=vec_perm,
        vec_segs=vec_segs, quad_pts=qp, quad_w=qw, phi=phi, dphi=dphi)


def rcm_dof_permutation(space: FunctionSpace) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (old -> new) of the dof adjacency
    graph (scipy's, as the JAX package's rcm_dof_permutation)."""
    return rcm_from_connectivity(space.ndof, space.cell_dofs)


def permute_dofs(space: FunctionSpace, perm: np.ndarray) -> FunctionSpace:
    """Renumber the space's dofs by perm (old -> new), rebuilding the
    adjacency and scatter orderings; cell-indexed data is unchanged."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return _finalize_space(
        space.mesh, space.degree, space.dof_coords[inv],
        perm[space.cell_dofs], space.boundary_mask[inv],
        space.quad_pts, space.quad_w, space.phi, space.dphi)
