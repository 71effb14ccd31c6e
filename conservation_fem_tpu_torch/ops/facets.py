"""Boundary facet (edge) integration data of Pk spaces, ported from
conservation_fem_tpu/ops/facets.py (host numpy).

The IPCS step of models/stokes.py integrates over the whole boundary
(int p n . v ds and int mu grad(U) n . v ds). For each boundary edge this
records its one adjacent cell, the edge's local index in that cell, its
length and outward normal; the basis values and reference gradients are
tabulated at the Gauss points of each of the three local reference
edges, so an edge integral assembles into the same cell-local
(nloc x nloc) blocks as a volume term.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from conservation_fem_tpu_torch.ops.spaces import FunctionSpace, tabulate_basis

# 3-point Gauss-Legendre on [0,1] (exact to degree 5)
_GAUSS_X = np.array([0.5 - np.sqrt(15) / 10, 0.5, 0.5 + np.sqrt(15) / 10])
_GAUSS_W = np.array([5 / 18, 8 / 18, 5 / 18])

# local edges of the reference triangle in spaces.py ordering
_LOCAL_EDGES = [(0, 1), (1, 2), (2, 0)]
_REF_VERTS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


class FacetData(NamedTuple):
    edge_cell: np.ndarray     # (nb,) adjacent cell index
    local_edge: np.ndarray    # (nb,) 0..2
    length: np.ndarray        # (nb,)
    normal: np.ndarray        # (nb,2) outward unit normal
    w1d: np.ndarray           # (Q,) Gauss weights on [0,1]
    phi_edge: np.ndarray      # (3,Q,nloc) basis values at edge points
    dphi_edge: np.ndarray     # (3,Q,nloc,2) reference gradients at edge pts


def boundary_facet_data(space: FunctionSpace) -> FacetData:
    mesh = space.mesh
    cells = mesh.cells.astype(np.int64)
    M = cells.shape[0]
    edges_all = np.concatenate(
        [cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=0
    )
    owner_cell = np.tile(np.arange(M), 3)
    owner_local = np.repeat(np.arange(3), M)
    edges_sorted = np.sort(edges_all, axis=1)
    uniq, inv, counts = np.unique(
        edges_sorted, axis=0, return_inverse=True, return_counts=True
    )
    bnd = counts[inv] == 1
    edge_cell = owner_cell[bnd]
    local_edge = owner_local[bnd]
    va = edges_all[bnd, 0]
    vb = edges_all[bnd, 1]
    pa, pb = mesh.points[va], mesh.points[vb]
    tangent = pb - pa
    length = np.linalg.norm(tangent, axis=1)
    # outward normal: perpendicular to the edge pointing away from the
    # opposite vertex of the owning cell
    n = np.stack([tangent[:, 1], -tangent[:, 0]], axis=1) / length[:, None]
    opp_local = np.array([2, 0, 1])[local_edge]     # vertex not on the edge
    pc = mesh.points[cells[edge_cell, opp_local]]
    flip = ((0.5 * (pa + pb) - pc) * n).sum(axis=1) < 0
    n[flip] *= -1.0

    # tabulate basis at Gauss points of each local reference edge
    k = space.degree
    phi_e, dphi_e = [], []
    for (a, b) in _LOCAL_EDGES:
        pts = (
            _REF_VERTS[a][None, :] * (1 - _GAUSS_X[:, None])
            + _REF_VERTS[b][None, :] * _GAUSS_X[:, None]
        )
        phi, dphi = tabulate_basis(k, pts)
        phi_e.append(phi)
        dphi_e.append(dphi)
    return FacetData(
        edge_cell=edge_cell,
        local_edge=local_edge,
        length=length,
        normal=n,
        w1d=_GAUSS_W.copy(),
        phi_edge=np.stack(phi_e),
        dphi_edge=np.stack(dphi_e),
    )
