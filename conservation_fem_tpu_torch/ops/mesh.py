"""Structured rectangle meshes (host-side numpy), ported from
conservation_fem_tpu/ops/mesh.py.

Only the fields the stencil path reads are kept: points, cells, the
boundary mask and the per-cell geometry. Node id = i * (ny+1) + j and the
cell order (all lower triangles, then all upper ones, "/" diagonal) are
the JAX package's, so fields and the committed anchors keep its flat
order. The ELL adjacency and scatter orderings of the JAX Mesh belong to
the unstructured backend, which this package does not have yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

Array = np.ndarray


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An immutable 2D triangle mesh (host numpy arrays)."""

    points: Array          # (N,2) f64
    cells: Array           # (M,3) i32
    boundary_mask: Array   # (N,) bool
    area: Array            # (M,) f64
    grads: Array           # (M,3,2) f64
    h_cell: Array          # (M,) f64

    @property
    def n_nodes(self) -> int:
        return self.points.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]


def _cell_geometry(points: Array, cells: Array):
    """Per-cell area, P1 physical basis gradients and min edge length.

    Reference P1 basis on the unit triangle: N0 = 1-x-y, N1 = x, N2 = y;
    grad N1 = (e2y, -e2x)/det, grad N2 = (-e1y, e1x)/det, grad N0 = -(sum).
    """
    p = points[cells]                      # (M,3,2)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    area = 0.5 * np.abs(det)
    if (area <= 0).any():
        raise ValueError("degenerate cell with non-positive area")
    g1 = np.stack([e2[:, 1], -e2[:, 0]], axis=1) / det[:, None]
    g2 = np.stack([-e1[:, 1], e1[:, 0]], axis=1) / det[:, None]
    g0 = -(g1 + g2)
    grads = np.stack([g0, g1, g2], axis=1)  # (M,3,2)
    l01 = np.linalg.norm(p[:, 0] - p[:, 1], axis=1)
    l02 = np.linalg.norm(p[:, 0] - p[:, 2], axis=1)
    l12 = np.linalg.norm(p[:, 1] - p[:, 2], axis=1)
    h_cell = np.minimum(np.minimum(l01, l02), l12)
    return area, grads, h_cell


def _boundary_mask(n_nodes: int, cells: Array) -> Array:
    """Nodes on edges that belong to exactly one cell."""
    edges = np.concatenate(
        [cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=0)
    edges = np.sort(edges, axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    mask = np.zeros(n_nodes, dtype=bool)
    mask[uniq[counts == 1].ravel()] = True
    return mask


def _grid(p0, p1, nx, ny):
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)
    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    vid = lambda i, j: i * (ny + 1) + j
    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)
    tris = np.concatenate(
        [np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)],
        axis=0).astype(np.int64)
    return points, tris


def rectangle_mesh(p0=(0.0, 0.0), p1=(1.0, 1.0), nx: int = 8,
                   ny: int | None = None) -> Mesh:
    """Structured "/"-diagonal triangulation (JAX ``rectangle_mesh`` with
    diagonal='right'): per-cell geometry and the edge-count boundary mask
    computed for every cell."""
    if ny is None:
        ny = nx
    points, tris = _grid(p0, p1, nx, ny)
    area, grads, h_cell = _cell_geometry(points, tris)
    return Mesh(points=points, cells=tris.astype(np.int32),
                boundary_mask=_boundary_mask(points.shape[0], tris),
                area=area, grads=grads, h_cell=h_cell)


def rectangle_mesh_lean(p0=(0.0, 0.0), p1=(1.0, 1.0), nx: int = 8,
                        ny: int | None = None) -> Mesh:
    """rectangle_mesh in O(N) host memory: the geometry of the two exemplar
    cells (first lower, first upper) is broadcast and the boundary mask is
    the grid frame. Values are identical to rectangle_mesh."""
    if ny is None:
        ny = nx
    points, tris = _grid(p0, p1, nx, ny)
    area0, grads2, h0 = _cell_geometry(points, tris[[0, nx * ny]])
    M = tris.shape[0]
    grads = np.concatenate([
        np.broadcast_to(grads2[0][None], (nx * ny, 3, 2)),
        np.broadcast_to(grads2[1][None], (nx * ny, 3, 2))])
    bnd = np.zeros((nx + 1, ny + 1), dtype=bool)
    bnd[0, :] = bnd[-1, :] = True
    bnd[:, 0] = bnd[:, -1] = True
    return Mesh(points=points, cells=tris.astype(np.int32),
                boundary_mask=bnd.reshape(-1),
                area=np.broadcast_to(area0[:1], (M,)), grads=grads,
                h_cell=np.broadcast_to(h0[:1], (M,)))
