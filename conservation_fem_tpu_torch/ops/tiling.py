"""The 2D tile-slot node layout of the blocked2d backend, ported from
conservation_fem_tpu/ops/tiling.py (host numpy, the same slot map bit for
bit: solutions of blocked2d live in slot numbering).

Layout ("equal-count kd tiles"): sort the nodes by y into S equal-count
strips, each strip by x into T tiles of exactly nb node slots (the strip's
tail padded with phantom slots). Tile (s, t) is block b = s T + t of the
blocked plan, and its graph neighbours lie in tiles (s + ds, t + dt), |ds|
<= 1, |dt| <= k. In the JAX package this bounds each block's dense window
at 3 (2k + 1) nb columns whatever N; the port applies its operators in ELL
form (ops/blocked.py), where the layout fixes the numbering, the phantom
slots and the coverage check the JAX plan makes.

Phantom slots join no cell; the padded mesh marks them as boundary nodes
(Dirichlet-pinned identity rows) and records them in ``Mesh.slot_valid``,
which keeps them out of the RV mean and max (``BlockedPlan.row_valid``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from conservation_fem_tpu_torch.ops.mesh import Mesh, mesh_from_arrays


def tile_layout(points, nb: int = 128, S: int | None = None):
    """Equal-count kd tile layout: (slot_of_node (n,) int64, n_slots, S,
    T); node i lives at row slot_of_node[i] of the padded S*T*nb slot
    space, and the slots no node takes are phantoms."""
    pts = np.asarray(points)
    n = pts.shape[0]
    nblocks = -(-n // nb)
    if S is None:
        S = max(1, int(round(np.sqrt(nblocks))))
    order_y = np.argsort(pts[:, 1], kind="stable")
    bounds = np.linspace(0, n, S + 1).round().astype(np.int64)
    max_strip = int((bounds[1:] - bounds[:-1]).max())
    T = -(-max_strip // nb)
    slot = np.empty(n, dtype=np.int64)
    for s in range(S):
        idx = order_y[bounds[s]:bounds[s + 1]]
        idx = idx[np.argsort(pts[idx, 0], kind="stable")]
        slot[idx] = s * T * nb + np.arange(len(idx))
    return slot, S * T * nb, S, T


def pad_mesh_to_slots(mesh: Mesh, slot_of_node, n_slots: int,
                      tile_T: int) -> Mesh:
    """``mesh`` rebuilt in the padded slot numbering: phantom slots take a
    copy of one real point (no cell reads it), are boundary nodes, and are
    False in ``slot_valid``; ``tile_T`` is the tile stride."""
    slot_of_node = np.asarray(slot_of_node, dtype=np.int64)
    valid = np.zeros(n_slots, dtype=bool)
    valid[slot_of_node] = True
    points = np.empty((n_slots, 2), dtype=np.float64)
    points[slot_of_node] = np.asarray(mesh.points)
    if (~valid).any():
        points[~valid] = points[slot_of_node[0]]
    cells = slot_of_node[np.asarray(mesh.cells, dtype=np.int64)]
    m = mesh_from_arrays(points, cells)
    bnd = np.asarray(m.boundary_mask) | ~valid
    return dataclasses.replace(m, boundary_mask=bnd, slot_valid=valid,
                               tile_T=int(tile_T))


def tile_mesh(mesh: Mesh, nb: int = 128):
    """(padded mesh, slot_of_node): the layout and the padded rebuild.
    Solutions on the padded mesh live in slot numbering: ``u_native =
    u_slots[slot_of_node]``."""
    slot, n_slots, S, T = tile_layout(mesh.points, nb=nb)
    return pad_mesh_to_slots(mesh, slot, n_slots, T), slot
