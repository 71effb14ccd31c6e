"""Node partition and halo tables of an unstructured mesh, ported from
conservation_fem_tpu/parallel/partition.py (host numpy; the JAX package's
module imports no JAX, but the port keeps its own copy).

The mesh is split into ``n_dev`` blocks of n_own = ceil(N / n_dev)
consecutive nodes (RCM-ordered first when asked, for locality); for each
block:

  * its rows of the ELL patch structure, the columns renumbered into the
    block's extended rows [0, n_own + H): its own rows first, its halo
    rows (nodes of other blocks that its patches reference) after;
  * the halo exchange: every block publishes a fixed-width block of its
    "shared" rows (those other blocks reference); after a gather of all
    published blocks each block picks its halo values by a flat index.

Cells belong to the block owning their first node (``CellPartition``);
their contributions to halo rows go back to the owners through the same
published blocks, in reverse (the reverse map ``rev_src``).

Every array, its values, dtype and shape, is the JAX package's, pads
included: a pad shared slot publishes the block's row 0, the first of
duplicate (block, node) shared slots wins the reverse lookup, pad rows
have global_rows = -1, and an empty halo or shared set has width 1. The
JAX package builds them by Python loops over nodes and cells (65 us a
cell); here they are vectorised, and a cell pair's ELL slot is the mesh's
own ``cell_slots``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from conservation_fem_tpu_torch.ops.mesh import (Mesh, rcm_permutation,
                                                 reorder_mesh)


class CellPartition(NamedTuple):
    """Per-block cell blocks and the extended-row scatter structure of
    fully distributed assembly (ghostUpdate ADD/REVERSE of vectors and ELL
    rows). A block's extended rows: [0, n_own) its own, [n_own, n_own + H)
    its halo (in the order of Partition.halo_src)."""
    n_cell_max: int            # C: cells per block, padded
    cells_ext: np.ndarray      # (n_dev, C, 3) extended rows of the cells
    cell_valid: np.ndarray     # (n_dev, C) real-cell mask
    area: np.ndarray           # (n_dev, C)
    grads: np.ndarray          # (n_dev, C, 3, 2)
    h: np.ndarray              # (n_dev, C) cell size h_k (rv_cell epsilon)
    cell_slots: np.ndarray     # (n_dev, C, 3, 3) ELL slot of each (a, b)
    # reverse exchange: an owner picks the contributions to its shared
    # rows out of the gathered (n_dev * H,) halo accumulations
    rev_src: np.ndarray        # (n_dev, S, R) flat indices into (n_dev*H,)
    rev_mask: np.ndarray       # (n_dev, S, R)


class Partition(NamedTuple):
    mesh: Mesh                 # the partitioned mesh (RCM-ordered if asked)
    n_dev: int
    n_own: int                 # rows per block (padded)
    n_total: int               # n_own * n_dev (>= n_nodes)
    # halo structures, one row per block:
    shared_size: int           # S: width of a published shared block
    shared_idx: np.ndarray     # (n_dev, S) own row of each published slot
    halo_size: int             # H: halo width (the largest block's)
    halo_src: np.ndarray       # (n_dev, H) flat index into the gathered
                               # (n_dev * S,) published table
    # each block's ELL rows with renumbered columns:
    local_cols: np.ndarray     # (n_dev, n_own, K) in [0, n_own + H)
    local_mask: np.ndarray     # (n_dev, n_own, K)
    global_rows: np.ndarray    # (n_dev, n_own) global node (or -1: pad)


def _halo_keys(mesh: Mesh, n_dev: int, n_own: int):
    """The halo sets of all blocks as sorted keys d * N + g (node g in
    block d's halo), and each block's start in them."""
    n = mesh.n_nodes
    rows = np.repeat(np.arange(n, dtype=np.int64), mesh.max_patch)
    cols = mesh.patch_cols.reshape(-1)
    ext = mesh.patch_mask.reshape(-1) & (rows // n_own != cols // n_own)
    keys = np.unique((rows // n_own * n + cols)[ext])
    return keys, np.searchsorted(keys, np.arange(n_dev + 1) * n)


def _width(counts):
    """A set width: the largest set's size, 1 when every set is empty."""
    return int(counts.max(initial=0)) or 1


def build_partition(mesh: Mesh, n_dev: int, reorder: bool = True
                    ) -> Partition:
    if reorder:
        mesh = reorder_mesh(mesh, rcm_permutation(mesh))
    n = mesh.n_nodes
    n_own = -(-n // n_dev)
    n_total = n_own * n_dev
    K = mesh.max_patch
    keys, _ = _halo_keys(mesh, n_dev, n_own)
    halo_dev, halo_g = keys // n, keys % n
    halo_count = np.bincount(halo_dev, minlength=n_dev)
    H = _width(halo_count)
    # shared sets: the nodes some other block references, by owner
    shared = np.unique(halo_g)
    s_owner = shared // n_own
    s_count = np.bincount(s_owner, minlength=n_dev)
    S = _width(s_count)
    s_start = np.concatenate([[0], np.cumsum(s_count)])
    s_slot = np.arange(len(shared)) - s_start[s_owner]
    shared_idx = np.zeros((n_dev, S), dtype=np.int64)
    shared_idx[s_owner, s_slot] = shared - s_owner * n_own
    # halo slot j of block d reads the published slot of its node
    h_start = np.concatenate([[0], np.cumsum(halo_count)])
    h_slot = np.arange(len(keys)) - h_start[halo_dev]
    k = np.searchsorted(shared, halo_g)
    halo_src = np.zeros((n_dev, H), dtype=np.int64)
    halo_src[halo_dev, h_slot] = s_owner[k] * S + s_slot[k]
    # each block's ELL rows, columns renumbered
    cols = np.zeros((n_total, K), dtype=np.int64)
    mask = np.zeros((n_total, K), dtype=bool)
    cols[:n], mask[:n] = mesh.patch_cols, mesh.patch_mask
    row_dev = (np.arange(n_total) // n_own)[:, None]
    own = cols // n_own == row_dev
    ext = mask & ~own
    out = np.where(own & mask, cols - row_dev * n_own, 0)
    out[ext] = n_own + h_slot[np.searchsorted(
        keys, (np.broadcast_to(row_dev, cols.shape) * n + cols)[ext])]
    global_rows = np.where(np.arange(n_total) < n, np.arange(n_total), -1)
    return Partition(
        mesh=mesh, n_dev=n_dev, n_own=n_own, n_total=n_total,
        shared_size=S, shared_idx=shared_idx, halo_size=H,
        halo_src=halo_src,
        local_cols=out.reshape(n_dev, n_own, K),
        local_mask=mask.reshape(n_dev, n_own, K),
        global_rows=global_rows.reshape(n_dev, n_own).astype(np.int64))


def build_cell_partition(part: Partition) -> CellPartition:
    """Give each cell to the block owning its first node; the extended
    rows of its nodes, and the reverse (ADD) exchange map."""
    mesh, n_dev, n_own = part.mesh, part.n_dev, part.n_own
    n = mesh.n_nodes
    H, S = part.halo_size, part.shared_size
    cells = mesh.cells.astype(np.int64)
    keys, h_start = _halo_keys(mesh, n_dev, n_own)
    owner_of = np.minimum(cells[:, 0] // n_own, n_dev - 1)
    count = np.bincount(owner_of, minlength=n_dev)
    C = int(count.max())
    ids = np.argsort(owner_of, kind="stable")      # by block, then cell
    dev = owner_of[ids]
    slot = np.arange(len(ids)) - np.concatenate([[0], np.cumsum(count)])[dev]
    vs = cells[ids]                                 # (M, 3)
    lo = (dev * n_own)[:, None]
    own = (vs >= lo) & (vs < lo + n_own)
    ext = np.where(own, vs - lo, 0)
    kk = np.searchsorted(keys, (dev[:, None] * n + vs)[~own])
    ext[~own] = n_own + kk - h_start[np.broadcast_to(dev[:, None],
                                                     vs.shape)[~own]]
    cells_ext = np.zeros((n_dev, C, 3), dtype=np.int64)
    cell_valid = np.zeros((n_dev, C), dtype=bool)
    area = np.zeros((n_dev, C))
    grads = np.zeros((n_dev, C, 3, 2))
    h_c = np.zeros((n_dev, C))
    cslots = np.zeros((n_dev, C, 3, 3), dtype=np.int64)
    cells_ext[dev, slot] = ext
    cell_valid[dev, slot] = True
    area[dev, slot] = mesh.area[ids]
    grads[dev, slot] = mesh.grads[ids]
    h_c[dev, slot] = mesh.h_cell[ids]
    # the first masked match of (row, col) in the row's patch: the mesh's
    # cell_slots (its columns are unique among a row's masked entries)
    cslots[dev, slot] = mesh.cell_slots[ids]
    # reverse map: what block src accumulated at its halo slot j (node g)
    # goes to g's owner's shared slot for g, contributions in src order
    src = keys // n
    j = np.arange(len(keys)) - h_start[src]
    g = keys % n
    o = g // n_own
    # the shared slot of g among its owner's published rows: its place in
    # the owner's sorted shared set (the real slots come before the pads,
    # so this is the first slot publishing g)
    shared = np.unique(g)
    s_start = np.concatenate(
        [[0], np.cumsum(np.bincount(shared // n_own, minlength=n_dev))])
    sj = np.searchsorted(shared, g) - s_start[o]
    order = np.lexsort((src, sj, o))
    o, sj, flat = o[order], sj[order], (src * H + j)[order]
    grp = o * S + sj
    r = np.arange(len(grp)) - np.searchsorted(grp, grp)
    R = _width(np.bincount(grp, minlength=1))
    rev_src = np.zeros((n_dev, S, R), dtype=np.int64)
    rev_mask = np.zeros((n_dev, S, R), dtype=bool)
    rev_src[o, sj, r] = flat
    rev_mask[o, sj, r] = True
    return CellPartition(
        n_cell_max=C, cells_ext=cells_ext, cell_valid=cell_valid,
        area=area, grads=grads, h=h_c, cell_slots=cslots,
        rev_src=rev_src, rev_mask=rev_mask)

