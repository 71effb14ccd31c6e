"""Triangle meshes (host-side numpy), ported from
conservation_fem_tpu/ops/mesh.py.

A mesh is dense arrays plus precomputed sparse structure:

  * ``points (N,2)`` / ``cells (M,3)``, the boundary mask and the per-cell
    geometry (area, P1 basis gradients, shortest edge ``h_cell``);
  * the ELL node adjacency ``patch_cols (N,K)`` + ``patch_mask`` (the
    node patch, self included, columns sorted per row, padding holding the
    row index), ``diag_slot``, ``cell_slots`` (the ELL slot of each local
    pair of a cell) and the sorted scatter orderings (``mat_perm`` /
    ``mat_segs``, ``vec_perm`` / ``vec_segs``) that make every assembly a
    deterministic segmented sum.

Node and cell numbering, and every ELL structure, are the JAX package's
(its numpy path; the JAX package's native preprocessor computes the same
structures), so fields, anchors and states carry across unchanged. The ELL
structure is built the first time it is read: the structured stencil
backend never reads it, and at mesh 256 it would cost seconds and GBs of
host memory for nothing. ``rectangle_mesh_lean`` has none (1-element
placeholders, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device

Array = np.ndarray


class MeshArrays(NamedTuple):
    """The mesh as tensors on one device, read by the ELL kernels.

    Float fields in the compute dtype; index fields int64 (torch indexes
    with int64). ``mat_lens`` / ``vec_lens`` are the lengths of the sorted
    segments of ``mat_segs`` / ``vec_segs`` (one per ELL entry / node), the
    form torch.segment_reduce takes."""

    points: torch.Tensor        # (N,2) float
    cells: torch.Tensor         # (M,3) int64
    boundary_mask: torch.Tensor  # (N,) bool
    patch_cols: torch.Tensor    # (N,K) int64
    patch_mask: torch.Tensor    # (N,K) bool
    diag_slot: torch.Tensor     # (N,) int64
    cell_slots: torch.Tensor    # (M,3,3) int64
    area: torch.Tensor          # (M,) float
    grads: torch.Tensor         # (M,3,2) float
    h_cell: torch.Tensor        # (M,) float
    mat_perm: torch.Tensor      # (9M,) int64: sort order of matrix scatter
    mat_segs: torch.Tensor      # (9M,) int64: sorted targets row*K+slot
    vec_perm: torch.Tensor      # (3M,) int64: sort order of vector scatter
    vec_segs: torch.Tensor      # (3M,) int64: sorted row targets
    mat_lens: torch.Tensor      # (N*K,) int64
    vec_lens: torch.Tensor      # (N,) int64
    # int32 copies read by the hand-written ELL kernels (ops/ell_kernels),
    # set by ``with_kernel_index`` for the backends that launch them
    # (banded, blocked, blocked2d) and None elsewhere: the gather path's
    # memory is unchanged. *_perm32 are padded to a multiple of PERM_ALIGN
    # entries; *_off8 / *_base32 index their segments (``segment_index``:
    # the int32 start of each group of consecutive segments, an ELL row in
    # matrix mode, VEC_GROUP nodes in vector mode, and the uint8 start of
    # each segment in its group); *_tile32 cut the groups into kernel B's
    # tiles (``segment_tiles``)
    patch_cols32: torch.Tensor | None = None   # (N,K) int32
    # the ELL SpMV's columns: patch_cols32 with the columns of boundary
    # nodes flagged as ~j (< 0), and, where every patch lies within
    # D16_REACH rows of its node, the int16 codes 2 (j - i) + bc[j] (half
    # the bytes; None otherwise)
    patch_cols_bc32: torch.Tensor | None = None  # (N,K) int32
    patch_cols_d16: torch.Tensor | None = None   # (N,K) int16
    cells32: torch.Tensor | None = None        # (M,3) int32
    mat_perm32: torch.Tensor | None = None     # (9M,) int32, padded
    mat_off8: torch.Tensor | None = None       # (G*K,) uint8
    mat_base32: torch.Tensor | None = None     # (G+1,) int32, G >= N
    mat_tile32: torch.Tensor | None = None     # (tiles+1, 2) int32
    vec_perm32: torch.Tensor | None = None     # (3M,) int32, padded
    vec_off8: torch.Tensor | None = None       # (G*VEC_GROUP,) uint8
    vec_base32: torch.Tensor | None = None     # (G+1,) int32
    vec_tile32: torch.Tensor | None = None     # (tiles+1, 2) int32


class EllStructure(NamedTuple):
    patch_cols: Array   # (N,K) i64, sorted cols, padded with row index
    patch_mask: Array   # (N,K) bool
    diag_slot: Array    # (N,) i64
    cell_slots: Array   # (M,3,3) i64
    mat_perm: Array     # (9M,) i64
    mat_segs: Array     # (9M,) i64
    vec_perm: Array     # (3M,) i64
    vec_segs: Array     # (3M,) i64


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An immutable 2D triangle mesh (host numpy arrays). ``lean``: made by
    rectangle_mesh_lean, without ELL structure. ``periodic``: made by
    make_periodic, whose cells index the surviving master nodes while
    area, grads and h_cell keep the pre-fold geometry, so geometry
    recomputed from points[cells] is wrong on seam cells (Pk build_space
    refuses such a mesh)."""

    points: Array          # (N,2) f64
    cells: Array           # (M,3) i32
    boundary_mask: Array   # (N,) bool
    area: Array            # (M,) f64
    grads: Array           # (M,3,2) f64
    h_cell: Array          # (M,) f64
    lean: bool = False
    periodic: bool = False
    # set by ops/tiling.pad_mesh_to_slots (the tile-slot layout of the
    # blocked2d backend): slot_valid (N,) bool marks the real nodes (False:
    # a phantom padding slot, Dirichlet-pinned and in no cell); tile_T is
    # the tile stride T (blocks per strip). 0: not a tile-slot mesh
    slot_valid: Array | None = None
    tile_T: int = 0

    @property
    def n_nodes(self) -> int:
        return self.points.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def boundary_nodes(self) -> Array:
        return np.nonzero(self.boundary_mask)[0]

    @property
    def hmin(self) -> float:
        return float(self.h_cell.min())

    @functools.cached_property
    def ell(self) -> EllStructure:
        """The ELL structure, built on first use; 1-element placeholders on
        a lean mesh (any ELL consumer then fails on their shapes)."""
        if self.lean:
            z1 = np.zeros(1, dtype=np.int64)
            return EllStructure(z1.reshape(1, 1), np.zeros((1, 1), bool), z1,
                                z1.reshape(1, 1, 1), z1, z1, z1, z1)
        cells = self.cells.astype(np.int64)
        patch_cols, patch_mask, diag_slot, K = _build_patches(
            self.n_nodes, cells)
        cell_slots = _build_cell_slots(cells, patch_cols, patch_mask)
        return EllStructure(patch_cols, patch_mask, diag_slot, cell_slots,
                            *_scatter_orderings(cells, cell_slots, K))

    patch_cols = property(lambda self: self.ell.patch_cols)
    patch_mask = property(lambda self: self.ell.patch_mask)
    diag_slot = property(lambda self: self.ell.diag_slot)
    cell_slots = property(lambda self: self.ell.cell_slots)
    mat_perm = property(lambda self: self.ell.mat_perm)
    mat_segs = property(lambda self: self.ell.mat_segs)
    vec_perm = property(lambda self: self.ell.vec_perm)
    vec_segs = property(lambda self: self.ell.vec_segs)

    @property
    def max_patch(self) -> int:
        return self.patch_cols.shape[1]

    def device_arrays(self, dtype=torch.float64, device=None) -> MeshArrays:
        """The mesh as tensors on ``device`` (None: the card, raising
        without one; "cpu" for the CPU), floats in ``dtype``. A lean
        mesh ships 1-element placeholders for the cell arrays and the ELL
        structure, as the JAX package does: the stencil path reads none of
        them, and a generic-path consumer fails loudly on their shapes."""
        device = get_device(device)
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                      device=device)
        i = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64,
                                      device=device)
        lean = self.lean and self.n_nodes > 1
        z1 = np.zeros(1, dtype=np.int64)
        e = self.ell
        n, K = e.patch_cols.shape
        return MeshArrays(
            points=f(self.points),
            cells=i(z1.reshape(1, 1) if lean else self.cells),
            boundary_mask=torch.as_tensor(self.boundary_mask, device=device),
            patch_cols=i(e.patch_cols),
            patch_mask=torch.as_tensor(e.patch_mask, device=device),
            diag_slot=i(e.diag_slot), cell_slots=i(e.cell_slots),
            area=f(z1 if lean else self.area),
            grads=f(z1.reshape(1, 1, 1) if lean else self.grads),
            h_cell=f(z1 if lean else self.h_cell),
            mat_perm=i(e.mat_perm), mat_segs=i(e.mat_segs),
            vec_perm=i(e.vec_perm), vec_segs=i(e.vec_segs),
            mat_lens=i(np.bincount(e.mat_segs, minlength=n * K)),
            vec_lens=i(np.bincount(e.vec_segs, minlength=n)),
        )


# the reach of the int16 column codes 2 (j - i) + bc: |j - i| < 2^14
D16_REACH = 2**14
# kernel B's segment index (csrc/ell.cu ell_assemble_kernel): the
# contribution orders padded to a multiple of PERM_ALIGN entries (a tile's
# range of perm lands by a bulk copy, 16 bytes at a time), the groups to a
# multiple of SEGMENT_GROUPS (a tile's offsets and bases likewise), the
# nodes of vector mode grouped by VEC_GROUP (a base each); its tiles runs
# of whole SEGMENT_GROUPS-group units holding at most ASSEMBLE_TILE
# contributions (a stage's range of perm) and ASSEMBLE_MAX_GROUPS groups
PERM_ALIGN = 4
SEGMENT_GROUPS = 16
VEC_GROUP = 8
MAX_GROUP = 255
ASSEMBLE_TILE = 1792
ASSEMBLE_MAX_GROUPS = 128


def segment_index(lens, width):
    """(uint8 offsets, int32 group bases) of kernel B's segments: the
    segments (``lens``, one per output, in output order) taken in groups
    of ``width`` consecutive ones, padded with empty segments to a
    multiple of SEGMENT_GROUPS groups; base[g] is the start of group g's
    contributions in the sorted order (one more entry than groups), and
    off[e] the start of segment e in its group, so that segment e of group
    g spans base[g] + off[e] to base[g] + off[e + 1] (to base[g + 1] for
    the group's last). Raises where a group holds more than MAX_GROUP
    contributions (a segment, more so) or the order more than int32
    indexes."""
    n = lens.numel()
    groups = -(-n // width)
    groups += -groups % SEGMENT_GROUPS
    padded = torch.zeros(groups * width, dtype=torch.int64,
                         device=lens.device)
    padded[:n] = lens
    per_group = padded.view(groups, width)
    sizes = per_group.sum(1)
    if groups and int(sizes.max()) > MAX_GROUP:
        raise ValueError(f"ELL kernels: a group of segments holds "
                         f"{int(sizes.max())} contributions (uint8 offsets "
                         f"hold {MAX_GROUP})")
    off8 = (torch.cumsum(per_group, 1) - per_group).to(torch.uint8)
    base = torch.zeros(groups + 1, dtype=torch.int64, device=lens.device)
    torch.cumsum(sizes, 0, out=base[1:])
    if int(base[-1]) >= 2**31:
        raise ValueError("ELL kernels index with int32: too many "
                         "contributions")
    return off8.reshape(-1), base.to(torch.int32)


def segment_tiles(base):
    """(tiles + 1, 2) int32, on base's device: the first group and the
    first contribution of each of kernel B's tiles over the group bases
    ``base`` (a segment_index), then (groups, contributions): runs of whole
    SEGMENT_GROUPS-group units, each as long as ASSEMBLE_TILE contributions
    and ASSEMBLE_MAX_GROUPS groups allow. Raises where one unit alone holds
    more than ASSEMBLE_TILE contributions (more than a stage of the kernel
    holds)."""
    b = base.long().cpu().numpy()
    units = (len(b) - 1) // SEGMENT_GROUPS
    at = b[::SEGMENT_GROUPS]            # the units' first contributions
    if units and int(np.diff(at).max()) > ASSEMBLE_TILE:
        raise ValueError(f"ELL kernels: {SEGMENT_GROUPS} groups of segments "
                         f"hold {int(np.diff(at).max())} contributions (a "
                         f"tile holds {ASSEMBLE_TILE})")
    most = ASSEMBLE_MAX_GROUPS // SEGMENT_GROUPS
    starts = [0]
    while starts[-1] < units:
        u = starts[-1]
        fit = int(np.searchsorted(at, at[u] + ASSEMBLE_TILE, "right")) - 1
        starts.append(min(fit, u + most, units))
    g = np.array(starts, dtype=np.int64) * SEGMENT_GROUPS
    return torch.as_tensor(np.stack([g, b[g]], 1).astype(np.int32),
                           device=base.device)


def with_kernel_index(arrays):
    """``arrays`` (a MeshArrays, or a SpaceArrays: any NamedTuple with the
    ELL fields) with the index copies the hand-written ELL kernels read:
    patch_cols in int32 (and the SpMV's bc-flagged copies, int32 and,
    where the patches reach fewer than D16_REACH rows, int16 offsets), the
    cells (MeshArrays), and the contribution orders mat_perm / vec_perm in
    int32 with their segments' int32 group bases and uint8 offsets in the
    group (segment_index; groups: an ELL row, VEC_GROUP nodes) and kernel
    B's tiles (segment_tiles). Built once per
    problem, for the backends that launch the kernels."""
    if arrays.patch_cols32 is not None:
        return arrays

    def i32(t):
        return t.to(torch.int32).contiguous()

    def perm32(perm):
        out = torch.zeros(perm.numel() + -perm.numel() % PERM_ALIGN,
                          dtype=torch.int32, device=perm.device)
        out[:perm.numel()] = perm
        return out

    cols = i32(arrays.patch_cols)
    on_bc = arrays.boundary_mask[cols]
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None]
    delta = arrays.patch_cols - rows
    d16 = None
    if cols.numel() and int(delta.abs().max()) < D16_REACH:
        d16 = (2 * delta + on_bc).to(torch.int16).contiguous()
    mat_off8, mat_base32 = segment_index(arrays.mat_lens, cols.shape[1])
    vec_off8, vec_base32 = segment_index(arrays.vec_lens, VEC_GROUP)
    extra = dict(patch_cols32=cols,
                 patch_cols_bc32=torch.where(on_bc, ~cols, cols),
                 patch_cols_d16=d16,
                 mat_perm32=perm32(arrays.mat_perm), mat_off8=mat_off8,
                 mat_base32=mat_base32, vec_perm32=perm32(arrays.vec_perm),
                 vec_off8=vec_off8, vec_base32=vec_base32,
                 mat_tile32=segment_tiles(mat_base32),
                 vec_tile32=segment_tiles(vec_base32))
    if "cells32" in arrays._fields:
        extra["cells32"] = i32(arrays.cells)
    return arrays._replace(**extra)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


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
    edges = np.sort(edges, axis=1).astype(np.int64)
    key = edges[:, 0] * n_nodes + edges[:, 1]
    uniq, counts = np.unique(key, return_counts=True)
    once = uniq[counts == 1]
    mask = np.zeros(n_nodes, dtype=bool)
    mask[once // n_nodes] = True
    mask[once % n_nodes] = True
    return mask


def _pair_keys(n_nodes: int, cells: Array):
    """row * N + col of every ordered pair (a, b) of every cell, (M,n,n)
    flattened in cell-major order; cells (M,n): a mesh's (n = 3) or a Pk
    space's dofs (ops/spaces.py)."""
    n = cells.shape[1]
    rows = np.repeat(cells, n, axis=1).reshape(-1)
    cols = np.tile(cells, (1, n)).reshape(-1)
    return rows * n_nodes + cols


def _build_patches(n_nodes: int, cells: Array):
    """ELL node adjacency (self included) with the columns of a row sorted
    (the JAX package's np.unique of the pairs, lexicographic; here on the
    equivalent key row * N + col)."""
    pairs = np.unique(_pair_keys(n_nodes, cells))
    rows, cols = pairs // n_nodes, pairs % n_nodes
    deg = np.bincount(rows, minlength=n_nodes)
    K = int(deg.max())
    patch_cols = np.tile(np.arange(n_nodes, dtype=np.int64)[:, None], (1, K))
    patch_mask = np.zeros((n_nodes, K), dtype=bool)
    offsets = np.concatenate([[0], np.cumsum(deg)])
    slot = np.arange(len(rows)) - offsets[rows]
    patch_cols[rows, slot] = cols
    patch_mask[rows, slot] = True
    diag_slot = np.argmax(
        (patch_cols == np.arange(n_nodes)[:, None]) & patch_mask, axis=1)
    return patch_cols, patch_mask, diag_slot.astype(np.int64), K


def _build_cell_slots(cells: Array, patch_cols: Array, patch_mask: Array):
    """For each cell and local pair (a, b): the ELL slot k with
    patch_cols[cells[m, a], k] == cells[m, b] (unique among the masked
    entries of the row, whose columns are sorted); (M,n,n) for cells
    (M,n)."""
    n, K = patch_cols.shape
    M, nloc = cells.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), K)
    keys = (rows * n + patch_cols.reshape(-1))[patch_mask.reshape(-1)]
    start = np.concatenate([[0], np.cumsum(patch_mask.sum(axis=1))])
    want = _pair_keys(n, cells)
    pos = np.searchsorted(keys, want)
    if not (keys[np.minimum(pos, len(keys) - 1)] == want).all():
        raise AssertionError("cell pair missing from patch")
    slot = pos - start[want // n]
    return slot.reshape(M, nloc, nloc).astype(np.int64)


def _scatter_orderings(cells: Array, cell_slots: Array, K: int):
    """Stable sort orders for the deterministic segmented sums."""
    M, nloc = cells.shape
    rows = np.repeat(cells, nloc, axis=1).reshape(M, nloc, nloc)
    mat_target = (rows * K + cell_slots).reshape(-1)
    mat_perm = np.argsort(mat_target, kind="stable")
    vec_target = cells.reshape(-1)
    vec_perm = np.argsort(vec_target, kind="stable")
    return (mat_perm, mat_target[mat_perm], vec_perm,
            vec_target[vec_perm])


def _patches_from_csr(n_nodes, rowptr, cols):
    """The ELL adjacency of a CSR adjacency with sorted columns per row (the
    native preprocessor's): the layout of ``_build_patches``."""
    deg = np.diff(rowptr)
    K = int(deg.max())
    patch_cols = np.tile(np.arange(n_nodes, dtype=np.int64)[:, None], (1, K))
    patch_mask = np.zeros((n_nodes, K), dtype=bool)
    rows = np.repeat(np.arange(n_nodes), deg)
    slot = np.arange(len(cols)) - rowptr[:-1][rows]
    patch_cols[rows, slot] = cols
    patch_mask[rows, slot] = True
    diag_slot = np.argmax(
        (patch_cols == np.arange(n_nodes)[:, None]) & patch_mask, axis=1)
    return patch_cols, patch_mask, diag_slot.astype(np.int64), K


def mesh_from_arrays(points: Array, cells: Array,
                     use_native: bool = False) -> Mesh:
    """A full Mesh from raw geometry and topology. By default the JAX
    package's numpy path, the ELL structure following on first use.
    use_native: the boundary mask and the ELL adjacency from the native
    C++ preprocessor (``native_ext.preprocess_mesh``, built with g++ at
    first use; a failed build raises), the ELL structure built here; the
    same arrays as the numpy path. (The JAX package turns it on unless
    CFT_NATIVE=0; here it is off unless asked for.)"""
    points = np.ascontiguousarray(np.asarray(points, dtype=np.float64)[:, :2])
    cells = np.ascontiguousarray(np.asarray(cells, dtype=np.int64))
    area, grads, h_cell = _cell_geometry(points, cells)
    n = points.shape[0]
    if not use_native:
        return Mesh(points=points, cells=cells.astype(np.int32),
                    boundary_mask=_boundary_mask(n, cells),
                    area=area, grads=grads, h_cell=h_cell)
    from conservation_fem_tpu_torch import native_ext

    bnd, rowptr, csr_cols, _ = native_ext.preprocess_mesh(n, cells)
    patch_cols, patch_mask, diag_slot, K = _patches_from_csr(n, rowptr,
                                                             csr_cols)
    cell_slots = _build_cell_slots(cells, patch_cols, patch_mask)
    mesh = Mesh(points=points, cells=cells.astype(np.int32),
                boundary_mask=bnd, area=area, grads=grads, h_cell=h_cell)
    # the cached ``ell`` property, filled from the library's adjacency
    object.__setattr__(mesh, "ell", EllStructure(
        patch_cols, patch_mask, diag_slot, cell_slots,
        *_scatter_orderings(cells, cell_slots, K)))
    return mesh


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
    diagonal='right'): node id = i * (ny+1) + j, all lower triangles, then
    all upper ones."""
    if ny is None:
        ny = nx
    return mesh_from_arrays(*_grid(p0, p1, nx, ny))


def make_periodic(host: Mesh, axes=(0, 1), tol: float = 1e-9) -> Mesh:
    """Identify opposite-boundary nodes to make the mesh topologically
    periodic along ``axes`` (the JAX package's ``make_periodic``): every
    node on an axis' high side becomes a slave of the low-side node with
    the same other coordinates (to ``tol``; corners chain through both
    folds), the surviving masters keep their order and are renumbered
    densely. Cell connectivity moves onto the masters while the cell
    geometry (area, gradients, h) keeps the original coordinates, so seam
    cells integrate over their true shape; seam edges then have two cells
    and drop out of the boundary mask."""
    pts = np.asarray(host.points, np.float64)
    cells = np.asarray(host.cells, np.int64)
    n = pts.shape[0]
    master_of = np.arange(n)
    for ax in axes:
        lo, hi = pts[:, ax].min(), pts[:, ax].max()
        other = [a for a in range(pts.shape[1]) if a != ax]
        key = lambda ids: [tuple(np.round(pts[i, other] / tol).astype(
            np.int64)) for i in ids]
        lo_ids = np.nonzero(np.isclose(pts[:, ax], lo, atol=tol))[0]
        lut = dict(zip(key(lo_ids), lo_ids))
        hi_ids = np.nonzero(np.isclose(pts[:, ax], hi, atol=tol))[0]
        for s, k in zip(hi_ids, key(hi_ids)):
            if k not in lut:
                raise ValueError(
                    f"periodic axis {ax}: no matching low-side node for "
                    f"point {pts[s]}")
            master_of[s] = lut[k]
    for _ in range(len(axes)):          # corner: x-fold then y-fold
        master_of = master_of[master_of]
    keep = master_of == np.arange(n)
    new_id = np.cumsum(keep) - 1
    cells_new = new_id[master_of[cells]]
    area, grads, h_cell = _cell_geometry(pts, cells)
    return Mesh(points=np.ascontiguousarray(pts[keep]),
                cells=cells_new.astype(np.int32),
                boundary_mask=_boundary_mask(int(keep.sum()), cells_new),
                area=area, grads=grads, h_cell=h_cell, periodic=True)


def rectangle_mesh_lean(p0=(0.0, 0.0), p1=(1.0, 1.0), nx: int = 8,
                        ny: int | None = None) -> Mesh:
    """rectangle_mesh in O(N) host memory, for the stencil backend only:
    the geometry of the two exemplar cells (first lower, first upper) is
    broadcast, the boundary mask is the grid frame, and there is no ELL
    structure. Values are identical to rectangle_mesh."""
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
                h_cell=np.broadcast_to(h0[:1], (M,)), lean=True)


def rectangle_cell_sizes(p0=(0.0, 0.0), p1=(1.0, 1.0), nx: int = 8,
                         ny: int | None = None):
    """(h_cell, area) of every cell of rectangle_mesh(p0, p1, nx, ny),
    computed cell by cell as there, where the linspace points make them
    differ in their last bits, without the boundary mask (the costly part
    at large nx)."""
    if ny is None:
        ny = nx
    points, tris = _grid(p0, p1, nx, ny)
    area, _, h_cell = _cell_geometry(points, tris)
    return h_cell, area


def irregular_mesh(p0=(0.0, 0.0), p1=(1.0, 1.0), nx: int = 8,
                   jitter: float = 0.35, seed: int = 0) -> Mesh:
    """Unstructured rectangle triangulation: the interior lattice points
    jittered by ``jitter * h`` (numpy default_rng(seed)) and triangulated
    with scipy's Delaunay (Qhull), cells turned counter-clockwise; boundary
    points stay exact. The committed anchors hold only for the same
    triangulation: check ``mesh_fingerprint`` against the JAX package's."""
    from scipy.spatial import Delaunay

    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], nx + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)
    h = (p1[0] - p0[0]) / nx
    interior = ((points[:, 0] > p0[0]) & (points[:, 0] < p1[0])
                & (points[:, 1] > p0[1]) & (points[:, 1] < p1[1]))
    rng = np.random.default_rng(seed)
    points[interior] += (rng.uniform(-jitter, jitter,
                                     (int(interior.sum()), 2)) * h)
    tris = Delaunay(points).simplices.astype(np.int64)
    p = points[tris]
    cross = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
             - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0]))
    flip = cross < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    return mesh_from_arrays(points, tris)


def disk_mesh(hmax: float, radius: float = 1.0, center=(0.0, 0.0)) -> Mesh:
    """Unit-disk triangulation from concentric rings: ring k (k = 1..nr)
    holds 6k nodes at radius k*dr, and 6(2k-1) triangles join rings k-1
    and k."""
    nr = max(1, int(round(radius / hmax)))
    dr = radius / nr
    pts = [np.array([[center[0], center[1]]])]
    ring_start = [None, 1]
    for k in range(1, nr + 1):
        m = 6 * k
        th = 2 * np.pi * np.arange(m) / m
        pts.append(np.stack([center[0] + k * dr * np.cos(th),
                             center[1] + k * dr * np.sin(th)], axis=1))
        ring_start.append(ring_start[-1] + m)
    points = np.concatenate(pts, axis=0)

    tris = [[0, 1 + i, 1 + (i + 1) % 6] for i in range(6)]
    for k in range(1, nr):
        s_in, n_in = ring_start[k], 6 * k
        s_out, n_out = ring_start[k + 1], 6 * (k + 1)
        for sec in range(6):
            for j in range(k + 1):
                o0 = s_out + (sec * (k + 1) + j) % n_out
                o1 = s_out + (sec * (k + 1) + j + 1) % n_out
                i0 = s_in + (sec * k + j) % n_in
                tris.append([i0, o0, o1])
                if j < k:
                    i1 = s_in + (sec * k + j + 1) % n_in
                    tris.append([i0, o1, i1])
    return mesh_from_arrays(points, np.asarray(tris))


def rcm_permutation(mesh: Mesh) -> Array:
    """Reverse Cuthill-McKee node ordering (old -> new), the JAX package's
    ``rcm_permutation``: a breadth-first search from the lowest-numbered
    node of least degree (again for each further component), each node's
    unvisited neighbours queued by degree, ties in column order, the whole
    order reversed. That is the rule of the JAX package's native
    preprocessor (native/mesh_preprocess.cpp), which its rcm_permutation
    calls; scipy's reverse_cuthill_mckee (``rcm_from_connectivity``) seeds
    its search from np.argsort(degree)[0], an unstable sort, and gives
    another order on some meshes (irregular_mesh nx 640, disk_mesh(1/8)).
    The committed irregular-mesh anchors are in this order."""
    n = mesh.n_nodes
    cols = mesh.patch_cols[mesh.patch_mask]
    rowptr = np.concatenate([[0], np.cumsum(mesh.patch_mask.sum(axis=1))])
    degree = np.diff(rowptr) - 1
    visited = np.zeros(n, dtype=bool)
    seeds = np.argsort(degree, kind="stable")
    order, n_done, k = [], 0, 0
    while n_done < n:
        while visited[seeds[k]]:
            k += 1
        level = seeds[k:k + 1]
        visited[level] = True
        while level.size:
            order.append(level)
            n_done += level.size
            lens = rowptr[level + 1] - rowptr[level]
            idx = (np.repeat(rowptr[level] - np.cumsum(lens) + lens, lens)
                   + np.arange(lens.sum()))
            nbr = cols[idx]
            parent = np.repeat(np.arange(level.size), lens)
            new = ~visited[nbr]
            nbr, parent = nbr[new], parent[new]
            first = np.sort(np.unique(nbr, return_index=True)[1])
            nbr, parent = nbr[first], parent[first]
            level = nbr[np.lexsort((degree[nbr], parent))]
            visited[level] = True
    order = np.concatenate(order)
    perm = np.empty(n, dtype=np.int64)
    perm[order[::-1]] = np.arange(n)
    return perm


def rcm_from_connectivity(n: int, conn) -> Array:
    """Reverse Cuthill-McKee (old -> new) from an (M, nloc) connectivity
    array, through scipy's reverse_cuthill_mckee (the JAX package's
    function of the same name)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    conn = np.asarray(conn, dtype=np.int64)
    nloc = conn.shape[1]
    rows = np.repeat(conn, nloc, axis=1).reshape(-1)
    cols = np.tile(conn, (1, nloc)).reshape(-1)
    A = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n)).tocsr()
    order = reverse_cuthill_mckee(A, symmetric_mode=True)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return perm


def reorder_mesh(mesh: Mesh, perm: Array) -> Mesh:
    """Renumber nodes by perm (old -> new); rebuilds all derived structure."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return mesh_from_arrays(mesh.points[inv],
                            perm[mesh.cells.astype(np.int64)])


def load_h5_mesh(path: str, geometry="Mesh/mesh/geometry",
                 topology="Mesh/mesh/topology") -> Mesh:
    """A DOLFINx XDMF/HDF5 mesh snapshot (geometry (N,2|3) f64, topology
    (M,3) i64). Needs h5py (imported here, not at module import)."""
    import h5py

    with h5py.File(path, "r") as f:
        points = np.asarray(f[geometry])
        cells = np.asarray(f[topology])
    return mesh_from_arrays(points, cells)


def mesh_fingerprint(mesh: Mesh) -> str:
    """sha256 of the points (f64) and cells (int64), in that order: equal
    fingerprints mean the same numbering and triangulation."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mesh.points, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(mesh.cells, dtype=np.int64).tobytes())
    return h.hexdigest()
