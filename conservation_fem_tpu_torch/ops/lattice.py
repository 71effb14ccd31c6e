"""Lattice-stencil operators: ELL matrices as offset planes, ported from
conservation_fem_tpu/ops/lattice.py.

Any space whose dofs lie on a regular 2-D lattice (P1 on a structured
rectangle mesh; Pk on the same mesh, whose Lagrange dofs form the
k-times-refined lattice; the P2-P1 Taylor-Hood pair of models/stokes.py)
has a gather-free SpMV: for each geometric offset o of the sparsity, a
coefficient plane P_o with

    (A x)[i, j] = sum_o  P_o[i, j] * x[i + oi, j + oj].

The conversion runs once on the host (numpy), as in the JAX package. A
product takes every shifted copy of the grid from one unfold over the
offsets' window (zero outside the grid; the JAX package slices and pads
once per plane) and sums the planes' products in one reduction
(``matvec``): a handful of kernel launches per product, not four per
plane, which on the card is what a lattice Krylov iteration costs. On a lattice with
holes (``full`` False) the holes read 0 (``to_grid`` fills them) and
carry zero planes, so a product never mixes them in. A plan keeps its
index tensors per device (``LatticePlan.index``), so moving a vector onto
the grid and back is one scatter and one gather with no host copy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True, eq=False)
class LatticePlan:
    """Host-built map from a dof vector to a dense (nI, nJ) grid. ``full``:
    every lattice point is a dof."""

    nI: int
    nJ: int
    idx: np.ndarray        # (N,) flat lattice index of each dof
    dof_at: np.ndarray     # (nI*nJ,) dof id at a lattice point, -1 in holes
    full: bool
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def index(self, device) -> torch.Tensor:
        """``idx`` as an int64 tensor on ``device``, made once."""
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.idx, dtype=torch.int64,
                                             device=device)
        return self._dev[key]


def _host(a):
    """A host numpy view of a tensor or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def build_plan(coords, tol=1e-8) -> LatticePlan:
    """Infer the lattice from dof coordinates (they must quantise
    exactly)."""
    coords = np.asarray(_host(coords), np.float64)

    def axis_quant(v):
        u = np.unique(np.round(v / tol) * tol)
        if u.size == 1:
            return u[0], 1.0, np.zeros_like(v, np.int64)
        h = np.diff(u).min()
        i = np.rint((v - u[0]) / h).astype(np.int64)
        if not np.allclose(u[0] + i * h, v, atol=tol * 10):
            raise ValueError("dof coordinates are not on a regular lattice")
        return u[0], h, i

    _, _, i = axis_quant(coords[:, 0])
    _, _, j = axis_quant(coords[:, 1])
    nI, nJ = int(i.max()) + 1, int(j.max()) + 1
    flat = i * nJ + j
    if np.unique(flat).size != flat.size:
        raise ValueError("two dofs share a lattice point")
    dof_at = np.full(nI * nJ, -1, np.int64)
    dof_at[flat] = np.arange(flat.size)
    return LatticePlan(nI=nI, nJ=nJ, idx=flat, dof_at=dof_at,
                       full=bool(flat.size == nI * nJ))


def to_planes(plan: LatticePlan, patch_cols, A, patch_mask=None):
    """ELL matrix -> (offsets, planes) on the host: offsets a list of
    (di, dj), planes (P, nI, nJ) numpy with planes[k][i, j] = A[row at
    (i, j), the slot with offset k] (0 elsewhere)."""
    A = _host(A)
    patch_cols = _host(patch_cols)
    N, K = A.shape
    ii = plan.idx // plan.nJ
    jj = plan.idx % plan.nJ
    rows = np.repeat(np.arange(N), K)
    cols = patch_cols.reshape(-1)
    vals = A.reshape(-1)
    # keep nonzero entries and every diagonal slot, so that identity-like
    # rows still pin the (0,0) plane; ELL padding slots alias the diagonal
    # with value 0, so the accumulation must be duplicate-safe (np.add.at)
    diag = cols == rows
    keep = (vals != 0.0) | diag
    if patch_mask is not None:
        keep &= _host(patch_mask).reshape(-1) | diag
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    di = ii[cols] - ii[rows]
    dj = jj[cols] - jj[rows]
    key = (di - di.min()) * (2 * plan.nJ + 1) + (dj - dj.min())
    uniq, inv = np.unique(key, return_inverse=True)
    P = uniq.size
    planes = np.zeros((P, plan.nI, plan.nJ), A.dtype)
    np.add.at(planes, (inv, ii[rows], jj[rows]), vals)
    off_di = np.zeros(P, np.int64)
    off_dj = np.zeros(P, np.int64)
    off_di[inv] = di
    off_dj[inv] = dj
    offsets = [(int(a), int(b)) for a, b in zip(off_di, off_dj)]
    return offsets, planes


_WINDOWS = {}


def _window(offsets, device):
    """(kI, kJ, rows): the (2 rI + 1) x (2 rJ + 1) window that holds every
    offset, and each offset's row in the window's unfolded form, as an
    index tensor on ``device`` (made once per offsets and device)."""
    key = (tuple(offsets), str(device))
    if key not in _WINDOWS:
        rI = max(abs(di) for di, _ in offsets)
        rJ = max(abs(dj) for _, dj in offsets)
        kJ = 2 * rJ + 1
        rows = [(di + rI) * kJ + dj + rJ for di, dj in offsets]
        _WINDOWS[key] = (2 * rI + 1, kJ, torch.tensor(rows, device=device))
    return _WINDOWS[key]


def matvec(offsets, planes, x2):
    """A x on the grid: sum_k planes[k] * shift(x2, offsets[k]); x2
    (..., nI, nJ), leading dimensions fields that share the operator. The
    shifted copies of x2 come from one unfold over the window of the
    offsets (zero outside the grid), the products are summed over the
    planes in one reduction: a handful of kernels whatever the number of
    planes."""
    if not offsets:
        return torch.zeros_like(x2)
    nI, nJ = x2.shape[-2:]
    kI, kJ, rows = _window(offsets, x2.device)
    cols = F.unfold(x2.reshape(-1, 1, nI, nJ), (kI, kJ),
                    padding=(kI // 2, kJ // 2))       # (B, kI kJ, nI nJ)
    shifted = cols.index_select(1, rows)              # (B, P, nI nJ)
    y = (planes.reshape(1, len(offsets), -1) * shifted).sum(dim=1)
    return y.reshape(x2.shape)


def to_grid(plan: LatticePlan, x, fill=0.0):
    """dof vector -> (nI, nJ) grid (one scatter; holes get ``fill``)."""
    g = torch.full((plan.nI * plan.nJ,), fill, dtype=x.dtype,
                   device=x.device)
    g[plan.index(x.device)] = x
    return g.reshape(plan.nI, plan.nJ)


def from_grid(plan: LatticePlan, x2):
    """(nI, nJ) grid -> dof vector (one gather)."""
    return x2.reshape(-1)[plan.index(x2.device)]


class LatticeOp(NamedTuple):
    """A lattice operator: static offsets, planes on the device."""

    offsets: tuple
    planes: object         # (P, nI, nJ) tensor

    def __call__(self, x2):
        return matvec(self.offsets, self.planes, x2)


def lattice_op(plan: LatticePlan, space_like, A, dtype=None) -> LatticeOp:
    """A LatticeOp from an ELL matrix on ``space_like`` (anything with
    .patch_cols: a SpaceArrays, MeshArrays or host Mesh). The planes go to
    A's device (the CPU for a host array) in ``dtype`` (None: A's)."""
    offsets, planes = to_planes(plan, space_like.patch_cols, A)
    device = A.device if isinstance(A, torch.Tensor) else None
    planes = torch.as_tensor(planes, device=device)    # A's dtype
    if dtype is not None:
        planes = planes.to(dtype)
    return LatticeOp(offsets=tuple(offsets), planes=planes)


def embed_plan(plan: LatticePlan, factor: int, nI: int,
               nJ: int) -> LatticePlan:
    """A coarse plan's dofs on a ``factor``-times finer grid (coarse (i, j)
    -> fine (factor i, factor j)); the result has holes."""
    i = plan.idx // plan.nJ
    j = plan.idx % plan.nJ
    idx = (i * factor) * nJ + j * factor
    dof_at = np.full(nI * nJ, -1, np.int64)
    dof_at[idx] = np.arange(idx.size)
    return LatticePlan(nI=nI, nJ=nJ, idx=idx, dof_at=dof_at, full=False)


def to_planes_coo(row_plan: LatticePlan, col_plan: LatticePlan,
                  rows, cols, vals, dtype=np.float64):
    """COO matrix -> (offsets, planes) for a rectangular operator between
    two dof sets on the same (nI, nJ) grid (embed_plan for the coarse
    side); duplicate (row, col) entries accumulate."""
    if (row_plan.nI, row_plan.nJ) != (col_plan.nI, col_plan.nJ):
        raise ValueError("row/col plans must share a grid")
    nI, nJ = row_plan.nI, row_plan.nJ
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype)
    rf = row_plan.idx[rows]
    cf = col_plan.idx[cols]
    ri, rj = rf // nJ, rf % nJ
    di = cf // nJ - ri
    dj = cf % nJ - rj
    key = di.astype(np.int64) * (4 * nJ + 1) + dj
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    planes = np.zeros((uniq.size, nI, nJ), dtype)
    np.add.at(planes, (inv, ri, rj), vals)
    offsets = [(int(di[f]), int(dj[f])) for f in first]
    return offsets, planes


class EllToPlanes(NamedTuple):
    """ELL values -> coefficient planes for a sparsity pattern fixed at
    build time: per-step operators (eps-weighted stiffness, Jacobians)
    are laid out by one indexed sum per rebuild, after which every
    product is gather-free. With a patch mask each valid slot has a plane
    position of its own (a row's columns are distinct), so the sum into
    the zero planes adds one value to each position, in any order; without
    one the padding slots add their zeros to the diagonal plane, as in the
    JAX package."""

    offsets: tuple
    nI: int
    nJ: int
    src: object           # (V,) flat ELL slot of each valid entry
    dst: object           # (V,) its flat position in the planes

    def __call__(self, A):
        planes = torch.zeros(len(self.offsets) * self.nI * self.nJ,
                             dtype=A.dtype, device=A.device)
        planes.index_put_((self.dst,), A.reshape(-1)[self.src],
                          accumulate=True)
        return LatticeOp(offsets=self.offsets,
                         planes=planes.reshape(-1, self.nI, self.nJ))


def ell_to_planes_fn(plan: LatticePlan, space_like) -> EllToPlanes:
    """The pattern analysis of EllToPlanes, on the host, once per space;
    its index tensors go to the device of space_like's patch_cols (the
    CPU for host arrays)."""
    patch_cols = _host(space_like.patch_cols)
    device = (space_like.patch_cols.device
              if isinstance(space_like.patch_cols, torch.Tensor) else None)
    N, K = patch_cols.shape
    ii = plan.idx // plan.nJ
    jj = plan.idx % plan.nJ
    di = ii[patch_cols] - ii[:, None]                     # (N, K)
    dj = jj[patch_cols] - jj[:, None]
    mask = getattr(space_like, "patch_mask", None)
    valid = np.ones((N, K), bool) if mask is None else _host(mask)
    key = di.astype(np.int64) * (4 * plan.nJ + 1) + dj
    _, first, inv = np.unique(key[valid], return_index=True,
                              return_inverse=True)
    offsets = list(zip(di[valid][first].tolist(), dj[valid][first].tolist()))
    rows = np.broadcast_to(np.arange(N)[:, None], (N, K))[valid]
    dst = (inv * plan.nI + ii[rows]) * plan.nJ + jj[rows]
    i64 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.int64, device=device)
    return EllToPlanes(offsets=tuple(offsets), nI=plan.nI, nJ=plan.nJ,
                       src=i64(np.flatnonzero(valid)), dst=i64(dst))
