"""Geometric multigrid for lattice-stencil operators, ported from
conservation_fem_tpu/ops/multigrid.py.

The IPCS solves' Krylov counts grow with the resolution (kappa ~ 1/h^2:
kip = 3 nx pressure iterations, models/stokes.auto_kip). A Galerkin
V-cycle makes them independent of it, with every level in the
shifted-MAC form of ops/lattice.py:

  * transfers: the 9-point tent (bilinear) stencil, one 3x3 correlation
    (``_tent``). Prolongation writes the coarse values into every second
    point of a zero fine grid (the JAX package's interior zero pad) and
    applies the tent; restriction is its transpose, the tent at every
    second point (the JAX package's tent MAC and stride-2 slice);
  * coarse operators: the Galerkin RAP on the host (scipy sparse, once
    per build), laid out as per-level coefficient planes;
  * smoother: weighted Jacobi, damped by a Gershgorin bound per level;
  * coarsest level: a dense inverse made on the host, applied with one
    ``torch.matmul`` (the JAX package applies it outside any Pallas
    kernel).

C-component block operators (the 2x2 IPCS momentum block) and scalar ones
(the pressure Poisson). V(nu, nu) keeps equal pre- and post-smoothing, so
the cycle is a symmetric operator whenever A is, and ``preconditioner``
is a valid CG preconditioner. Dirichlet rows arrive pinned (unit
diagonal, zero row and column) and coarsen through RAP.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.ops import lattice as lat

# tent = bilinear interpolation weights on the 3x3 neighbourhood
_TENT = tuple(
    (di, dj, (1.0 if di == 0 else 0.5) * (1.0 if dj == 0 else 0.5))
    for di in (-1, 0, 1) for dj in (-1, 0, 1)
)


class MGStatic(NamedTuple):
    """Hierarchy metadata; the tensors are in build_mg's second result."""

    ncomp: int
    shapes: tuple          # per stencil level, fine first: (nI, nJ)
    offsets: tuple         # per level: C x C tuple of offset-tuples | None
    coarse_shape: tuple    # (nI, nJ) of the dense-solved coarsest grid
    nu: int                # pre == post smoothing steps (symmetry)
    omega: tuple           # per-level weighted-Jacobi damping (Gershgorin)


# ---------------------------------------------------------------------------
# host build (numpy / scipy, once per operator)
# ---------------------------------------------------------------------------


def _ell_to_csr(patch_cols, patch_mask, vals, perm):
    """(N, K) ELL -> scipy CSR in grid order (row/col f <-> dof perm[f]);
    pad slots dropped through patch_mask."""
    import scipy.sparse as sps

    patch_cols = lat._host(patch_cols)
    mask = lat._host(patch_mask)
    vals = np.asarray(lat._host(vals), np.float64)
    N, K = patch_cols.shape
    rows = np.repeat(np.arange(N), K).reshape(N, K)
    inv = np.empty(N, np.int64)
    inv[perm] = np.arange(N)                   # dof -> grid position
    A = sps.coo_matrix(
        (vals[mask], (inv[rows[mask]], inv[patch_cols[mask]])),
        shape=(N, N)).tocsr()
    A.sum_duplicates()
    return A


def _pin_bc(blocks, bc):
    """Pin the bc rows of a C x C block CSR system: zero bc rows and
    columns in every block, unit diagonal on the diagonal blocks (the
    masked matvec of the Stokes solvers)."""
    import scipy.sparse as sps

    C = len(blocks)
    keep = sps.diags((~bc).astype(np.float64))
    eye_bc = sps.diags(bc.astype(np.float64))
    out = [[None] * C for _ in range(C)]
    for s in range(C):
        for d in range(C):
            if blocks[s][d] is None:
                continue
            B = keep @ blocks[s][d] @ keep
            if s == d:
                B = B + eye_bc
            out[s][d] = B.tocsr()
    return out


def _tent_P(nI, nJ):
    """Bilinear prolongation CSR: coarse ((nI+1)//2, (nJ+1)//2) -> fine
    (nI, nJ), coarse (i, j) at fine (2i, 2j); nI, nJ odd."""
    import scipy.sparse as sps

    mI, mJ = (nI + 1) // 2, (nJ + 1) // 2
    rows, cols, vals = [], [], []
    ic, jc = np.meshgrid(np.arange(mI), np.arange(mJ), indexing="ij")
    for di, dj, w in _TENT:
        fi = 2 * ic + di
        fj = 2 * jc + dj
        ok = (fi >= 0) & (fi < nI) & (fj >= 0) & (fj < nJ)
        rows.append((fi[ok] * nJ + fj[ok]).ravel())
        cols.append((ic[ok] * mJ + jc[ok]).ravel())
        vals.append(np.full(int(ok.sum()), w))
    return sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nI * nJ, mI * mJ)).tocsr()


def _csr_to_planes(A, nI, nJ, dtype, device):
    """Grid-ordered CSR -> (offsets, planes), the LatticeOp layout."""
    coo = A.tocoo()
    plan = lat.LatticePlan(nI=nI, nJ=nJ, idx=np.arange(nI * nJ),
                           dof_at=np.arange(nI * nJ), full=True)
    offsets, planes = lat.to_planes_coo(plan, plan, coo.row, coo.col,
                                        coo.data)
    return tuple(offsets), torch.as_tensor(planes, dtype=dtype,
                                           device=device)


def build_mg(plan, patch_cols, patch_mask, blocks, bc_mask, *,
             dtype=torch.float64, device=None, nu: int = 2,
             omega: float = 1.2, coarse_max: int = 700):
    """A V-cycle hierarchy for a C x C block ELL operator whose dofs fill a
    lattice (ops/lattice.build_plan, plan.full).

    blocks: C x C nested sequence of (N, K) ELL values (None: a zero
    block); bc_mask: (N,) bool pinned rows, the same for every component.
    Coarsens while the grid stays odd-sized and holds more than
    ``coarse_max`` points; the last grid gets a dense f64 inverse, kept
    in ``dtype`` on ``device`` (None: the card, raising without one).

    Returns (MGStatic, {"planes": [level][s][d], "dinv": [level],
    "cinv": dense})."""
    device = get_device(device)
    if not plan.full:
        raise NotImplementedError(
            "multigrid needs a full lattice (every grid point a dof); "
            "holes would need masked smoothing, which no current space "
            "needs (P1/Pk on rectangle meshes are full)")
    C = len(blocks)
    bc = np.asarray(lat._host(bc_mask), bool)
    perm = np.asarray(plan.dof_at)             # grid position -> dof
    csr = [[None if blocks[s][d] is None else
            _ell_to_csr(patch_cols, patch_mask, blocks[s][d], perm)
            for d in range(C)] for s in range(C)]
    csr = _pin_bc(csr, bc[perm])

    nI, nJ = plan.nI, plan.nJ
    shapes, offsets, planes, dinv, omegas = [], [], [], [], []
    while (nI % 2 == 1 and nJ % 2 == 1 and nI >= 5 and nJ >= 5
           and C * nI * nJ > coarse_max):
        lev_off, lev_pl = [], []
        for s in range(C):
            ro, rp = [], []
            for d in range(C):
                if csr[s][d] is None:
                    ro.append(None)
                    rp.append(None)
                else:
                    o, p = _csr_to_planes(csr[s][d], nI, nJ, dtype, device)
                    ro.append(o)
                    rp.append(p)
            lev_off.append(tuple(ro))
            lev_pl.append(rp)
        diag = np.stack([csr[s][s].diagonal().reshape(nI, nJ)
                         for s in range(C)])
        # Gershgorin bound g on lambda_max(D^-1 A): omega / g keeps
        # |1 - omega_l lambda| < 1 on (0, g] for omega < 2 (the P2
        # consistent-mass block breaks the P1 bound a flat omega assumes)
        di = np.where(diag != 0.0, 1.0 / diag, 1.0)
        g = 0.0
        for s in range(C):
            rs = np.zeros(nI * nJ)
            for d in range(C):
                if csr[s][d] is not None:
                    rs += np.abs(csr[s][d]).sum(axis=1).A1
            g = max(g, float((rs * di[s].reshape(-1)).max()))
        omegas.append(omega / max(g, 1e-30))
        shapes.append((nI, nJ))
        offsets.append(tuple(lev_off))
        planes.append(lev_pl)
        dinv.append(torch.as_tensor(di, dtype=dtype, device=device))
        P = _tent_P(nI, nJ)
        csr = [[None if csr[s][d] is None else (P.T @ csr[s][d] @ P).tocsr()
                for d in range(C)] for s in range(C)]
        nI, nJ = (nI + 1) // 2, (nJ + 1) // 2

    n = nI * nJ
    # the dense coarsest solve must stay small: tent coarsening needs odd
    # grid sizes (2^k m + 1 chains), so a large even-sized grid would
    # otherwise invert the whole operator
    dense_limit = max(4096, 4 * coarse_max)
    if C * n > dense_limit:
        raise ValueError(
            f"multigrid hierarchy stopped at a {nI}x{nJ} grid "
            f"(C*n = {C * n} > dense-solve limit {dense_limit}): grid "
            f"sizes must stay odd to coarsen (2^k*m+1 chains). For the "
            f"Stokes lattices use an even nx (pressure grid nx+1 odd, "
            f"velocity 2nx+1 odd), or raise coarse_max deliberately.")
    import scipy.sparse as sps

    dense = sps.bmat([[csr[s][d] if csr[s][d] is not None
                       else sps.csr_matrix((n, n))
                       for d in range(C)] for s in range(C)]).toarray()
    cinv = torch.as_tensor(np.linalg.inv(dense), dtype=dtype, device=device)

    static = MGStatic(ncomp=C, shapes=tuple(shapes), offsets=tuple(offsets),
                      coarse_shape=(nI, nJ), nu=nu, omega=tuple(omegas))
    return static, {"planes": planes, "dinv": dinv, "cinv": cinv}


# ---------------------------------------------------------------------------
# the cycle on the device (levels unrolled in Python)
# ---------------------------------------------------------------------------


def _level_matvec(offsets, planes, x):
    """Block stencil matvec: x (C, nI, nJ) -> (C, nI, nJ)."""
    C = x.shape[0]
    out = []
    for s in range(C):
        y = None
        for d in range(C):
            if offsets[s][d] is None:
                continue
            t = lat.matvec(offsets[s][d], planes[s][d], x[d])
            y = t if y is None else y + t
        out.append(y if y is not None else torch.zeros_like(x[s]))
    return torch.stack(out)


_TENT_W = {}


def _tent(x, stride=1):
    """The tent MAC over the 3x3 neighbourhood (zero outside the grid) of
    every point of every component of x (C, nI, nJ), as one 3x3
    correlation; stride 2 keeps every second point only."""
    key = (x.dtype, str(x.device))
    if key not in _TENT_W:
        w = torch.zeros((1, 1, 3, 3), dtype=x.dtype, device=x.device)
        for di, dj, v in _TENT:
            w[0, 0, di + 1, dj + 1] = v
        _TENT_W[key] = w
    return F.conv2d(x[:, None], _TENT_W[key], padding=1,
                    stride=stride)[:, 0]


def _restrict(x):
    """(C, nI, nJ) -> (C, (nI+1)//2, (nJ+1)//2): the tent MAC at every
    second point (the JAX package's tent MAC and stride-2 slice; the
    transpose of _prolong)."""
    return _tent(x, stride=2)


def _prolong(xc, shape):
    """(C, mI, mJ) -> (C, nI, nJ) bilinear: the coarse values at every
    second fine point of a zero grid, then the tent MAC."""
    nI, nJ = shape
    mI, mJ = xc.shape[1], xc.shape[2]
    e = xc.new_zeros((xc.shape[0], nI, nJ))
    e[:, 0:2 * mI - 1:2, 0:2 * mJ - 1:2] = xc
    return _tent(e)


def _cycle(static: MGStatic, arrs, l, b2):
    """The V-cycle from level ``l``."""
    if l == len(static.shapes):
        C = static.ncomp
        nc = static.coarse_shape[0] * static.coarse_shape[1]
        e = arrs["cinv"] @ b2.reshape(C * nc)
        return e.reshape(C, *static.coarse_shape)
    off, pl = static.offsets[l], arrs["planes"][l]
    dinv = arrs["dinv"][l]
    om = static.omega[l]
    A = lambda v: _level_matvec(off, pl, v)
    x = om * dinv * b2
    for _ in range(static.nu - 1):
        x = x + om * dinv * (b2 - A(x))
    e = _cycle(static, arrs, l + 1, _restrict(b2 - A(x)))
    x = x + _prolong(e, static.shapes[l])
    for _ in range(static.nu):
        x = x + om * dinv * (b2 - A(x))
    return x


def vcycle(static: MGStatic, arrs, b):
    """One V(nu,nu) cycle from a zero initial guess: b (C, nI, nJ) -> an
    approximation of A^-1 b; linear, and symmetric for a symmetric A."""
    return _cycle(static, arrs, 0, b)


def coarse_correction(static: MGStatic, arrs, r_full):
    """The cycle's tail from a full fine-grid residual (pre-smoothed at
    level 0 by the caller): restrict, run levels >= 1, prolong the error
    back (the sharded Stokes step's replicated part; ``arrs`` may hold
    None at level 0)."""
    assert static.shapes, "coarse_correction needs a stencil level 0"
    e = _cycle(static, arrs, 1, _restrict(r_full))
    return _prolong(e, static.shapes[0])


def preconditioner(static: MGStatic, arrs):
    """The V-cycle on flat (C*nI*nJ,) vectors, the grid-space Krylov
    solvers' layout (models/stokes.py)."""
    C = static.ncomp
    if static.shapes:
        nI, nJ = static.shapes[0]
    else:                                  # degenerate: dense only
        nI, nJ = static.coarse_shape
    return lambda r: vcycle(static, arrs, r.reshape(C, nI, nJ)).reshape(-1)
