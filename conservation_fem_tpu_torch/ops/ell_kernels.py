"""The hand-written ELL kernels of the unstructured fast path
(csrc/ell.cu, csrc/ell_burgers.cu) with their plain PyTorch versions.

Each wrapper runs the plain version for CPU tensors and launches its
kernel for CUDA tensors (there is no fallback from one to the other); a
launch reads the int32 index copies of the mesh or space
(ops/mesh.with_kernel_index) and counts one in ``_build.launches``:

  * ``ell_spmv`` (kernel A): y = A x for an (N,K) ELL matrix, optionally
    constrained (the rows and columns of the mesh's boundary_mask pinned
    to the identity, read off its bc-flagged columns, int16 or int32);
    tiles of rows staged in shared memory on the plan of ``spmv_plan``;
    plain version ``ops/spmv.ell_matvec``;
  * ``assemble_matrix`` / ``assemble_vector`` (kernel B, counted as
    ``ell_assemble``): cell locals (M,nd,nd) / (M,nd) summed into the ELL
    matrix / nodal vector in the sorted contribution order, owner-computes;
    plain versions ``assembly.scatter_matrix`` / ``scatter_vector``;
  * ``p1_newton_locals`` (kernel C, flux compiled in): the P1 cell locals
    of N(u) + K_eps u and of M + dt/2 (K_eps + C'(u)), tiles of
    LOCALS_CELLS cells staged in shared memory (``locals_smem``); plain
    version the ``assembly.local_*`` formulas;
  * ``ell_rv_epsilon`` (kernel D, flux compiled in): the RV patch kernel
    given the global term max|u - mean u|; plain version the masked patch
    reductions of ops/stabilization.py.

The flux of C and D is an ops.structured.Flux; its ``name`` picks the
instance ("kpp" or "burgers", ``_build.FLUXES``), and another flux raises
on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.ops.spmv import ell_matvec
from conservation_fem_tpu_torch.ops.structured import tiny_of

def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _index(mesh, field, name):
    t = getattr(mesh, field)
    if t is None:
        raise ValueError(f"{name}: the mesh has no int32 index (build it "
                         "with ops/mesh.with_kernel_index)")
    return t


def _flux_name(flux, name):
    if flux.name not in _build.FLUXES:
        raise NotImplementedError(
            f"{name}: no kernel instance for flux {flux.name!r} (compiled: "
            f"{sorted(_build.FLUXES)})")
    return flux.name


def _bool(mask):
    return None if mask is None else mask.contiguous()


# ---------------------------------------------------------------------------
# A: ELL SpMV
# ---------------------------------------------------------------------------


def ell_spmv_plain(mesh, A, x, constrained=False):
    """y = A x (constrained: with the rows and columns of the mesh's
    boundary_mask replaced by the identity), the gather backend's
    product."""
    if not constrained:
        return ell_matvec(mesh, A, x)
    bc = mesh.boundary_mask
    return torch.where(bc, x, ell_matvec(mesh, A, torch.where(bc, 0.0, x)))


# A's tile plan (csrc/ell.cu ell_spmv_kernel): CTAs of R threads, each
# summing tiles of R rows staged in two shared-memory stages; R the most
# rows whose two stages fit SPMV_SMEM_CAP, halved from SPMV_TILE_ROWS down
# to SPMV_MIN_ROWS (multiples of 8: a tile's ranges, int16 columns too,
# start and end on the bulk copy's 16 bytes). The kernel sizes its
# persistent grid itself, from the card's occupancy at this plan.
SPMV_TILE_ROWS = 128      # csrc/ell.cu kSpmvMaxRows
SPMV_MIN_ROWS = 32
SPMV_SMEM_CAP = 232448    # shared memory a block may use (227 KB)
BULK_ALIGN = 16           # cp.async.bulk: addresses and sizes


class SpmvPlan(NamedTuple):
    rows: int     # R: rows a tile, threads a CTA
    stride: int   # Kp: a row's stride in shared memory (K odd: K, else K+1)
    smem: int     # dynamic shared memory of a CTA: 2 barriers, 2 stages


@functools.lru_cache(maxsize=64)
def spmv_plan(K, itemsize, colsize=4):
    """A's plan for K slots a row of ``itemsize``-byte values and
    ``colsize``-byte columns (2: the int16 codes, which only odd K reads,
    a tile's columns then landing by one bulk copy)."""
    if colsize == 2 and K % 2 == 0:
        raise ValueError("ell_spmv: int16 column codes need an odd K")
    stride = K if K % 2 else K + 1
    rows = SPMV_TILE_ROWS

    def smem(r):
        return 16 + 2 * r * stride * (itemsize + colsize)

    while smem(rows) > SPMV_SMEM_CAP and rows > SPMV_MIN_ROWS:
        rows //= 2
    if smem(rows) > SPMV_SMEM_CAP:
        raise ValueError(f"ell_spmv: K = {K} leaves no tile of "
                         f"{SPMV_MIN_ROWS} rows within shared memory")
    return SpmvPlan(rows, stride, smem(rows))


def spmv_columns(mesh):
    """The column copy kernel A reads: the mesh's int16 codes where it has
    them and K is odd, else its int32 bc-flagged columns."""
    cols = _index(mesh, "patch_cols_bc32", "ell_spmv")
    if mesh.patch_cols_d16 is not None and cols.shape[1] % 2:
        return mesh.patch_cols_d16
    return cols


def _aligned(name, *tensors):
    for t in tensors:
        if t.data_ptr() % BULK_ALIGN:
            raise ValueError(f"{name}: an operand is not {BULK_ALIGN}-byte "
                             "aligned")


def ell_spmv(mesh, A, x, constrained=False):
    """y = A x for an (N,K) ELL matrix, each row summed in slot order;
    constrained: the product with the mesh's boundary_mask pinned (x zeroed
    on bc rows before it, y = x there). The kernel reads the bc flags off
    the columns of ``spmv_columns(mesh)``."""
    if _build.on_cpu("ell_spmv", A, x):
        return ell_spmv_plain(mesh, A, x, constrained)
    cols = spmv_columns(mesh)
    n, K = cols.shape
    dtype = _build.check_cuda_args("ell_spmv", A, x, shapes=[(n, K), (n,)])
    plan = spmv_plan(K, A.element_size(), cols.element_size())
    _aligned("ell_spmv", A, cols)
    bc = mesh.boundary_mask if constrained else None
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = _build.entry("cft_ell_spmv", dtype)(
            A.data_ptr(), cols.data_ptr(), x.data_ptr(), _ptr(bc),
            y.data_ptr(), n, K, plan.rows, plan.stride, plan.smem,
            int(cols.element_size() == 2), _build.stream_ptr(x))
    _build.launches["ell_spmv"] += 1
    _build.check(code, "ell_spmv")
    return y


# ---------------------------------------------------------------------------
# B: assembly by owner-computes segmented sums
# ---------------------------------------------------------------------------


def _assemble(mesh, vals, perm_f, offs_f, shape):
    vals = vals.contiguous()
    perm = _index(mesh, perm_f, "ell_assemble")
    offs = _index(mesh, offs_f, "ell_assemble")
    n_out = offs.numel() - 1
    if vals.numel() != perm.numel():
        raise ValueError(f"ell_assemble: {vals.numel()} locals for "
                         f"{perm.numel()} contributions")
    dtype = _build.check_cuda_args("ell_assemble", vals)
    out = torch.empty(n_out, dtype=vals.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        code = _build.entry("cft_ell_assemble", dtype)(
            vals.data_ptr(), perm.data_ptr(), offs.data_ptr(),
            out.data_ptr(), n_out, _build.stream_ptr(vals))
    _build.launches["ell_assemble"] += 1
    _build.check(code, "ell_assemble")
    return out.reshape(shape)


def assemble_matrix(mesh, vals):
    """(M,nd,nd) cell locals -> (N,K) ELL matrix (kernel B, matrix mode)."""
    if _build.on_cpu("ell_assemble", vals):
        return assembly.scatter_matrix(mesh, vals)
    return _assemble(mesh, vals, "mat_perm32", "mat_offs32",
                     tuple(mesh.patch_cols.shape))


def assemble_vector(mesh, vals):
    """(M,nd) cell locals -> (N,) nodal vector (kernel B, vector mode)."""
    if _build.on_cpu("ell_assemble", vals):
        return assembly.scatter_vector(mesh, vals)
    return _assemble(mesh, vals, "vec_perm32", "vec_offs32",
                     (mesh.patch_cols.shape[0],))


# ---------------------------------------------------------------------------
# C: P1 Newton locals
# ---------------------------------------------------------------------------


def p1_newton_locals_plain(mesh, u, eps, half_dt, flux, jacobian):
    """(rhs (M,3), jac (M,3,3) or None): the rhs locals of N(u) + K_eps u
    (eps None: N(u)) and, with ``jacobian``, the locals of M + dt/2
    (K_eps + C'(u)), half_dt = dt / 2, from the assembly.local_*
    formulas."""
    u_cell = u[mesh.cells]
    rhs = assembly.local_convection_rhs(mesh.area, mesh.grads, u_cell, flux)
    Ke = None
    if eps is not None:
        Ke = assembly.local_eps_stiffness(mesh.area, mesh.grads,
                                          eps[mesh.cells])
        rhs = rhs + torch.einsum("mab,mb->ma", Ke, u_cell)
    if not jacobian:
        return rhs, None
    J = assembly.local_mass(mesh.area)
    if Ke is not None:
        J = J + half_dt * Ke
    J = J + half_dt * assembly.local_flux_jacobian(mesh.area, mesh.grads,
                                                   u_cell, flux)
    return rhs, J


# C's tile plan (csrc/ell.cu p1_newton_locals_kernel): CTAs of
# LOCALS_CELLS threads, each computing tiles of as many cells (a multiple
# of 4: a tile's cells, areas and gradients start and end on the bulk
# copy's 16 bytes, and so do its 3 and 9 locals a cell) from two
# shared-memory stages of inputs, its locals staged in one output tile;
# the kernel sizes its persistent grid from the card's occupancy
LOCALS_CELLS = 128        # csrc/ell.cu kLocalsCells


def locals_smem(itemsize):
    """C's dynamic shared memory for ``itemsize``-byte values: 2 barriers,
    per stage 3 int32 nodes, an area and 6 gradients a cell, the output
    tile of 12 locals a cell."""
    c = LOCALS_CELLS
    return 16 + 2 * c * (3 * 4 + 7 * itemsize) + 12 * c * itemsize


def p1_newton_locals(mesh, u, eps, half_dt, flux, jacobian=False):
    """Kernel C: see p1_newton_locals_plain; one thread a cell, tiles of
    LOCALS_CELLS cells."""
    tensors = (u,) if eps is None else (u, eps)
    if _build.on_cpu("p1_newton_locals", *tensors):
        return p1_newton_locals_plain(mesh, u, eps, half_dt, flux, jacobian)
    fname = _flux_name(flux, "p1_newton_locals")
    cells = _index(mesh, "cells32", "p1_newton_locals")
    M = cells.shape[0]
    dtype = _build.check_cuda_args("p1_newton_locals", u, mesh.area,
                                   mesh.grads, *tensors[1:])
    _aligned("p1_newton_locals", cells, mesh.area, mesh.grads)
    rhs = torch.empty((M, 3), dtype=u.dtype, device=u.device)
    jac = (torch.empty((M, 3, 3), dtype=u.dtype, device=u.device)
           if jacobian else None)
    with torch.cuda.device(u.device):
        code = _build.entry("cft_p1_newton_locals", dtype, fname)(
            cells.data_ptr(), mesh.area.data_ptr(), mesh.grads.data_ptr(),
            u.data_ptr(), _ptr(eps), float(half_dt), rhs.data_ptr(),
            _ptr(jac), M, locals_smem(u.element_size()),
            _build.stream_ptr(u))
    _build.launches[_build.launch_key("p1_newton_locals", fname)] += 1
    _build.check(code, "p1_newton_locals")
    return rhs, jac


# ---------------------------------------------------------------------------
# D: RV epsilon over the patches
# ---------------------------------------------------------------------------


def _masked_max(vals, mask):
    return torch.where(mask, vals, -np.inf).amax(dim=1)


def ell_rv_epsilon_plain(mesh, Cvel, Crv, u_n, Rh, uh, h, abs_term, flux,
                         valid=None):
    """eps_i = min(Cvel h_i beta_i, CRV h_i^2 |R_i|): u_tilde the patch
    max - min of u_n, n_i = |u_tilde - abs_term|, R_i = patch max |Rh| /
    max(n_i, tiny), beta_i the patch max of |f'(uh)|; 0 where ``valid`` is
    False (a phantom slot, whose empty patch would give NaN)."""
    mask, cols = mesh.patch_mask, mesh.patch_cols
    up = u_n[cols]
    u_tilde = _masked_max(up, mask) - torch.where(mask, up, np.inf).amin(1)
    n_i = (u_tilde - abs_term).abs()
    R_i = _masked_max(Rh[cols].abs(), mask) / n_i.clamp_min(
        tiny_of(n_i.dtype))
    beta = _masked_max(flux.fprime_norm(uh)[cols], mask)
    eps = torch.minimum(Cvel * h * beta, Crv * h**2 * R_i.abs())
    if valid is not None:
        eps = torch.where(valid, eps, 0.0)
    return eps


def ell_rv_epsilon(mesh, Cvel, Crv, u_n, Rh, uh, h, abs_term, flux,
                   valid=None):
    """Kernel D: see ell_rv_epsilon_plain; abs_term a 0-dim tensor (no
    host read), one thread a node."""
    tensors = (u_n, Rh, uh, h, abs_term)
    if _build.on_cpu("ell_rv_epsilon", *tensors):
        return ell_rv_epsilon_plain(mesh, Cvel, Crv, u_n, Rh, uh, h,
                                    abs_term, flux, valid)
    fname = _flux_name(flux, "ell_rv_epsilon")
    cols = _index(mesh, "patch_cols32", "ell_rv_epsilon")
    n, K = cols.shape
    dtype = _build.check_cuda_args("ell_rv_epsilon", *tensors,
                                   shapes=[(n,)] * 4 + [()])
    valid = _bool(valid)
    eps = torch.empty_like(u_n)
    with torch.cuda.device(u_n.device):
        code = _build.entry("cft_ell_rv_epsilon", dtype, fname)(
            cols.data_ptr(), u_n.data_ptr(), Rh.data_ptr(), uh.data_ptr(),
            h.data_ptr(), abs_term.data_ptr(), _ptr(valid), float(Cvel),
            float(Crv), float(tiny_of(u_n.dtype)), eps.data_ptr(), n, K,
            _build.stream_ptr(u_n))
    _build.launches[_build.launch_key("ell_rv_epsilon", fname)] += 1
    _build.check(code, "ell_rv_epsilon")
    return eps
