"""The hand-written ELL kernels of the unstructured fast path
(csrc/ell.cu, csrc/ell_burgers.cu) with their plain PyTorch versions.

Each wrapper runs the plain version for CPU tensors and launches its
kernel for CUDA tensors (there is no fallback from one to the other); a
launch reads the index copies of the mesh or space
(ops/mesh.with_kernel_index) and counts one in ``_build.launches``:

  * ``ell_spmv`` (kernel A): y = A x for an (N,K) ELL matrix, optionally
    constrained (the rows and columns of the mesh's boundary_mask pinned
    to the identity, read off its bc-flagged columns, int16 or int32);
    tiles of rows staged in shared memory on the plan of ``tile_plan``;
    plain version ``ops/spmv.ell_matvec``;
  * ``assemble_matrix`` / ``assemble_vector`` (kernel B, counted as
    ``ell_assemble``): cell locals (M,nd,nd) / (M,nd) summed into the ELL
    matrix / nodal vector in the sorted contribution order, owner-computes,
    in tiles of output groups on the plan of ``assemble_plan``; plain
    versions ``assembly.scatter_matrix`` / ``scatter_vector``;
  * ``p1_newton_locals`` (kernel C, flux compiled in): the P1 cell locals
    of N(u) + K_eps u and of M + dt/2 (K_eps + C'(u)), tiles of
    LOCALS_CELLS cells staged in shared memory (``locals_smem``); plain
    version the ``assembly.local_*`` formulas;
  * ``ell_rv_epsilon`` (kernel D, flux compiled in): the RV patch kernel
    given the global term max|u - mean u|, A's tile walk over its columns
    (``tile_plan``); plain version the masked patch reductions of
    ops/stabilization.py.

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
from conservation_fem_tpu_torch.ops.mesh import (ASSEMBLE_MAX_GROUPS,
                                                 ASSEMBLE_TILE, PERM_ALIGN)
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


# The tile plan of A and D (csrc/ell.cu ell_tile_walk): CTAs of R threads,
# each working tiles of R rows staged in two shared-memory stages; R the
# most rows whose two stages fit SMEM_CAP, halved from TILE_ROWS down to
# TILE_MIN_ROWS (multiples of 8: a tile's ranges, int16 columns too, start
# and end on the bulk copy's 16 bytes). The kernels size their persistent
# grids themselves, from the card's occupancy at this plan.
TILE_ROWS = 128           # csrc/ell.cu kTileMaxRows
TILE_MIN_ROWS = 32
SMEM_CAP = 232448         # shared memory a block may use (227 KB)
BULK_ALIGN = 16           # cp.async.bulk: addresses and sizes


class TilePlan(NamedTuple):
    rows: int     # R: rows a tile, threads a CTA
    stride: int   # Kp: a row's stride in shared memory (K odd: K, else K+1)
    smem: int     # dynamic shared memory of a CTA: 2 barriers, 2 stages


@functools.lru_cache(maxsize=64)
def tile_plan(K, itemsize, colsize=4):
    """The plan for K slots a row, each staging an ``itemsize``-byte value
    (A; D stages none: 0) and a ``colsize``-byte column (2: the int16
    codes, which only odd K reads, a tile's columns then landing by one
    bulk copy)."""
    if colsize == 2 and K % 2 == 0:
        raise ValueError("ELL tiles: int16 column codes need an odd K")
    stride = K if K % 2 else K + 1
    rows = TILE_ROWS

    def smem(r):
        return 16 + 2 * r * stride * (itemsize + colsize)

    while smem(rows) > SMEM_CAP and rows > TILE_MIN_ROWS:
        rows //= 2
    if smem(rows) > SMEM_CAP:
        raise ValueError(f"ELL tiles: K = {K} leaves no tile of "
                         f"{TILE_MIN_ROWS} rows within shared memory")
    return TilePlan(rows, stride, smem(rows))


def _columns(mesh, wide, name):
    cols = _index(mesh, wide, name)
    if mesh.patch_cols_d16 is not None and cols.shape[1] % 2:
        return mesh.patch_cols_d16
    return cols


def spmv_columns(mesh):
    """The column copy kernel A reads: the mesh's int16 codes where it has
    them and K is odd, else its int32 bc-flagged columns."""
    return _columns(mesh, "patch_cols_bc32", "ell_spmv")


def rv_columns(mesh):
    """The column copy kernel D reads: the int16 codes as A does (their bc
    bit ignored), else patch_cols32."""
    return _columns(mesh, "patch_cols32", "ell_rv_epsilon")


def _aligned(name, *ptrs):
    """Raises unless every address of ``ptrs`` (operands a bulk copy
    reads) is BULK_ALIGN-byte aligned."""
    for p in ptrs:
        if p % BULK_ALIGN:
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
    colsize = cols.element_size()
    plan = tile_plan(K, A.element_size(), colsize)
    a, c = A.data_ptr(), cols.data_ptr()
    _aligned("ell_spmv", a, c)
    bc = mesh.boundary_mask if constrained else None
    y = torch.empty_like(x)
    with _build.on_device(x):
        code = _build.entry("cft_ell_spmv", dtype)(
            a, c, x.data_ptr(), _ptr(bc), y.data_ptr(), n, K, plan.rows,
            plan.stride, plan.smem, int(colsize == 2), x.get_device(),
            _build.stream_ptr(x))
    _build.launches["ell_spmv"] += 1
    _build.check(code, "ell_spmv")
    return y


# ---------------------------------------------------------------------------
# B: assembly by owner-computes segmented sums
# ---------------------------------------------------------------------------


# B's plan (csrc/ell.cu ell_assemble_kernel): a persistent grid walking
# the tiles of the segment index (ops/mesh.segment_tiles: at most
# mesh.ASSEMBLE_TILE contributions and mesh.ASSEMBLE_MAX_GROUPS groups a
# tile), two stages of a tile's perm range (its 16-byte rounding at both
# ends included), offsets and bases


class AssemblePlan(NamedTuple):
    groups: int   # gmax: groups a tile at most
    cap: int      # perm entries a stage holds (a multiple of 4)
    smem: int     # dynamic shared memory of a CTA


@functools.lru_cache(maxsize=64)
def assemble_plan(width, itemsize):
    """B's plan for groups of ``width`` outputs and ``itemsize``-byte
    locals: 2 barriers, 2 stage headers, per stage the perm range, the
    offsets and the bases of a tile, then the tile's gathered locals."""
    gmax = ASSEMBLE_MAX_GROUPS
    cap = ASSEMBLE_TILE + 2 * PERM_ALIGN
    smem = 80 + cap * (2 * 4 + itemsize) + 2 * gmax * width + 2 * gmax * 4
    if smem > SMEM_CAP:
        raise ValueError(f"ell_assemble: groups of {width} outputs leave "
                         "no tile within shared memory")
    return AssemblePlan(gmax, cap, smem)


# the index fields of each mode: perm, offsets, bases, tiles, the unpadded
# order
_MATRIX = ("mat_perm32", "mat_off8", "mat_base32", "mat_tile32", "mat_perm")
_VECTOR = ("vec_perm32", "vec_off8", "vec_base32", "vec_tile32", "vec_perm")


def _assemble(mesh, vals, fields, shape):
    """Kernel B over the index ``fields`` (_MATRIX or _VECTOR)."""
    vals = vals.contiguous()
    perm, off, base, tiles = (_index(mesh, f, "ell_assemble")
                              for f in fields[:4])
    contributions = getattr(mesh, fields[4]).numel()
    if vals.numel() != contributions:
        raise ValueError(f"ell_assemble: {vals.numel()} locals for "
                         f"{contributions} contributions")
    dtype = _build.check_cuda_args("ell_assemble", vals)
    width = off.numel() // max(base.numel() - 1, 1)
    plan = assemble_plan(width, vals.element_size())
    p, o, b = perm.data_ptr(), off.data_ptr(), base.data_ptr()
    _aligned("ell_assemble", p, o, b)
    out = torch.empty(shape, dtype=vals.dtype, device=vals.device)
    with _build.on_device(vals):
        code = _build.entry("cft_ell_assemble", dtype)(
            vals.data_ptr(), p, o, b, tiles.data_ptr(), out.data_ptr(),
            out.numel(), width, tiles.shape[0] - 1, plan.groups, plan.cap,
            plan.smem, int(fields is _MATRIX), vals.get_device(),
            _build.stream_ptr(vals))
    _build.launches["ell_assemble"] += 1
    _build.check(code, "ell_assemble")
    return out


def assemble_matrix(mesh, vals):
    """(M,nd,nd) cell locals -> (N,K) ELL matrix (kernel B, matrix mode)."""
    if _build.on_cpu("ell_assemble", vals):
        return assembly.scatter_matrix(mesh, vals)
    return _assemble(mesh, vals, _MATRIX, tuple(mesh.patch_cols.shape))


def assemble_vector(mesh, vals):
    """(M,nd) cell locals -> (N,) nodal vector (kernel B, vector mode)."""
    if _build.on_cpu("ell_assemble", vals):
        return assembly.scatter_vector(mesh, vals)
    return _assemble(mesh, vals, _VECTOR, (mesh.patch_cols.shape[0],))


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
    c, ar, g = (cells.data_ptr(), mesh.area.data_ptr(),
                mesh.grads.data_ptr())
    _aligned("p1_newton_locals", c, ar, g)
    rhs = torch.empty((M, 3), dtype=u.dtype, device=u.device)
    jac = (torch.empty((M, 3, 3), dtype=u.dtype, device=u.device)
           if jacobian else None)
    with _build.on_device(u):
        code = _build.entry("cft_p1_newton_locals", dtype, fname)(
            c, ar, g, u.data_ptr(), _ptr(eps), float(half_dt),
            rhs.data_ptr(), _ptr(jac), M, locals_smem(u.element_size()),
            u.get_device(), _build.stream_ptr(u))
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
    host read), one thread a node, tiles of rows over ``rv_columns``."""
    tensors = (u_n, Rh, uh, h, abs_term)
    if _build.on_cpu("ell_rv_epsilon", *tensors):
        return ell_rv_epsilon_plain(mesh, Cvel, Crv, u_n, Rh, uh, h,
                                    abs_term, flux, valid)
    fname = _flux_name(flux, "ell_rv_epsilon")
    cols = rv_columns(mesh)
    n, K = cols.shape
    dtype = _build.check_cuda_args("ell_rv_epsilon", *tensors,
                                   shapes=[(n,)] * 4 + [()])
    colsize = cols.element_size()
    plan = tile_plan(K, 0, colsize)
    c = cols.data_ptr()
    _aligned("ell_rv_epsilon", c)
    valid = _bool(valid)
    eps = torch.empty_like(u_n)
    with _build.on_device(u_n):
        code = _build.entry("cft_ell_rv_epsilon", dtype, fname)(
            c, u_n.data_ptr(), Rh.data_ptr(), uh.data_ptr(), h.data_ptr(),
            abs_term.data_ptr(), _ptr(valid), float(Cvel), float(Crv),
            float(tiny_of(u_n.dtype)), eps.data_ptr(), n, K, plan.rows,
            plan.stride, plan.smem, int(colsize == 2), u_n.get_device(),
            _build.stream_ptr(u_n))
    _build.launches[_build.launch_key("ell_rv_epsilon", fname)] += 1
    _build.check(code, "ell_rv_epsilon")
    return eps
