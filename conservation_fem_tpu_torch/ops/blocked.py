"""The blocked and blocked2d backends (the unstructured fast path), ported
from conservation_fem_tpu/ops/blocked.py.

The JAX module is a TPU design: after an RCM (or tile-slot) ordering the
rows are cut into blocks of nb, each operator is stored as dense (blocks,
nb, Wpad) row windows, every gather and scatter is a one-hot MXU
contraction and the operand streams are bf16, because gathers are slow on
the TPU. None of that is ported. On the card a gather runs at the memory
rate, so a ``BlockedPlan`` here is a plan over the ELL structure of the
RCM-ordered or tile-slot mesh: the operators are the (N,K) ELL matrices of
the gather backend, on the same numbering, and the hot operations run
through the hand-written kernels of ops/ell_kernels.py:

  * ``spmv`` / ``constrained_matvec``: kernel A (ELL SpMV);
  * ``assemble_matrix_components``, ``scatter_components``,
    ``local_apply``, ``local_diag``: kernel B (owner-computes assembly);
  * ``conv_plus_locals_rhs_components`` and ``newton_locals``: kernel C
    (the P1 quadrature of the CN residual and Jacobian locals);
  * ``rv_epsilon_nonlinear``: kernel D (the RV patch kernel);
  * ``patch_sum`` / ``smooth_vector``: kernel A on the 0/1 patch matrix;
  * ``si_alpha``, ``patch_max`` / ``min`` / ``abs_max``,
    ``rv_epsilon_linear``, ``rv_epsilon_cell_max`` and the locals of the
    matrix-free path: plain PyTorch reductions and gathers, as on the
    gather backend.
Each kernel's plain version runs for CPU tensors. The port's layouts are
cell-major: cell locals are (M, nd, nd) (or (M, nd*nd), slot a nd + b) and
local vectors (M, nd), in the mesh's cell order, where the JAX package has
(blocks, nd*nd, C) component planes.

``make_tiled_plan`` keeps the JAX coverage check of the tiled window
(``WindowCoverageError`` on the same meshes), so a configuration the JAX
package refuses is refused here too. The plans take no ``precise``: the
port computes f32 at f32 throughout, which is what the JAX package's
``precise=True`` does; its default bf16 streams (``precise=False``) are a
TPU saving the port does not make, so f32 blocked runs are held by the
anchor gates, not elementwise against JAX f32 runs (models/
scalar_hyperbolic.HyperbolicConfig.blocked_precise).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.ops import ell_kernels as ek
from conservation_fem_tpu_torch.ops import stabilization as stab
from conservation_fem_tpu_torch.ops.bc import ell_with_bc
from conservation_fem_tpu_torch.ops.mesh import Mesh, with_kernel_index
from conservation_fem_tpu_torch.ops.precision import sum_acc64
from conservation_fem_tpu_torch.ops.spmv import ell_diag
from conservation_fem_tpu_torch.ops.structured import tiny_of


class WindowCoverageError(ValueError):
    """A dof or patch column falls outside the tiled 3-run window of the
    JAX package's blocked2d plan: the tile neighbourhood halfwidth k is too
    small for this mesh and layout."""


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedPlan:
    """The blocked plan of one RCM-ordered (or tile-slot) mesh or space.

    n: rows (slots on a tile-slot mesh); B: the bandwidth after RCM (on a
    tiled plan the JAX window's diagonal offset (rw + k) nb), kept because
    the JAX package's callers read it; mesh: the mesh's (or space's)
    tensors with the kernels' int32 index (ops/mesh.with_kernel_index),
    which also hold the per-cell geometry; row_valid: (n,) bool of the real
    rows of a tile-slot mesh, None elsewhere; nd: dofs per cell; nb: the
    JAX plan's rows a block (128 on the 1D plan, the tile's on a tiled
    one) and halo: the rows its windows read beyond a block range (None:
    B, the 1D plan's; (T + k) nb on a tiled one), by which the sharded
    twins (parallel/blocked_sharded.py) cut their row ranges and halos."""

    n: int
    B: int
    mesh: object
    row_valid: torch.Tensor | None = None
    nd: int = 3
    nb: int = 128
    halo: int | None = None

    @property
    def window_halo(self) -> int:
        return self.B if self.halo is None else self.halo

    @property
    def patch_float(self):
        """The 0/1 patch matrix in ELL form (patch_sum's operator), built
        on first use."""
        pf = self.__dict__.get("_patch_float")
        if pf is None:
            pf = self.mesh.patch_mask.to(self.mesh.boundary_mask.device,
                                         self._dtype())
            object.__setattr__(self, "_patch_float", pf)
        return pf

    @property
    def patch_deg(self):
        """(n,) patch size, self included, at least 1."""
        return self.mesh.patch_mask.sum(dim=1).clamp_min(1).to(
            self._dtype())

    def _dtype(self):
        return (self.mesh.area.dtype if hasattr(self.mesh, "area")
                else self.mesh.detj_q.dtype)


def bandwidth(cols, pmask) -> int:
    """max |col - row| over the patches' entries."""
    offs = cols - np.arange(cols.shape[0])[:, None]
    return int(np.abs(offs[pmask]).max())


def make_blocked_plan(mesh: Mesh, dtype=torch.float32, device=None,
                      arrays=None) -> BlockedPlan:
    """The plan of an RCM-ordered mesh (ops/mesh.reorder_mesh(m,
    rcm_permutation(m))). arrays: the mesh's tensors when the caller has
    them (made here on ``device`` otherwise: None is the card)."""
    if arrays is None:
        arrays = mesh.device_arrays(dtype, device)
    return BlockedPlan(n=mesh.n_nodes,
                       B=bandwidth(mesh.patch_cols, mesh.patch_mask),
                       mesh=with_kernel_index(arrays))


def _tiled_coverage(n_slots, cols, pmask, nb, T, k):
    """The JAX plan's coverage check (blocked._plan_struct_tiled): the
    window of block b is 3 runs of rw = 2k + 1 blocks at block offsets
    (-T-k, -k, T-k); every patch column of a row (and so every dof of each
    of its cells) must lie in its block's window. Returns the window's
    diagonal offset (rw + k) nb and its reach past a block range (T + k)
    nb, or raises WindowCoverageError."""
    if n_slots % nb:
        raise ValueError("tiled layout must be slot-padded to nb")
    rw = 2 * k + 1
    if T <= rw:
        raise WindowCoverageError(
            f"tile stride T={T} <= run width {rw}: mesh too small for the "
            f"tiled layout - use the 1D RCM blocked backend")
    run_off = (-T - k, -k, T - k)
    rows = np.broadcast_to(np.arange(n_slots)[:, None], cols.shape)[pmask]
    delta = cols[pmask] // nb - rows // nb
    covered = np.zeros(delta.shape, dtype=bool)
    for o in run_off:
        covered |= (delta >= o) & (delta <= o + rw - 1)
    if not covered.all():
        raise WindowCoverageError(
            f"patch column outside the 3-run window at k={k}")
    return (rw + k) * nb, (T + k) * nb


def make_tiled_plan(mesh: Mesh, nb: int = 128, dtype=torch.float32,
                    k: int | None = None, device=None,
                    arrays=None) -> BlockedPlan:
    """The plan of a tile-slot mesh (ops/tiling.tile_mesh): k, the tile
    neighbourhood halfwidth, raised 1 -> 3 until the JAX window covers
    every patch (or fixed by the caller); row_valid = the mesh's
    slot_valid; arrays as for make_blocked_plan. The JAX package's need_patch_sum has no counterpart: the
    port's patch matrix is built on first use."""
    if not mesh.tile_T:
        raise ValueError("make_tiled_plan needs a tiling.tile_mesh mesh "
                         "(tile_T/slot_valid set)")
    ks = (k,) if k is not None else (1, 2, 3)
    for kk in ks:
        try:
            B, halo = _tiled_coverage(
                mesh.n_nodes, mesh.patch_cols, mesh.patch_mask, nb,
                int(mesh.tile_T), kk)
            break
        except WindowCoverageError:
            if kk == ks[-1]:
                raise
    if arrays is None:
        arrays = mesh.device_arrays(dtype, device)
    dev = arrays.boundary_mask.device
    return BlockedPlan(
        n=mesh.n_nodes, B=B, mesh=with_kernel_index(arrays),
        row_valid=torch.as_tensor(np.asarray(mesh.slot_valid), device=dev),
        nb=nb, halo=halo)


# ---------------------------------------------------------------------------
# operator application and assembly
# ---------------------------------------------------------------------------


def spmv(plan: BlockedPlan, D, x):
    """y = D x, D an (N,K) ELL operator (kernel A)."""
    return ek.ell_spmv(plan.mesh, D, x)


def constrained_matvec(plan: BlockedPlan, D, x):
    """y = D_bc x with the rows and columns of the mesh's boundary_mask
    pinned (kernel A, constrained mode)."""
    return ek.ell_spmv(plan.mesh, D, x, constrained=True)


def diag_of(plan: BlockedPlan, D):
    """The operator's diagonal."""
    return ell_diag(plan.mesh, D)


def _cells(plan):
    m = plan.mesh
    return m.cells if hasattr(m, "cells") else m.cell_dofs


def gather_components(plan: BlockedPlan, x):
    """x at the cells' dofs: (M, nd)."""
    return x[_cells(plan)]


def scatter_components(plan: BlockedPlan, v):
    """(M, nd) local vectors -> (n,) nodal sums (kernel B)."""
    return ek.assemble_vector(plan.mesh, v)


def assemble_matrix_components(plan: BlockedPlan, L):
    """(M, nd*nd) or (M, nd, nd) cell locals (slot a nd + b = row a,
    column b) -> the (N,K) ELL operator (kernel B)."""
    return ek.assemble_matrix(plan.mesh,
                              L.reshape(-1, plan.nd, plan.nd))


assemble_matrix = assemble_matrix_components


def local_apply(plan: BlockedPlan, L, x):
    """Matrix-free y = A(L) x from the (M, nd, nd) cell locals: x gathered
    to the cells, the locals applied, the result summed back (kernel B)."""
    L = L.reshape(-1, plan.nd, plan.nd)
    return scatter_components(
        plan, torch.einsum("mab,mb->ma", L, gather_components(plan, x)))


def local_diag(plan: BlockedPlan, L):
    """Diagonal of the operator assembled from the cell locals L."""
    L = L.reshape(-1, plan.nd, plan.nd)
    return scatter_components(plan, torch.diagonal(L, dim1=1, dim2=2))


def apply_bc_matrix(plan: BlockedPlan, D):
    """DOLFINx assemble_matrix(a, bcs): bc rows and columns zeroed, unit
    diagonal on bc rows."""
    return ell_with_bc(plan.mesh, D, plan.mesh.boundary_mask)


# ---------------------------------------------------------------------------
# P1 quadrature locals
# ---------------------------------------------------------------------------


def mass_locals_components(plan: BlockedPlan, dtype=None):
    """P1 mass locals (M, 3, 3): area (1 + delta_ab) / 12."""
    area = plan.mesh.area if dtype is None else plan.mesh.area.to(dtype)
    return assembly.local_mass(area)


def conv_plus_locals_rhs_components(plan: BlockedPlan, u, flux, eps=None):
    """(N(u) + K_eps u)_a -> (n,): the convection quadrature and, with
    eps, the eps-stiffness action, in one pass (kernel C, then kernel B).
    The JAX package passes the K_eps locals; the port's kernel forms them
    from eps in the same pass."""
    rhs, _ = ek.p1_newton_locals(plan.mesh, u, eps, 0.0, flux)
    return scatter_components(plan, rhs)


def conv_rhs_components(plan: BlockedPlan, u, flux):
    """N(u)_a = int (f'(u_h) . grad u_h) phi_a dx -> (n,)."""
    return conv_plus_locals_rhs_components(plan, u, flux)


def newton_locals(plan: BlockedPlan, u, eps, half_dt, flux):
    """The (M, 3, 3) locals of the CN Newton Jacobian M + dt/2 (K_eps +
    C'(u)), half_dt = dt / 2 (kernel C, Jacobian mode): the JAX package's
    L_mass9 + dt/2 eps_locals + dt/2 flux_jacobian_locals."""
    return ek.p1_newton_locals(plan.mesh, u, eps, half_dt, flux,
                               jacobian=True)[1]


def eps_locals_components(plan: BlockedPlan, eps):
    """eps-weighted stiffness locals (M, 3, 3): area mean(eps_cell)
    (g_a . g_b)."""
    m = plan.mesh
    return assembly.local_eps_stiffness(m.area, m.grads, eps[m.cells])


def flux_jacobian_locals_components(plan: BlockedPlan, u, flux):
    """Jacobian locals of the convection rhs (M, 3, 3)."""
    m = plan.mesh
    return assembly.local_flux_jacobian(m.area, m.grads, u[m.cells], flux)


# ---------------------------------------------------------------------------
# patch reductions (stabilisation)
# ---------------------------------------------------------------------------


def _patch(plan, x):
    return x[plan.mesh.patch_cols]


def patch_max(plan: BlockedPlan, x):
    return torch.where(plan.mesh.patch_mask, _patch(plan, x),
                       -np.inf).amax(dim=1)


def patch_min(plan: BlockedPlan, x):
    return torch.where(plan.mesh.patch_mask, _patch(plan, x),
                       np.inf).amin(dim=1)


def patch_abs_max(plan: BlockedPlan, x):
    return torch.where(plan.mesh.patch_mask, _patch(plan, x).abs(),
                       0.0).amax(dim=1)


def patch_sum(plan: BlockedPlan, x):
    """sum over the patch (self included): kernel A on the 0/1 patch
    matrix."""
    return spmv(plan, plan.patch_float, x)


def _abs_term(uh, precise, valid):
    """max |u - mean u| over the rows (the real rows where valid is
    given), the mean f64-accumulated under ``precise``."""
    if valid is not None:
        uv = torch.where(valid, uh, 0.0)
        nreal = valid.sum().to(uh.dtype)
        mean = (sum_acc64(uv) if precise else uv.sum()) / nreal
        return torch.where(valid, uh - mean, 0.0).abs().max()
    mean = sum_acc64(uh) / uh.shape[0] if precise else uh.mean()
    return (uh - mean).abs().max()


def rv_epsilon_nonlinear(plan: BlockedPlan, Cvel, Crv, uh, u_n, flux, Rh, h,
                         precise=False, valid=None):
    """The patch-normalised RV of stabilization.rv_epsilon_nonlinear; the
    global term in PyTorch, the patch kernel D. valid: the real rows of a
    tile-slot mesh (the mean and max skip the phantom slots, whose eps is
    0). The JAX package passes |f'|; the kernel takes the flux."""
    abs_term = _abs_term(uh, precise, valid)
    return ek.ell_rv_epsilon(plan.mesh, Cvel, Crv, u_n, Rh, uh, h,
                             abs_term, flux, valid)


def rv_epsilon_linear(plan: BlockedPlan, Cvel, Crv, uh, u_n, w_norm, Rh, h,
                      precise=False):
    """stabilization.rv_epsilon_linear with beta_i = |w_i| given."""
    u_tilde = patch_max(plan, u_n) - patch_min(plan, u_n)
    n_i = (u_tilde - _abs_term(uh, precise, None)).abs()
    R_i = patch_abs_max(plan, Rh) / n_i.clamp_min(tiny_of(n_i.dtype))
    return torch.minimum(Cvel * h * w_norm, Crv * h**2 * R_i.abs())


def rv_epsilon_cell_max(plan: BlockedPlan, Cvel, Crv, residual_node,
                        beta_cell, valid_node):
    """Cell RV with the order-independent "max" node scatter
    (stabilization.rv_epsilon_cell(scatter="max")); 0 off valid_node. The
    last-cell-wins scatter is refused on this backend, as in the JAX
    package."""
    m = plan.mesh
    eps = stab.rv_epsilon_cell(m, Cvel, Crv, residual_node, beta_cell,
                               m.h_cell, scatter="max")
    return torch.where(valid_node, eps, 0.0)


def si_alpha(plan: BlockedPlan, K_D, u, eps_floor=1e-8):
    """stabilization.si_alpha over the patches."""
    return stab.si_alpha(plan.mesh, K_D, u, eps_floor)


def smooth_vector(plan: BlockedPlan, u, l: float):
    """stabilization.smooth_vector with the patch sum of kernel A."""
    neighbor_sum = patch_sum(plan, u) - u
    d = (plan.patch_deg - 1.0).clamp_min(1.0)
    return (neighbor_sum + (l - 1.0) * d * u) / (l * d)
