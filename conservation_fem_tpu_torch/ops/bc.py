"""Dirichlet boundary conditions in matrix-free form, ported from
conservation_fem_tpu/ops/bc.py (DOLFINx semantics: bc rows and columns
zeroed with a unit diagonal, the lifting moved to the right-hand side,
b[bc] = g), without materialising a modified matrix.
"""

from __future__ import annotations

import torch

from conservation_fem_tpu_torch.ops.mesh import MeshArrays
from conservation_fem_tpu_torch.ops.spmv import ell_matvec


def constrained_matvec(mesh: MeshArrays, A, x, bc_mask):
    """y = A_bc @ x where A_bc has bc rows/cols zeroed and 1 on the diag."""
    y = ell_matvec(mesh, A, torch.where(bc_mask, 0.0, x))
    return torch.where(bc_mask, x, y)


def constrained_operator(mesh: MeshArrays, A, bc_mask):
    return lambda x: constrained_matvec(mesh, A, x, bc_mask)


def lift_rhs(mesh: MeshArrays, A, b, g, bc_mask):
    """b' = b - A @ (g on bc) on interior rows, b'[bc] = g[bc]; g a
    full-length vector of boundary values."""
    lifted = b - ell_matvec(mesh, A, torch.where(bc_mask, g, 0.0))
    return torch.where(bc_mask, g, lifted)


def ell_with_bc(mesh: MeshArrays, A, bc_mask):
    """DOLFINx ``assemble_matrix(a, bcs)`` on an ELL matrix: bc rows AND bc
    columns zeroed, unit diagonal on bc rows (the SI kernel reads these
    entries)."""
    out = torch.where(bc_mask[:, None] | bc_mask[mesh.patch_cols], 0.0, A)
    rows = torch.arange(A.shape[0], device=A.device)
    diag = out[rows, mesh.diag_slot]
    out[rows, mesh.diag_slot] = torch.where(bc_mask, 1.0, diag)
    return out


def constrain_residual(F, u, g, bc_mask):
    """Newton residual with the Dirichlet rows replaced by (u - g)."""
    return torch.where(bc_mask, u - g, F)
