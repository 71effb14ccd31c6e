"""Discontinuous-Galerkin carriers (DG0 / DG1) and L2 projections, ported
from conservation_fem_tpu/ops/dg.py.

Re-creates the reference's DG function spaces (ref
Code/KPP/KPP_NodeRV_plot.py:46-47 builds ("DG",0) and ("DG",1) spaces;
:130-150 fills a DG1 function with the per-cell mesh size h_k and
L2-projects it onto CG1 with a mass solve; Code/Utils/helpers.py:25-36
is the DG0 twin of the same projection).

DG dofs never couple across cells, so a DG_k field is a dense per-cell
tensor, ``(M,)`` for DG0 and ``(M, 3)`` for DG1 (local dof j sits at
vertex ``cells[m, j]``'s coordinates, like the reference's
``DG1.tabulate_dof_coordinates``). Every operation below is a closed form
over cells plus, for the CG projection, one Jacobi-CG solve on the ELL
mass (``assembly.scatter_vector``, ``assemble_mass``, ``spmv.ell_matvec``,
``krylov.cg``). Functions take the port's MeshArrays (``Mesh.device_arrays``)
and run on its device.
"""

from __future__ import annotations

import torch

from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.ops.krylov import cg, jacobi_preconditioner
from conservation_fem_tpu_torch.ops.mesh import MeshArrays
from conservation_fem_tpu_torch.ops.spmv import ell_diag, ell_matvec


def cell_vertex_coords(mesh: MeshArrays):
    """(M,3,2) DG1 dof coordinates (= cell vertex coordinates)."""
    return mesh.points[mesh.cells]


def dg0_interpolate(mesh: MeshArrays, fn):
    """Interpolate ``fn((M,2) centroids) -> (M,)`` into a DG0 field."""
    return fn(cell_vertex_coords(mesh).mean(dim=1))


def dg1_interpolate(mesh: MeshArrays, fn):
    """Interpolate ``fn((n,2) pts) -> (n,)`` into a DG1 field (M,3)."""
    p = cell_vertex_coords(mesh)
    return fn(p.reshape(-1, 2)).reshape(p.shape[:2])


def dg1_from_cg(mesh: MeshArrays, u):
    """Exact embedding of a CG P1 field into DG1 (a gather, (N,)->(M,3))."""
    return u[mesh.cells]


def dg1_average_to_cg(mesh: MeshArrays, d):
    """Arithmetic nodal average of the DG1 values meeting at each node —
    the cheap (non-variational) recovery; kept separate from the L2
    projection because they differ on discontinuous fields."""
    num = assembly.scatter_vector(mesh, d)
    den = assembly.scatter_vector(mesh, torch.ones_like(d))
    return num / den


def project_to_cg(mesh: MeshArrays, d, mass_ell=None, rtol: float = 1e-14):
    """L2-project a DG0 ``(M,)`` or DG1 ``(M,3)`` field onto CG P1.

    Solves (u, v) = (d, v) for all P1 test functions v (ref
    KPP_NodeRV_plot.py:143-150, solved there with LU; here Jacobi-CG to
    ``rtol``). The rhs uses the exact local integrals: for DG0,
    ``area/3 * d_m`` per vertex; for DG1 the P1 local mass matrix
    ``area/12 * [[2,1,1],[1,2,1],[1,1,2]]`` applied to the cell dofs.
    On a DG1 field that is cellwise constant this reduces exactly to the
    DG0 rhs, so ``nodal_h_dg1`` equals ``helpers.get_nodal_h_ell``.
    """
    d = torch.as_tensor(d, device=mesh.area.device)
    if d.ndim == 1:                                    # DG0
        rhs_cell = ((d * mesh.area / 3.0)[:, None]
                    * torch.ones(3, dtype=d.dtype, device=d.device))
    elif d.ndim == 2 and d.shape[1] == 3:              # DG1
        mloc = (torch.eye(3, dtype=d.dtype, device=d.device) + 1.0) / 12.0
        rhs_cell = mesh.area[:, None] * (d @ mloc)
    else:
        raise ValueError(f"not a DG0/DG1 field: shape {tuple(d.shape)}")
    b = assembly.scatter_vector(mesh, rhs_cell)
    if mass_ell is None:
        mass_ell = assembly.assemble_mass(mesh)
    precond = jacobi_preconditioner(ell_diag(mesh, mass_ell))
    res = cg(lambda x: ell_matvec(mesh, mass_ell, x), b,
             precond=precond, rtol=rtol)
    return res.x


def cell_h_dg1(mesh: MeshArrays):
    """The reference's h_DG field: each cell's min edge length broadcast
    to its three DG1 dofs (ref KPP_NodeRV_plot.py:132-140; ``h_cell``
    already holds the min edge)."""
    return mesh.h_cell[:, None] * torch.ones(3, dtype=mesh.h_cell.dtype,
                                             device=mesh.h_cell.device)


def nodal_h_dg1(mesh: MeshArrays, mass_ell=None, rtol: float = 1e-14):
    """h_CG via the DG1 carrier (ref KPP_NodeRV_plot.py:130-150);
    identical to helpers.get_nodal_h_ell because h_DG is cellwise
    constant."""
    return project_to_cg(mesh, cell_h_dg1(mesh), mass_ell, rtol)
