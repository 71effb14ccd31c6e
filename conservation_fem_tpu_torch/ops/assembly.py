"""P1 finite-element assembly as vectorised cell kernels and a
deterministic ELL scatter, ported from conservation_fem_tpu/ops/assembly.py.

Local closed forms on a triangle of area A with constant P1 gradients g_a:
  mass       M_ab  = A/12 * (1 + delta_ab)
  stiffness  K_ab  = A * g_a . g_b
  convection C_ab  = sum_c M_ac * (w_c . g_b)          (w a P1 vector field)
  eps-stiff  Ke_ab = (g_a . g_b) * A * mean(eps_cell)   (eps P1 scalar)
The nonlinear convection integrals use the degree-4 Dunavant rule (6
points). Where the JAX package differentiates the flux with ``jax.jvp``,
the port takes the flux's explicit derivatives: ``flux`` is an
ops.structured.Flux (``fprime_xy``, ``fprime2_xy``).

The scatter of cell values into an ELL matrix or a nodal vector gathers
them in the mesh's sorted order and sums each segment with
torch.segment_reduce, sequentially from 0 in that order: the JAX
package's sorted segment_sum, and deterministic on the card (no atomics).
Tables are host numpy f64; callers cast them to the compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch

# degree-4 Dunavant rule on the reference triangle (6 points), exact to p=4
_DUN4_W = np.array(
    [0.223381589678011, 0.223381589678011, 0.223381589678011,
     0.109951743655322, 0.109951743655322, 0.109951743655322])
_a1, _b1 = 0.445948490915965, 0.108103018168070
_a2, _b2 = 0.091576213509771, 0.816847572980459
_DUN4_P = np.array(
    [[_a1, _a1], [_b1, _a1], [_a1, _b1],
     [_a2, _a2], [_b2, _a2], [_a2, _b2]])


def _quad_basis():
    """P1 basis values at the quadrature points: (Q,3) f64."""
    x, y = _DUN4_P[:, 0], _DUN4_P[:, 1]
    return np.stack([1.0 - x - y, x, y], axis=1)


def _tables(like):
    """(phi (Q,3), w (Q,)) in like's dtype and device; w includes the
    reference triangle's area 1/2."""
    t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return t(_quad_basis()), t(_DUN4_W * 0.5)


def _stack(fns, u):
    return torch.stack([fns[0](u), fns[1](u)], dim=-1)


# ---------------------------------------------------------------------------
# local cell matrices
# ---------------------------------------------------------------------------


def local_mass(area):
    """(M,) tensor -> (M,3,3) local mass matrices."""
    base = (torch.ones(3, 3, dtype=area.dtype, device=area.device)
            + torch.eye(3, dtype=area.dtype, device=area.device)) / 12.0
    return area[:, None, None] * base[None]


def local_stiffness(area, grads):
    """(M,),(M,3,2) -> (M,3,3) local stiffness."""
    return area[:, None, None] * torch.einsum("mad,mbd->mab", grads, grads)


def local_convection(area, grads, w_cell):
    """C_ab = int (w . grad phi_b) phi_a = sum_c M_ac (w_c . g_b), w P1."""
    wg = torch.einsum("mcd,mbd->mcb", w_cell, grads)
    return torch.einsum("mac,mcb->mab", local_mass(area), wg)


def local_eps_stiffness(area, grads, eps_cell):
    """Ke_ab = g_a.g_b * A * mean(eps) over the cell's corners."""
    gg = torch.einsum("mad,mbd->mab", grads, grads)
    return (area * eps_cell.mean(dim=1))[:, None, None] * gg


# ---------------------------------------------------------------------------
# scatter: cell values -> ELL matrix / nodal vector
# ---------------------------------------------------------------------------


def scatter_matrix(mesh, cell_vals):
    """(M,3,3) local matrices -> (N,K) ELL matrix, deterministic order."""
    n, K = mesh.patch_cols.shape
    flat = cell_vals.reshape(-1)[mesh.mat_perm]
    return torch.segment_reduce(flat, "sum", lengths=mesh.mat_lens,
                                unsafe=True).reshape(n, K)


def scatter_vector(mesh, cell_vals):
    """(M,3) local vectors -> (N,) nodal vector, deterministic order."""
    flat = cell_vals.reshape(-1)[mesh.vec_perm]
    return torch.segment_reduce(flat, "sum", lengths=mesh.vec_lens,
                                unsafe=True)


# ---------------------------------------------------------------------------
# assembled global operators (ELL)
# ---------------------------------------------------------------------------


def assemble_mass(mesh):
    return scatter_matrix(mesh, local_mass(mesh.area))


def assemble_stiffness(mesh):
    return scatter_matrix(mesh, local_stiffness(mesh.area, mesh.grads))


def assemble_convection(mesh, w):
    """w: (N,2) P1 vector field."""
    return scatter_matrix(
        mesh, local_convection(mesh.area, mesh.grads, w[mesh.cells]))


def assemble_eps_stiffness(mesh, eps):
    """eps: (N,) P1 scalar viscosity field."""
    return scatter_matrix(
        mesh, local_eps_stiffness(mesh.area, mesh.grads, eps[mesh.cells]))


def assemble_directional_convection(mesh):
    """Cx, Cy with (Cd)_ab = int phi_a d_d phi_b dx = (A/3) g_b[d]."""
    a3 = mesh.area / 3.0
    M = mesh.area.shape[0]
    return tuple(
        scatter_matrix(mesh, (a3[:, None] * mesh.grads[:, :, d])[:, None, :]
                       .expand(M, 3, 3))
        for d in range(2))


def lumped_mass(mesh):
    """Row-sum lumped mass vector (N,)."""
    third = torch.full((3,), 1.0 / 3.0, dtype=mesh.area.dtype,
                       device=mesh.area.device)
    return scatter_vector(mesh, mesh.area[:, None] * third)


# ---------------------------------------------------------------------------
# nonlinear convection residual vectors (quadrature)
# ---------------------------------------------------------------------------


def local_convection_rhs(area, grads, u_cell, flux):
    """(M,),(M,3,2),(M,3) -> (M,3): r_a = int (f'(u_h) . grad u_h) phi_a
    over one cell."""
    phi, w = _tables(u_cell)
    u_q = torch.einsum("ma,qa->mq", u_cell, phi)
    fp_q = _stack(flux.fprime_xy, u_q)                       # (M,Q,2)
    grad_u = torch.einsum("ma,mad->md", u_cell, grads)
    conv_q = torch.einsum("mqd,md->mq", fp_q, grad_u)
    r = torch.einsum("mq,qa->ma", conv_q * w[None, :], phi)
    return 2.0 * area[:, None] * r


def local_flux_jacobian(area, grads, u_cell, flux):
    """(M,),(M,3,2),(M,3) -> (M,3,3) local Jacobian of the convection rhs:
    J_ab = int [ (f''(u) . grad u) phi_b + f'(u) . grad phi_b ] phi_a."""
    phi, w = _tables(u_cell)
    u_q = torch.einsum("ma,qa->mq", u_cell, phi)
    fp_q = _stack(flux.fprime_xy, u_q)
    fpp_q = _stack(flux.fprime2_xy, u_q)
    grad_u = torch.einsum("ma,mad->md", u_cell, grads)
    t1 = torch.einsum("mqd,md->mq", fpp_q, grad_u)
    term1 = torch.einsum("mq,qa,qb->mab", t1 * w[None], phi, phi)
    t2 = torch.einsum("mqd,mbd->mqb", fp_q, grads)
    term2 = torch.einsum("q,qa,mqb->mab", w, phi, t2)
    return 2.0 * area[:, None, None] * (term1 + term2)


def convection_rhs_flux(mesh, u, flux):
    """r_a = int (f'(u_h) . grad u_h) phi_a dx, vectorised over cells."""
    return scatter_vector(mesh, local_convection_rhs(
        mesh.area, mesh.grads, u[mesh.cells], flux))


def assemble_flux_jacobian(mesh, u, flux):
    """ELL assembly of d/du convection_rhs_flux (same quadrature rule)."""
    return scatter_matrix(mesh, local_flux_jacobian(
        mesh.area, mesh.grads, u[mesh.cells], flux))


def mass_apply_cellwise(mesh, u):
    """y = M u without assembling M."""
    return scatter_vector(mesh, torch.einsum(
        "mab,mb->ma", local_mass(mesh.area), u[mesh.cells]))


def l2_norm_sq(mesh, u):
    """int u_h^2 dx (exact for P1 through the local mass)."""
    return u @ mass_apply_cellwise(mesh, u)


def l2_error_vs_function(mesh, u, exact_fn, t=None):
    """sqrt(int (u_h - u_ex)^2 dx), u_ex evaluated at the quadrature
    points."""
    phi, w = _tables(u)
    u_q = torch.einsum("ma,qa->mq", u[mesh.cells], phi)
    pts_q = torch.einsum("qa,mad->mqd", phi, mesh.points[mesh.cells])
    if t is None:
        ex_q = exact_fn(pts_q[..., 0], pts_q[..., 1])
    else:
        ex_q = exact_fn(pts_q[..., 0], pts_q[..., 1], t)
    err = ((u_q - ex_q) ** 2 * w[None, :]).sum(dim=1) * 2.0 * mesh.area
    return torch.sqrt(err.sum())
