"""Pk quadrature assembly over a SpaceArrays (k = 1..3), ported from
conservation_fem_tpu/ops/assembly_pk.py.

Every form is an einsum over (cells x quadrature points) with the
tabulated reference basis and the isoparametric per-point geometry
(``jinv_t_q``, ``detj_q``), then the scatter of ops/assembly.py: the
cell values gathered in the space's sorted order and each segment summed
by torch.segment_reduce, sequentially in that order (the JAX package's
sorted segment_sum, and deterministic on the card: no atomics); each
form's cell locals are a function of their own (``*_locals``), which the
blocked backend sums with its assembly kernel instead. Outputs
use the ELL layout of the space's dof adjacency, so the P1 path's SpMV,
bc and stabilisation code applies unchanged. The JAX package's
``einsum_exact`` is plain torch.einsum here: TF32 is off, and asserted in
the package root. Where the JAX package differentiates the flux with
``jax.jvp``, the port takes the Flux's explicit f'' (``fprime2_xy``).
"""

from __future__ import annotations

import torch

from conservation_fem_tpu_torch.ops.assembly import (_stack, scatter_matrix,
                                                     scatter_vector)


def _phys_grads(sp):
    """Physical basis gradients at the quadrature points: (M,Q,nloc,2)."""
    return torch.einsum("mqde,qne->mqnd", sp.jinv_t_q, sp.dphi)


def _at_q(sp, u):
    """(u at the cells' dofs (M,nloc), u at the quadrature points (M,Q))."""
    u_cell = u[sp.cell_dofs]
    return u_cell, torch.einsum("qc,mc->mq", sp.phi, u_cell)


def mass_locals(sp):
    """(M,nloc,nloc) mass locals."""
    return torch.einsum("q,mq,qa,qb->mab", sp.quad_w, sp.detj_q, sp.phi,
                        sp.phi)


def stiffness_locals(sp):
    g = _phys_grads(sp)
    return torch.einsum("q,mq,mqad,mqbd->mab", sp.quad_w, sp.detj_q, g, g)


def convection_locals(sp, w):
    """C_ab = int (w . grad phi_b) phi_a; w (ndof,2) in the same space."""
    g = _phys_grads(sp)
    w_q = torch.einsum("qc,mcd->mqd", sp.phi, w[sp.cell_dofs])
    return torch.einsum("q,mq,qa,mqd,mqbd->mab", sp.quad_w, sp.detj_q,
                        sp.phi, w_q, g)


def eps_stiffness_locals(sp, eps):
    """Ke_ab = int eps grad phi_a . grad phi_b; eps (ndof,) in the same
    space."""
    g = _phys_grads(sp)
    _, e_q = _at_q(sp, eps)
    return torch.einsum("q,mq,mq,mqad,mqbd->mab", sp.quad_w, sp.detj_q,
                        e_q, g, g)


def convection_rhs_locals(sp, u, flux):
    """(M,nloc) locals of r_a = int (f'(u_h) . grad u_h) phi_a dx; flux an
    ops.structured.Flux."""
    g = _phys_grads(sp)
    u_cell, u_q = _at_q(sp, u)
    grad_u = torch.einsum("mc,mqcd->mqd", u_cell, g)
    conv = torch.einsum("mqd,mqd->mq", _stack(flux.fprime_xy, u_q), grad_u)
    return torch.einsum("q,mq,mq,qa->ma", sp.quad_w, sp.detj_q, conv, sp.phi)


def flux_jacobian_locals(sp, u, flux):
    """Locals of d/du convection_rhs_flux:
    J_ab = int [(f''(u) . grad u) phi_b + f'(u) . grad phi_b] phi_a."""
    g = _phys_grads(sp)
    u_cell, u_q = _at_q(sp, u)
    fp, fpp = _stack(flux.fprime_xy, u_q), _stack(flux.fprime2_xy, u_q)
    grad_u = torch.einsum("mc,mqcd->mqd", u_cell, g)
    t1 = torch.einsum("mqd,mqd->mq", fpp, grad_u)
    term1 = torch.einsum("q,mq,mq,qa,qb->mab", sp.quad_w, sp.detj_q, t1,
                         sp.phi, sp.phi)
    t2 = torch.einsum("mqd,mqbd->mqb", fp, g)
    term2 = torch.einsum("q,mq,qa,mqb->mab", sp.quad_w, sp.detj_q, sp.phi,
                         t2)
    return term1 + term2


def assemble_mass(sp):
    return scatter_matrix(sp, mass_locals(sp))


def assemble_stiffness(sp):
    return scatter_matrix(sp, stiffness_locals(sp))


def assemble_convection(sp, w):
    return scatter_matrix(sp, convection_locals(sp, w))


def assemble_eps_stiffness(sp, eps):
    return scatter_matrix(sp, eps_stiffness_locals(sp, eps))


def convection_rhs_flux(sp, u, flux):
    return scatter_vector(sp, convection_rhs_locals(sp, u, flux))


def assemble_flux_jacobian(sp, u, flux):
    """ELL assembly of d/du convection_rhs_flux."""
    return scatter_matrix(sp, flux_jacobian_locals(sp, u, flux))


def mass_apply(sp, u):
    """M u without assembling M."""
    _, u_q = _at_q(sp, u)
    vals = torch.einsum("q,mq,mq,qa->ma", sp.quad_w, sp.detj_q, u_q, sp.phi)
    return scatter_vector(sp, vals)


def lumped_mass(sp):
    vals = torch.einsum("q,mq,qa->ma", sp.quad_w, sp.detj_q, sp.phi)
    return scatter_vector(sp, vals)


def quad_coords(sp):
    """Physical coordinates of the quadrature points (M,Q,2), through the
    isoparametric map x = sum_c phi_c(xi) X_c."""
    return torch.einsum("qc,mcd->mqd", sp.phi, sp.dof_coords[sp.cell_dofs])


def l2_error_vs_function(sp, u, exact_fn, t=None):
    """sqrt(int (u_h - u_ex)^2) with u_ex evaluated at the quadrature
    points."""
    _, u_q = _at_q(sp, u)
    xq = quad_coords(sp)
    ex = (exact_fn(xq[..., 0], xq[..., 1]) if t is None
          else exact_fn(xq[..., 0], xq[..., 1], t))
    return torch.sqrt(((u_q - ex) ** 2 * sp.quad_w[None, :]
                       * sp.detj_q).sum())
