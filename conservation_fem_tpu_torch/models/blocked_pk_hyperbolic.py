"""The blocked instantiation of the Pk scalar hyperbolic solver, ported
from conservation_fem_tpu/models/blocked_pk_hyperbolic.py.

The same step as PkHyperbolicProblem (equal to summation-order roundoff)
on an RCM-permuted dof numbering, its operators in ELL form and its hot
work on the hand-written ELL kernels (ops/blocked.py, ops/blocked_pk.py):
the products kernel A, the assemblies and scatters of the Pk locals
kernel B, the RV patch kernel D; the Pk quadrature locals stay plain
PyTorch. The Newton solve is Keps-free: the eps-stiffness action rides in
the residual's quadrature pass and the Jacobian is assembled once per
linearisation from the summed locals.

The dof permutation is internal: u0 and the Dirichlet data are evaluated
at the permuted dof coordinates, so solve() results live in the permuted
numbering; ``u_native = u_blocked[problem.dof_perm]`` (dof_perm maps old
-> new).
"""

from __future__ import annotations

import torch

from conservation_fem_tpu_torch.models.pk_hyperbolic import \
    PkHyperbolicProblem
from conservation_fem_tpu_torch.ops import blocked
from conservation_fem_tpu_torch.ops import blocked_pk as bpk
from conservation_fem_tpu_torch.ops import stabilization as stab
from conservation_fem_tpu_torch.ops.bc import constrain_residual
from conservation_fem_tpu_torch.ops.krylov import jacobi_preconditioner
from conservation_fem_tpu_torch.ops.spaces import (build_space, permute_dofs,
                                                   rcm_dof_permutation)


class BlockedPkHyperbolicProblem(PkHyperbolicProblem):
    """PkHyperbolicProblem on the blocked backend."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.plan = bpk.make_blocked_pk_plan(
            self.space, dtype=self.dtype,
            arrays=self.space.device_arrays(self.dtype, self.device))
        self._mesh = self.plan.mesh

    def _make_space(self, host_mesh, degree):
        space = build_space(host_mesh, degree)
        self.dof_perm = rcm_dof_permutation(space)
        return permute_dofs(space, self.dof_perm)

    @property
    def M(self):
        if self._M is None:
            self._M = blocked.assemble_matrix(
                self.plan, bpk.pk_mass_locals(self.plan))
        return self._M

    @property
    def K_bc(self):
        if self._K_bc is None and self.cfg.stabilization == "si":
            K = blocked.assemble_matrix(self.plan,
                                        bpk.pk_stiffness_locals(self.plan))
            self._K_bc = blocked.apply_bc_matrix(self.plan, K)
        return self._K_bc

    def _linear_op(self, D):
        return ((lambda x: blocked.spmv(self.plan, D, x)),
                blocked.diag_of(self.plan, D))

    def _constrained_op(self, D):
        bc = self.mesh.boundary_mask
        return ((lambda x: blocked.constrained_matvec(self.plan, D, x)),
                torch.where(bc, 1.0, blocked.diag_of(self.plan, D)))

    def _nonlinear_rhs(self, u):
        return bpk.pk_conv_plus_locals_rhs(self.plan, u, self.flux)

    def _assemble_keps(self, eps):
        return blocked.assemble_matrix(self.plan,
                                       bpk.pk_eps_locals(self.plan, eps))

    def _assemble_flux_jacobian(self, u):
        return blocked.assemble_matrix(
            self.plan, bpk.pk_flux_jacobian_locals(self.plan, u, self.flux))

    def _newton_cn(self, u_n, eps, g, N_un=None):
        """Keps-free CN Newton (cf. BlockedHyperbolicProblem's assembled
        solve): N_un is not used."""
        p, dt, flux = self.plan, self.dt, self.flux
        bc = self.mesh.boundary_mask
        L_keps = bpk.pk_eps_locals(p, eps)
        L_cn = bpk.pk_mass_locals(p) + 0.5 * dt * L_keps
        NK = lambda v: bpk.pk_conv_plus_locals_rhs(p, v, flux, L_keps)
        NK_un = NK(u_n)
        M_mv, _ = self._linear_op(self.M)

        def residual(v):
            F = M_mv(v - u_n) + 0.5 * dt * (NK(v) + NK_un)
            return constrain_residual(F, v, g, bc)

        def jacobian(u):
            J = blocked.assemble_matrix(
                p, L_cn + 0.5 * dt * bpk.pk_flux_jacobian_locals(p, u, flux))
            matvec, diag = self._constrained_op(J)
            return matvec, jacobi_preconditioner(diag)

        return self._newton_dispatch(residual, jacobian,
                                     torch.where(bc, g, u_n))

    def _epsilon(self, u_n, RH):
        cfg = self.cfg
        if cfg.stabilization == "rv":
            return blocked.rv_epsilon_nonlinear(
                self.plan, cfg.Cvel, cfg.CRV, u_n, u_n, self.flux, RH,
                self.h_cg)
        if cfg.stabilization == "si":
            beta = self.flux.fprime_norm(u_n)
            alpha = blocked.si_alpha(self.plan, self.K_bc, u_n,
                                     eps_floor=cfg.si_eps)
            return stab.sigmoid_activation(alpha) * cfg.Cm * self.h_cg * beta
        return torch.zeros_like(u_n)

    def _smooth(self, u):
        return blocked.smooth_vector(self.plan, u, self.cfg.smooth_l)
