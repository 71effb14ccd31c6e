"""The blocked and blocked2d instantiation of the scalar hyperbolic
solver, ported from conservation_fem_tpu/models/blocked_hyperbolic.py.

The same step as HyperbolicProblem (equal to summation-order roundoff) on
an RCM-ordered mesh (blocked) or a tile-slot mesh (blocked2d,
ops/tiling.tile_mesh), with every operator in the ELL form of that
numbering and the hot work on the hand-written ELL kernels of
ops/blocked.py (plain PyTorch on the CPU):

  * the residual projection: the mass product and its constrained solve
    (kernel A), N(u_n) (kernels C and B);
  * RV epsilon: the global term in PyTorch, the patch kernel D (phantom
    slots of a tile-slot mesh kept out through ``plan.row_valid``);
  * the CN Newton solve with the Keps-free assembled Jacobian: the
    eps-stiffness action rides in the residual's quadrature pass (kernel C
    forms N(v) + K_eps v, kernel B sums it), and the Jacobian M + dt/2
    (K_eps + C'(u)) is assembled once per linearisation from the summed
    cell locals (kernels C and B); each inner product is kernel A in its
    constrained mode. ``blocked_matrix_free`` keeps the Jacobian as cell
    locals applied by ops/blocked.local_apply instead;
  * h_cg from the ELL mass, the SI stiffness with its bc, smoothing by the
    patch sum of kernel A.
The JAX package's jit-state plumbing (its plan rides through jit as an
argument for the TPU's remote compile) has no counterpart here.
"""

from __future__ import annotations

import torch

from conservation_fem_tpu_torch.models.scalar_hyperbolic import \
    HyperbolicProblem
from conservation_fem_tpu_torch.ops import assembly, blocked
from conservation_fem_tpu_torch.ops import stabilization as stab
from conservation_fem_tpu_torch.ops.bc import constrain_residual
from conservation_fem_tpu_torch.ops.krylov import jacobi_preconditioner


class BlockedHyperbolicProblem(HyperbolicProblem):
    """HyperbolicProblem on the blocked backends. The mesh must be
    RCM-ordered (blocked) or a tiling.tile_mesh mesh (blocked2d: its
    solution lives in slot numbering, and ``make_tiled_plan`` raises
    WindowCoverageError where the JAX package's would)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        arrays = self.host_mesh.device_arrays(self.dtype, self.device)
        make = (blocked.make_tiled_plan
                if self.cfg.ell_matvec_backend == "blocked2d"
                else blocked.make_blocked_plan)
        self.plan = make(self.host_mesh, dtype=self.dtype, arrays=arrays)
        self._mesh = self.plan.mesh

    # -- operators ----------------------------------------------------------

    @property
    def M(self):
        """The consistent mass, assembled by kernel B."""
        if self._M is None:
            self._M = blocked.assemble_matrix(
                self.plan, blocked.mass_locals_components(self.plan))
        return self._M

    @property
    def K_bc(self):
        """The SI stiffness with its bc, assembled by kernel B."""
        if self._K_bc is None and self.cfg.stabilization == "si":
            m = self.mesh
            K = blocked.assemble_matrix(
                self.plan, assembly.local_stiffness(m.area, m.grads))
            self._K_bc = blocked.apply_bc_matrix(self.plan, K)
        return self._K_bc

    def _linear_op(self, D):
        return ((lambda x: blocked.spmv(self.plan, D, x)),
                blocked.diag_of(self.plan, D))

    def _constrained_op(self, D):
        bc = self.mesh.boundary_mask
        return ((lambda x: blocked.constrained_matvec(self.plan, D, x)),
                torch.where(bc, 1.0, blocked.diag_of(self.plan, D)))

    # -- step pieces ----------------------------------------------------------

    def _nonlinear_rhs(self, u):
        return blocked.conv_rhs_components(self.plan, u, self.flux)

    def _assemble_keps(self, eps):
        return blocked.assemble_matrix(
            self.plan, blocked.eps_locals_components(self.plan, eps))

    def _assemble_flux_jacobian(self, u):
        return blocked.assemble_matrix(
            self.plan,
            blocked.flux_jacobian_locals_components(self.plan, u, self.flux))

    def _newton_cn(self, u_n, eps, g, N_un=None):
        """The blocked CN Newton solve: assembled (default) or
        matrix-free. N_un (N(u_n) alone) is not used: the residual's
        pass forms N(u_n) + K_eps u_n itself."""
        if self.cfg.blocked_matrix_free:
            return self._newton_cn_matrix_free(u_n, eps, g)
        return self._newton_cn_assembled(u_n, eps, g)

    def _newton_cn_assembled(self, u_n, eps, g):
        """F(v) = M (v - u_n) + dt/2 (NK(v) + NK(u_n)), NK(v) = N(v) +
        K_eps v from one quadrature pass; the Jacobian assembled from the
        summed locals M + dt/2 (K_eps + C'(u))."""
        p, dt, flux = self.plan, self.dt, self.flux
        bc = self.mesh.boundary_mask
        NK = lambda v: blocked.conv_plus_locals_rhs_components(p, v, flux,
                                                               eps)
        NK_un = NK(u_n)
        M_mv, _ = self._linear_op(self.M)

        def residual(v):
            F = M_mv(v - u_n) + 0.5 * dt * (NK(v) + NK_un)
            return constrain_residual(F, v, g, bc)

        def jacobian(u):
            J = blocked.assemble_matrix(
                p, blocked.newton_locals(p, u, eps, 0.5 * dt, flux))
            matvec, diag = self._constrained_op(J)
            return matvec, jacobi_preconditioner(diag)

        return self._newton_dispatch(residual, jacobian,
                                     torch.where(bc, g, u_n))

    def _newton_cn_matrix_free(self, u_n, eps, g):
        """The same solve with K_eps and the Jacobian kept as cell locals
        (ops/blocked.local_apply); the mass product assembled."""
        p, dt = self.plan, self.dt
        bc = self.mesh.boundary_mask
        L_keps = blocked.eps_locals_components(p, eps)
        L_cn = blocked.mass_locals_components(p) + 0.5 * dt * L_keps
        N_un = self._nonlinear_rhs(u_n)
        M_mv, _ = self._linear_op(self.M)
        K_mv = lambda x: blocked.local_apply(p, L_keps, x)
        Keps_un = K_mv(u_n)

        def residual(v):
            F = (M_mv(v - u_n)
                 + 0.5 * dt * (self._nonlinear_rhs(v) + N_un)
                 + 0.5 * dt * (K_mv(v) + Keps_un))
            return constrain_residual(F, v, g, bc)

        def jacobian(u):
            L_J = L_cn + 0.5 * dt * blocked.flux_jacobian_locals_components(
                p, u, self.flux)
            J_mv = lambda v: blocked.local_apply(p, L_J, v)
            matvec = lambda v: torch.where(bc, v,
                                           J_mv(torch.where(bc, 0.0, v)))
            diag = torch.where(bc, 1.0, blocked.local_diag(p, L_J))
            return matvec, jacobi_preconditioner(diag)

        return self._newton_dispatch(residual, jacobian,
                                     torch.where(bc, g, u_n))

    def _epsilon(self, u_n, RH):
        cfg = self.cfg
        if cfg.stabilization == "rv":
            return blocked.rv_epsilon_nonlinear(
                self.plan, cfg.Cvel, cfg.CRV, u_n, u_n, self.flux, RH,
                self.h_cg, precise=cfg.precise_reductions,
                valid=self.plan.row_valid)
        if cfg.stabilization == "si":
            beta = self.flux.fprime_norm(u_n)
            alpha = blocked.si_alpha(self.plan, self.K_bc, u_n,
                                     eps_floor=cfg.si_eps)
            return stab.sigmoid_activation(alpha) * cfg.Cm * self.h_cg * beta
        return torch.zeros_like(u_n)

    def _smooth(self, u):
        return blocked.smooth_vector(self.plan, u, self.cfg.smooth_l)
