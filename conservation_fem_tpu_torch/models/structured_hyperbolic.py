"""Structured (stencil-backend) scalar conservation-law solver, ported from
conservation_fem_tpu/models/structured_hyperbolic.py.

Same pipeline as the JAX model — BDF2 residual projection, RV or SI
epsilon, stabilised CN Newton, optional post-solve smoothing — with every
operator a 7-plane stencil (ops/structured.py). SI reads the bc-applied
stiffness as stencil planes (``stiffness_bc_coef``, built once), and the
smoothing is ``smooth_vector_grid``; neither has a whole-step kernel, as
in the JAX package. ``precise_reductions`` is accepted and changes nothing
here: the JAX structured step never reads its f64 dots either.

With ``use_kernels`` and fixed iteration counts each step is one of three
whole-step kernels, chosen by ``_fused_mode`` with
the JAX package's rule and thresholds so that a configuration launches
the counterpart of the kernel the JAX package launches: "single"
(ops/fused_step.fused_rv_step, one launch), "split"
(ops/fused_step.fused_rv_step_split, 1 + newton_iters launches) or
"tiled" (ops/tiled_step.tiled_rv_step, one launch). With ``use_kernels``
and adaptive solvers the mass solve is ops/stencil_kernels.cg_solve.

bf16 operator planes, f32 only (f64 runs ignore both options, bit for
bit): ``xla_bf16_planes`` makes the composed step's fixed-iteration mass
solve and Newton inner solves read bf16 copies of their planes
(``structured.sweep_form``), ``tiled_bf16_planes`` makes the tiled kernel
stream its solver planes as bf16 (ops/tiled_step.py); the single and split
kernels ignore it, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from conservation_fem_tpu_torch.models.scalar_hyperbolic import (
    HyperbolicProblem, SolveResult)
from conservation_fem_tpu_torch.ops import structured as st
from conservation_fem_tpu_torch.ops.krylov import (cg, cg_fixed,
                                                   chebyshev_fixed,
                                                   jacobi_preconditioner)
from conservation_fem_tpu_torch.ops.newton import newton_fixed, newton_solve


class StructuredHyperbolicProblem(HyperbolicProblem):
    """Construct via structure()."""

    def init_structured(self, nx: int, ny: int):
        self.sd = st.build_structured(self.host_mesh, nx, ny, self.dtype,
                                      self.device)
        self._shape2 = (nx + 1, ny + 1)
        hm = self.host_mesh
        # host-side f64 geometry for the fused step's constant table
        self._fused_static = dict(
            area=float(hm.area[0]), h=float(hm.h_cell[0]),
            grads=np.stack([hm.grads[0], hm.grads[nx * ny]]),
            phi=st._quad_basis(), qw=st._DUN4_W * 0.5)
        # g in grid form (the frame nodes are the mesh's boundary nodes)
        self._g_shape, self._g2 = self._shape2, None
        self._K_bc_coef = (st.stiffness_bc_coef(self.sd)
                           if self.cfg.stabilization == "si" else None)
        self._mc16 = None   # the tiled bf16 instance's mass planes
        return self

    def _force_lazy_operators(self):
        """Nothing to build: the stencil step reads sd's planes, not the
        ELL operators."""

    # -- 2D pipeline ---------------------------------------------------------

    def _residual_bdf2_2d(self, u2, uo2, uoo2, N_u=None):
        sd, dt, cfg = self.sd, self.dt, self.cfg
        if cfg.residual_scheme == "bdf1":
            du = (u2 - uo2) / dt
        else:
            du = (3.0 * u2 - 4.0 * uo2 + uoo2) / (2.0 * dt)
        if N_u is None:
            N_u = st.nonlinear_rhs(sd, u2, self.flux)
        rhs = torch.where(sd.bc2, 0.0, st.mass_matvec(sd, du) + N_u)
        op = lambda x2: st.constrained_matvec(sd, sd.M_coef, x2)
        pre = jacobi_preconditioner(torch.where(sd.bc2, 1.0, sd.diagM2))
        if cfg.cg_iters is not None:
            # only the fixed-iteration sweeps may read bf16 planes
            # (xla_bf16_planes): the adaptive CG keeps the exact operator,
            # which a perturbed one could keep from reaching its rtol
            Mc = st.sweep_form(sd.M_coef, cfg.xla_bf16_planes)
            op = lambda x2: st.constrained_matvec(sd, Mc, x2)
            if cfg.inner_solver == "cheby":
                lo, hi = cfg.cheby_mass_bounds
                return chebyshev_fixed(op, rhs, precond=pre,
                                       iters=cfg.cg_iters, lmin=lo,
                                       lmax=hi).x
            return cg_fixed(op, rhs, precond=pre, iters=cfg.cg_iters).x
        if cfg.use_kernels:
            from conservation_fem_tpu_torch.ops import stencil_kernels as sk

            return sk.cg_solve(sd.M_coef, rhs, sd.bc2, sd.diagM2,
                               rtol=cfg.krylov_rtol)
        return cg(op, rhs, precond=pre, rtol=cfg.krylov_rtol).x

    def _newton_cn_2d(self, u2, eps2, g2, N_un=None):
        sd, dt, cfg = self.sd, self.dt, self.cfg
        Kc = st.keps_coef(sd, eps2)
        if N_un is None:
            N_un = st.nonlinear_rhs(sd, u2, self.flux)
        Kc_un = st.matvec(sd, Kc, u2)
        base = sd.M_coef + 0.5 * dt * Kc

        def residual(v2):
            F = (st.mass_matvec(sd, v2 - u2)
                 + 0.5 * dt * (st.nonlinear_rhs(sd, v2, self.flux) + N_un)
                 + 0.5 * dt * (st.matvec(sd, Kc, v2) + Kc_un))
            return torch.where(sd.bc2, v2 - g2, F)

        def jacobian(v2):
            J = base + 0.5 * dt * st.flux_jacobian_coef(sd, v2, self.flux)
            # the inner solve's sweeps alone read the (optionally bf16)
            # copy; the Jacobi diagonal and the Newton residual stay exact
            Js = st.sweep_form(J, cfg.xla_bf16_planes)
            mv = lambda x2: st.constrained_matvec(sd, Js, x2)
            pre = jacobi_preconditioner(torch.where(sd.bc2, 1.0, J[0]))
            return mv, pre

        u_init = torch.where(sd.bc2, g2, u2)
        if cfg.newton_iters is not None:
            return newton_fixed(
                residual, u_init, iters=cfg.newton_iters,
                linear_iters=cfg.newton_linear_iters, jacobian_fn=jacobian,
                freeze_jacobian=cfg.modified_newton, rtol=cfg.newton_rtol,
                atol=cfg.newton_atol, linear_solver=cfg.inner_solver,
                cheby_bounds=cfg.cheby_lin_bounds,
                final_residual=cfg.newton_final_residual)
        return newton_solve(
            residual, u_init, rtol=cfg.newton_rtol, atol=cfg.newton_atol,
            max_it=cfg.newton_max_it, linear_rtol=cfg.newton_linear_rtol or cfg.krylov_rtol,
            jacobian_fn=jacobian, freeze_jacobian=cfg.modified_newton)

    # -- fused whole-step path ------------------------------------------------

    def _fused_mode(self):
        """The whole-step kernel of this problem, by the JAX package's rule
        (models/structured_hyperbolic._fused_mode): with kernels on, fixed
        iteration counts, rv or gfem and no smoothing, "single" up to 270
        KiB per field, "split" up to 1100 KiB, "tiled" beyond for the cheby
        or bicgstab inner solver; otherwise None. The thresholds are the
        TPU's VMEM gates, kept so that both packages pick counterpart
        kernels."""
        cfg = self.cfg
        if not (cfg.use_kernels
                and cfg.cg_iters is not None and cfg.newton_iters is not None
                and cfg.stabilization in ("rv", "gfem")
                and cfg.smooth_l == 0):
            return None
        per_field = ((self.sd.nx + 1) * (self.sd.ny + 1)
                     * self.u0.element_size())
        if per_field <= 270 * 2**10:
            return "single"
        if per_field <= 1100 * 2**10:
            return "split"
        if cfg.inner_solver in ("cheby", "bicgstab"):
            return "tiled"
        return None

    def fused_step_kwargs(self):
        """Keyword arguments of the three whole-step kernels
        (ops/fused_step.fused_rv_step, fused_rv_step_split,
        ops/tiled_step.tiled_rv_step) for this problem: everything but the
        fields, ``n_substeps`` (single) and ``tile_rows`` (tiled)."""
        cfg, sd, fs = self.cfg, self.sd, self._fused_static
        return dict(
            nx=sd.nx, ny=sd.ny, dt=self.dt, area=fs["area"], h=fs["h"],
            grads=fs["grads"], phi=fs["phi"], qw=fs["qw"], Cvel=cfg.Cvel,
            CRV=cfg.CRV, flux=self.flux, cg_iters=cfg.cg_iters,
            newton_iters=cfg.newton_iters, lin_iters=cfg.newton_linear_iters,
            freeze_jacobian=cfg.modified_newton,
            residual_scheme=cfg.residual_scheme,
            stabilization=cfg.stabilization, inner_solver=cfg.inner_solver,
            mass_bounds=cfg.cheby_mass_bounds,
            lin_bounds=cfg.cheby_lin_bounds)

    def _fused_call(self, carry, g2, n_substeps):
        from conservation_fem_tpu_torch.ops.fused_step import fused_rv_step

        u2, uo2, uoo2 = (v.reshape(self._shape2) for v in carry)
        out = fused_rv_step(u2, uo2, uoo2, g2, self.sd.M_coef,
                            n_substeps=n_substeps, **self.fused_step_kwargs())
        return tuple(v.reshape(-1) for v in out)

    def _step_fused(self, carry, g2):
        mode = self._fused_mode()
        if mode == "single":
            return self._fused_call(carry, g2, 1), None
        from conservation_fem_tpu_torch.ops.fused_step import (
            fused_rv_step_split)
        from conservation_fem_tpu_torch.ops.tiled_step import tiled_rv_step

        step_fn = fused_rv_step_split if mode == "split" else tiled_rv_step
        # the tiled kernel alone reads tiled_bf16_planes, as in JAX
        extra = {}
        if mode == "tiled" and self.cfg.tiled_bf16_planes:
            extra = dict(bf16_planes=True, mc16=self._mass_planes_bf16())
        u2, uo2, uoo2 = (v.reshape(self._shape2) for v in carry)
        uh = step_fn(u2, uo2, uoo2, g2, self.sd.M_coef,
                     **self.fused_step_kwargs(), **extra)
        return (uh.reshape(-1), carry[0], carry[1]), None

    def _mass_planes_bf16(self):
        """The bf16 mass planes of the tiled kernel's bf16 instance, made
        once (M_coef never changes); None where the wrapper reads none
        (the CPU, f64)."""
        if self.sd.M_coef.device.type != "cuda" or self.dtype != torch.float32:
            return None
        if self._mc16 is None:
            from conservation_fem_tpu_torch.ops.tiled_step import (
                bf16_planes_of)

            self._mc16 = bf16_planes_of(self.sd.M_coef)
        return self._mc16

    def _fused_multistep_ok(self):
        """K steps per launch: the single kernel, time-independent
        Dirichlet data (g is formed once), no per-step metrics."""
        return (self.cfg.fused_substeps > 1
                and self._fused_mode() == "single"
                and getattr(self, "bc_static", False)
                and not self.cfg.record_metrics)

    def solve(self, **kw):
        if kw or not self._fused_multistep_ok():
            return super().solve(**kw)
        K = self.cfg.fused_substeps
        n_chunks, rem = divmod(self.num_steps - self._start_step, K)
        g2 = self.dirichlet_grid(self.dirichlet_frames([self.dt])[0])
        carry = self._initial_carry()
        for n_sub in [K] * n_chunks + ([rem] if rem else []):
            carry = self._fused_call(carry, g2, n_sub)
        return SolveResult(u=carry[0], metrics=None, dt=self.dt,
                           num_steps=self.num_steps)

    def step(self, carry, t, g2=None):
        if g2 is None:
            g2 = self.dirichlet_grid(self.dirichlet_frames([t])[0])
        if self._fused_mode() is not None and not self.cfg.record_metrics:
            return self._step_fused(carry, g2)
        u_n = carry[0]
        u2, uo2, uoo2 = (v.reshape(self._shape2) for v in carry)
        # one quadrature pass for N(u_n), shared by the residual
        # projection and the Newton frozen term
        N_un = st.nonlinear_rhs(self.sd, u2, self.flux)
        cfg = self.cfg
        if cfg.stabilization == "rv":
            RH2 = self._residual_bdf2_2d(u2, uo2, uoo2, N_u=N_un)
            eps2 = st.rv_epsilon(self.sd, cfg.Cvel, cfg.CRV, u2, RH2,
                                 self.flux.fprime_norm)
        elif cfg.stabilization == "si":
            eps2 = st.si_epsilon_grid(self.sd, cfg.Cm, self._K_bc_coef, u2,
                                      self.flux.fprime_norm(u2),
                                      eps_floor=cfg.si_eps)
        else:
            eps2 = torch.zeros_like(u2)
        res = self._newton_cn_2d(u2, eps2, g2, N_un=N_un)
        uh = res.u
        if cfg.smooth_l > 0:
            uh = st.smooth_vector_grid(self.sd, uh, cfg.smooth_l)
        uh = uh.reshape(-1)
        metrics = None
        if self.cfg.record_metrics:
            metrics = {
                "eps_max": eps2.max(),
                "newton_iters": res.iters,
                "newton_converged": res.converged,
                "residual_norm": res.residual_norm,
                "u_min": uh.min(),
                "u_max": uh.max(),
            }
        return (uh, u_n, carry[1]), metrics


def structure(problem: HyperbolicProblem, nx: int, ny: int):
    """Upgrade a built HyperbolicProblem to the stencil backend in place."""
    problem.__class__ = StructuredHyperbolicProblem
    return problem.init_structured(nx, ny)
