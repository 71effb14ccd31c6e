"""The sharded blocked linear advection: the fast unstructured path of
models/linear_advection.py (``ell_matvec_backend="blocked"``) over
contiguous row ranges, ported from
conservation_fem_tpu/parallel/blocked_advection_sharded.py.

The layout, the halo and the block plans are parallel/blocked_sharded.py's.
The operators M, C and the bc-applied stiffness are the single-device
problem's, read by the blocks at their extended rows; the per-step
eps-stiffness is assembled on the block plans (kernel B) and every product
is kernel A. Covers gfem | rv_node | rv_node_simple | si with the adaptive
or fixed-iteration solvers (Chebyshev, cg_fixed, BiCGStab); rv_cell and
rk4 stay on parallel/unstructured_sharded.DistributedAdvection, as in the
JAX package. rv_node and rv_node_simple start with one plain GFEM step,
as the single-device solve does.
"""

from __future__ import annotations

import torch

from conservation_fem_tpu_torch.models.linear_advection import (BOOTSTRAPPED,
                                                               mass_solve)
from conservation_fem_tpu_torch.ops import blocked
from conservation_fem_tpu_torch.ops import stabilization as stab
from conservation_fem_tpu_torch.ops.krylov import (bicgstab, bicgstab_fixed,
                                                   chebyshev_fixed,
                                                   jacobi_preconditioner)
from conservation_fem_tpu_torch.ops.structured import tiny_of
from conservation_fem_tpu_torch.parallel.blocked_sharded import \
    DistributedBlocked

_SUPPORTED = ("gfem", "rv_node", "rv_node_simple", "si")


class DistributedBlockedAdvection(DistributedBlocked):
    """The sharded twin of a blocked AdvectionProblem; ``solve()`` returns
    u at T, the flat global vector in the problem's (RCM) numbering."""

    def __init__(self, problem, blocks):
        p = problem
        if p.plan is None or p.cfg.ell_matvec_backend != "blocked":
            raise ValueError("build the problem with "
                             "ell_matvec_backend='blocked'")
        if p.cfg.stabilization not in _SUPPORTED:
            raise NotImplementedError(
                f"distributed blocked advection: {p.cfg.stabilization!r} "
                "(rv_cell/rk4 live on DistributedAdvection)")
        self._setup_layout(p, blocks, p.plan, p.u0)
        self.M = self.ext_rows(p.M)
        self.C = self.ext_rows(p.C)
        self.Kbc = (self.ext_rows(p.K_bc) if p.cfg.stabilization == "si"
                    else None)
        self.h = self.own(p.h_cg) if p.h_cg is not None else None
        self.wn = self.own(torch.linalg.norm(p.w, dim=1))

    def make_step(self, stabilization=None):
        """step(u, uo) -> (u_new, u) on the held blocks' own rows."""
        p = self.p
        cfg, dt = p.cfg, p.dt
        stabz = stabilization or cfg.stabilization
        valid, pin = self.valid, self.pin
        pdot = self._pdot()
        M, C = self.M, self.C

        def step(u, uo):
            u, uo = torch.where(valid, u, 0.0), torch.where(valid, uo, 0.0)
            Keps = None
            if stabz != "gfem":
                ue = self.extend(u)
                if stabz == "si":
                    alpha = self.cut(blocked.si_alpha(
                        self.bp, self.Kbc, ue, eps_floor=cfg.si_eps))
                    eps = (stab.sigmoid_activation(alpha) * cfg.Cm * self.h
                           * self.wn)
                else:
                    rhs = (self.spmv(M, (u - uo) / dt)
                           + self.spmv(C, xe=ue))
                    diag = self.diag(M)
                    if stabz == "rv_node_simple":
                        # the projection without the bc (the reference's
                        # stored series)
                        Rh = mass_solve(
                            cfg, lambda x: self.spmv(M, x), rhs,
                            jacobi_preconditioner(torch.where(valid, diag,
                                                              1.0)),
                            dot=pdot)
                    else:
                        Rh = mass_solve(
                            cfg, self.constrained(M),
                            torch.where(pin, 0.0, rhs),
                            jacobi_preconditioner(torch.where(pin, 1.0,
                                                              diag)),
                            dot=pdot)
                    abs_term = self._abs_term(u)
                    if stabz == "rv_node":
                        bp = self.bp
                        n_i = (self.cut(blocked.patch_max(bp, ue)
                                        - blocked.patch_min(bp, ue))
                               - abs_term).abs()
                        R_i = (self.cut(blocked.patch_abs_max(
                                   bp, self.extend(Rh)))
                               / n_i.clamp_min(tiny_of(n_i.dtype)))
                    else:
                        R_i = Rh / abs_term
                    eps = torch.minimum(cfg.Cvel * self.h * self.wn,
                                        cfg.CRV * self.h**2 * R_i.abs())
                eps = torch.where(valid, eps, 0.0)
                Keps = blocked.assemble_matrix(
                    self.bp, blocked.eps_locals_components(
                        self.bp, self.extend(eps)))
            if Keps is None:
                A = M + 0.5 * dt * C
                B = M - 0.5 * dt * C
            else:
                A = M + 0.5 * dt * C + 0.5 * dt * Keps
                B = M - 0.5 * dt * C - 0.5 * dt * Keps
            b = torch.where(pin, 0.0, self.spmv(B, u))
            pre = jacobi_preconditioner(torch.where(pin, 1.0, self.diag(A)))
            op = self.constrained(A)
            ki = cfg.krylov_iters
            if ki is not None and cfg.inner_solver == "cheby":
                lo, hi = cfg.cheby_cn_bounds
                uh = chebyshev_fixed(op, b, x0=u, precond=pre, iters=ki,
                                     lmin=lo, lmax=hi).x
            elif ki is not None:
                uh = bicgstab_fixed(op, b, x0=u, precond=pre, iters=ki,
                                    dot=pdot).x
            else:
                uh = bicgstab(op, b, x0=u, precond=pre, rtol=cfg.krylov_rtol,
                              dot=pdot).x
            return uh, u

        return step

    def solve(self, num_steps=None):
        """The problem's num_steps steps from u0 (or its first num_steps),
        the GFEM bootstrap first for rv_node and rv_node_simple; the flat
        global solution."""
        stabz = self.p.cfg.stabilization
        n = self.p.num_steps if num_steps is None else num_steps
        step = self.make_step()
        carry = (self.u0, self.u0)
        if stabz in BOOTSTRAPPED and n > 0:
            carry, n = self.make_step("gfem")(*carry), n - 1
        for _ in range(n):
            carry = step(*carry)
        return self.gather(carry[0])
