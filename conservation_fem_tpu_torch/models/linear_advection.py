"""Linear advection u_t + w . grad u = 0: solid-body rotation on the unit
disk (or the unit square), Crank-Nicolson in time, P1 in space; the port
of conservation_fem_tpu/models/linear_advection.py.

Steps (``AdvectionConfig.stabilization``):

  * gfem           — unstabilised Galerkin CN;
  * rv_node        — node-based residual viscosity (Cvel 0.25, CRV 1.0);
  * rv_node_simple — globally normalised node RV with the unconstrained
                     residual projection;
  * rv_cell        — cell-based residual viscosity;
  * si             — smoothness-indicator viscosity (Cm 0.5, stiffness
                     assembled once with the bc);
  * rk4            — explicit RK4 with a mass solve per stage.

Reference behaviours kept on purpose, as in the JAX package:
  * w = 2 pi (-y, x); dt = CFL hmax / ||w||_inf with ||.||_inf the max ROW
    SUM |wx| + |wy| of the (N,2) array;
  * IC = 0.5 (1 - tanh(((x-0.3)^2 + y^2) / 0.25^2 - 1)); homogeneous
    Dirichlet data on the whole boundary;
  * ceil(T / dt) steps, the last one not clamped to T;
  * rv_node, rv_node_simple and rv_cell start with ONE plain GFEM step so
    that a BDF1 residual exists;
  * the BDF1 residual projection M Rh = M (u_n - u_old)/dt + C u_n is
    solved with the bc (rv_node_simple: without);
  * rv_cell normalises Rh by the plain max of u_n - mean(u_n), not the
    inf-norm, and scatters last-cell-wins in file cell order;
  * the L2 error is taken against the P1 interpolant of the IC, through
    the mass matrix.

The operators are (N,K) ELL matrices over the mesh's node patches (plain
PyTorch gathers and segmented sums on the card: the JAX package runs this
model as XLA gathers, not Pallas). ``ell_matvec_backend="banded"`` applies
them through the hand-written ELL SpMV kernel (ops/ell_kernels.ell_spmv);
``"blocked"`` RCM-orders the mesh (the solution then in RCM numbering, as
in the JAX package) and also assembles through the ELL assembly kernel
(ops/blocked.py); rv_cell's last-cell-wins scatter has no blocked form and
is refused there, as in the JAX package (``rv_cell_scatter="max"`` runs).
The JAX ``lax.scan`` time loop is a Python loop; the adaptive solvers read
one scalar a iteration on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.ops import assembly, blocked
from conservation_fem_tpu_torch.ops import stabilization as stab
from conservation_fem_tpu_torch.ops.bc import ell_with_bc
from conservation_fem_tpu_torch.ops.ell_kernels import ell_spmv
from conservation_fem_tpu_torch.ops.helpers import get_nodal_h_ell
from conservation_fem_tpu_torch.ops.krylov import (bicgstab, bicgstab_fixed,
                                                   cg, cg_fixed,
                                                   chebyshev_fixed, dot,
                                                   jacobi_preconditioner)
from conservation_fem_tpu_torch.ops.mesh import (Mesh, MeshArrays, disk_mesh,
                                                 rcm_permutation,
                                                 rectangle_mesh, reorder_mesh,
                                                 with_kernel_index)
from conservation_fem_tpu_torch.ops.spmv import ell_diag, ell_matvec

STABILIZATIONS = ("gfem", "rv_node", "rv_node_simple", "rv_cell", "si", "rk4")
# the steps that start with one plain GFEM step (a BDF1 residual needs u_old)
BOOTSTRAPPED = ("rv_node", "rv_node_simple", "rv_cell")


@dataclasses.dataclass(frozen=True)
class AdvectionConfig:
    mesh_size: int = 32            # hmax = 1/mesh_size
    domain: str = "disk"           # "disk" | "square"
    stabilization: str = "gfem"    # gfem | rv_node | rv_node_simple
                                   #   | rv_cell | si | rk4
    CFL: float = 0.5
    T: float = 1.0
    Cvel: float = 0.25
    CRV: float = 1.0
    Cm: float = 0.5
    si_eps: float = 1e-8           # SI: floor of alpha's denominator
    discontinuous_ic: bool = False  # indicator-disk IC
    # rv_cell epsilon scatter: "last" = last-cell-wins in file cell order
    # (the reference's loop), "max" = the order-independent variant
    rv_cell_scatter: str = "last"
    # blocked backend: the JAX package's quality flag, accepted and read by
    # nothing (see HyperbolicConfig.blocked_precise)
    blocked_precise: bool = True
    krylov_rtol: float = 1e-12
    # "gather" ((N,K) gather and row sum), "banded" (the ELL SpMV kernel)
    # or "blocked" (RCM order, the ELL SpMV and assembly kernels)
    ell_matvec_backend: str = "gather"
    # fixed-iteration solvers (None = adaptive to krylov_rtol). cg_iters:
    # the BDF1-residual and RK4 mass solves; krylov_iters: the CN solve.
    # inner_solver="cheby" runs both as dot-free Chebyshev semi-iterations
    # over the bounds below (mass: Wathen's Jacobi bounds; the CN matrix
    # M + dt/2 (C + Keps) is a small skew perturbation of M)
    cg_iters: int | None = None
    krylov_iters: int | None = None
    inner_solver: str = "bicgstab"   # bicgstab | cheby
    cheby_mass_bounds: tuple = (0.5, 2.0)
    cheby_cn_bounds: tuple = (0.4, 2.2)
    dtype: str = "float64"


def check_supported(cfg: AdvectionConfig):
    """Raise for unknown options, and NotImplementedError naming the
    ROADMAP item for the JAX package's options this port does not have
    yet."""
    if cfg.stabilization not in STABILIZATIONS:
        raise ValueError(f"unknown stabilization {cfg.stabilization!r}")
    if cfg.domain not in ("disk", "square"):
        raise ValueError(f"unknown domain {cfg.domain!r}")
    if cfg.rv_cell_scatter not in ("last", "max"):
        raise ValueError(f"unknown rv_cell_scatter {cfg.rv_cell_scatter!r}")
    if cfg.inner_solver not in ("bicgstab", "cheby"):
        raise ValueError(f"unknown inner_solver {cfg.inner_solver!r}")
    mv = cfg.ell_matvec_backend
    if mv not in ("gather", "banded", "blocked"):
        raise ValueError(f"unknown ell_matvec_backend {mv!r}")
    if (mv == "blocked" and cfg.stabilization == "rv_cell"
            and cfg.rv_cell_scatter == "last"):
        raise NotImplementedError(
            "rv_cell's last-cell-wins scatter is cell-order-dependent "
            "and has no window form; use rv_cell_scatter='max' (the "
            "order-independent variant the distributed path uses) or "
            "the gather backend")


def initial_condition(x, y, r0=0.25, x0=0.3, y0=0.0):
    """Smooth bump 0.5 (1 - tanh(|x - (x0, y0)|^2 / r0^2 - 1))."""
    return 0.5 * (1.0 - torch.tanh(((x - x0) ** 2 + (y - y0) ** 2) / r0**2
                                   - 1.0))


def initial_condition_discont(x, y, r0=0.25, x0=0.3, y0=0.0):
    """Indicator of the disk of radius r0 about (x0, y0)."""
    return ((x - x0) ** 2 + (y - y0) ** 2 <= r0**2).to(x.dtype)


def velocity(points):
    """Solid rotation w = 2 pi (-y, x), (N,2)."""
    return 2.0 * math.pi * torch.stack([-points[:, 1], points[:, 0]], dim=1)


def cfl_time_step(CFL, hmax, T, w):
    """(dt, num_steps): dt = CFL hmax / ||w||_inf, the max row sum |wx| +
    |wy| (the reference's matrix inf-norm of the (N,2) array, kept), and
    ceil(T / dt) steps, as the JAX package forms them."""
    w_inf = float(w.abs().sum(dim=1).max())
    dt = CFL * hmax / w_inf
    return dt, int(np.ceil(T / dt))


@dataclasses.dataclass
class AdvectionProblem:
    cfg: AdvectionConfig
    host_mesh: Mesh
    dt: float
    num_steps: int
    mesh: MeshArrays     # the mesh's tensors on the problem's device
    w: torch.Tensor      # (N,2)
    M: torch.Tensor      # ELL mass
    C: torch.Tensor      # ELL convection
    h_cg: torch.Tensor | None   # nodal h (rv / si variants)
    K_bc: torch.Tensor | None   # bc-applied ELL stiffness (si)
    u0: torch.Tensor     # (N,) initial condition
    plan: object = None  # ops/blocked.BlockedPlan (blocked backend)


def build(cfg: AdvectionConfig | None = None, device=None,
          host_mesh: Mesh | None = None, **kw) -> AdvectionProblem:
    """The advection problem on ``device`` (None: the card; raises without
    one. device="cpu" for the CPU), on disk_mesh(1 / mesh_size), the
    structured unit square, or the ``host_mesh`` given."""
    if cfg is None:
        cfg = AdvectionConfig(**kw)
    check_supported(cfg)
    device = get_device(device)
    dtype = getattr(torch, cfg.dtype)
    hmax = 1.0 / cfg.mesh_size
    if host_mesh is None:
        host_mesh = (disk_mesh(hmax) if cfg.domain == "disk" else
                     rectangle_mesh((0, 0), (1, 1), nx=cfg.mesh_size))
    plan = None
    if cfg.ell_matvec_backend == "blocked":
        host_mesh = reorder_mesh(host_mesh, rcm_permutation(host_mesh))
        plan = blocked.make_blocked_plan(host_mesh, dtype=dtype,
                                         device=device)
        m = plan.mesh
    else:
        m = host_mesh.device_arrays(dtype, device)
        if cfg.ell_matvec_backend == "banded":
            m = with_kernel_index(m)
    w = velocity(m.points)
    dt, num_steps = cfl_time_step(cfg.CFL, hmax, cfg.T, w)
    if plan is not None:
        M = blocked.assemble_matrix(plan, assembly.local_mass(m.area))
        C = blocked.assemble_matrix(plan, assembly.local_convection(
            m.area, m.grads, w[m.cells]))
    else:
        M = assembly.assemble_mass(m)
        C = assembly.assemble_convection(m, w)
    h_cg = K_bc = None
    if cfg.stabilization in ("rv_node", "rv_node_simple", "rv_cell", "si"):
        h_cg = get_nodal_h_ell(m, mass_ell=M)
    if cfg.stabilization == "si":
        K = (blocked.assemble_matrix(plan, assembly.local_stiffness(
            m.area, m.grads)) if plan is not None
            else assembly.assemble_stiffness(m))
        K_bc = ell_with_bc(m, K, m.boundary_mask)
    icfn = (initial_condition_discont if cfg.discontinuous_ic
            else initial_condition)
    u0 = icfn(m.points[:, 0], m.points[:, 1]).to(dtype)
    return AdvectionProblem(cfg=cfg, host_mesh=host_mesh, dt=dt,
                            num_steps=num_steps, mesh=m, w=w, M=M, C=C,
                            h_cg=h_cg, K_bc=K_bc, u0=u0, plan=plan)


# ---------------------------------------------------------------------------
# step pieces
# ---------------------------------------------------------------------------


def _linear_op(p, A):
    """(matvec, diag) of an ELL operator: the gather product, or the ELL
    SpMV kernel on the banded and blocked backends (p: an advection
    problem of either degree)."""
    if p.cfg.ell_matvec_backend in ("banded", "blocked"):
        return (lambda x: ell_spmv(p.mesh, A, x)), ell_diag(p.mesh, A)
    return (lambda x: ell_matvec(p.mesh, A, x)), ell_diag(p.mesh, A)


def _assemble_keps(p, eps):
    """The eps-stiffness of the P1 problem p (the assembly kernel on the
    blocked backend)."""
    if p.plan is not None:
        return blocked.assemble_matrix(
            p.plan, blocked.eps_locals_components(p.plan, eps))
    return assembly.assemble_eps_stiffness(p.mesh, eps)


def _constrained(bc, mv):
    """x -> A_bc x: bc rows and columns of A replaced by the identity."""
    return lambda x: torch.where(bc, x, mv(torch.where(bc, 0.0, x)))


def cn_operators(p, Keps):
    """(A, B) = (M + dt/2 C + dt/2 Keps, M - dt/2 C - dt/2 Keps), in the
    JAX linear_advection's order of operations (Keps None: without it)."""
    dt = p.dt
    if Keps is None:
        return p.M + 0.5 * dt * p.C, p.M - 0.5 * dt * p.C
    return (p.M + 0.5 * dt * p.C + 0.5 * dt * Keps,
            p.M - 0.5 * dt * p.C - 0.5 * dt * Keps)


def cn_solve(p, A, B, u_n, cn_bounds=None):
    """One Crank-Nicolson solve A u = B u_n with u|bc = 0, from u_n, by
    the configured solver (the Chebyshev bounds default to the
    config's)."""
    cfg = p.cfg
    bc = p.mesh.boundary_mask
    A_mv, A_diag = _linear_op(p, A)
    B_mv, _ = _linear_op(p, B)
    b = torch.where(bc, 0.0, B_mv(u_n))
    pre = jacobi_preconditioner(torch.where(bc, 1.0, A_diag))
    op = _constrained(bc, A_mv)
    ki = cfg.krylov_iters
    if ki is not None and cfg.inner_solver == "cheby":
        lo, hi = cn_bounds or cfg.cheby_cn_bounds
        return chebyshev_fixed(op, b, x0=u_n, precond=pre, iters=ki,
                               lmin=lo, lmax=hi).x
    if ki is not None:
        return bicgstab_fixed(op, b, x0=u_n, precond=pre, iters=ki).x
    return bicgstab(op, b, x0=u_n, precond=pre, rtol=cfg.krylov_rtol).x


def mass_solve(cfg, op, rhs, pre, bounds=None, dot=dot):
    """M x = rhs by the configured solver: adaptive CG to krylov_rtol, or
    cg_iters of CG or Chebyshev (bounds default to the config's); dot: the
    CG's inner product (the sharded twins pass their block-ordered one)."""
    ci = cfg.cg_iters
    if ci is not None and cfg.inner_solver == "cheby":
        lo, hi = bounds or cfg.cheby_mass_bounds
        return chebyshev_fixed(op, rhs, precond=pre, iters=ci, lmin=lo,
                               lmax=hi).x
    if ci is not None:
        return cg_fixed(op, rhs, precond=pre, iters=ci, dot=dot).x
    return cg(op, rhs, precond=pre, rtol=cfg.krylov_rtol, dot=dot).x


def _bdf1_rhs(p, u_n, u_old):
    """(M (u_n - u_old)/dt + C u_n, M's matvec and diagonal)."""
    M_mv, M_diag = _linear_op(p, p.M)
    C_mv, _ = _linear_op(p, p.C)
    return M_mv((u_n - u_old) / p.dt) + C_mv(u_n), M_mv, M_diag


def residual_bdf1(p, u_n, u_old, bounds=None):
    """Solve M Rh = M (u_n - u_old)/dt + C u_n with Rh|bc = 0 (bounds: the
    Chebyshev mass bounds, default the config's)."""
    bc = p.mesh.boundary_mask
    rhs, M_mv, M_diag = _bdf1_rhs(p, u_n, u_old)
    pre = jacobi_preconditioner(torch.where(bc, 1.0, M_diag))
    return mass_solve(p.cfg, _constrained(bc, M_mv),
                      torch.where(bc, 0.0, rhs), pre, bounds)


def residual_bdf1_nobc(p: AdvectionProblem, u_n, u_old):
    """The same projection with no boundary condition on the mass solve
    (the variant that produced the reference's stored RV_node series)."""
    rhs, M_mv, M_diag = _bdf1_rhs(p, u_n, u_old)
    return mass_solve(p.cfg, M_mv, rhs, jacobi_preconditioner(M_diag))


def _wnorm(p):
    return torch.linalg.norm(p.w, dim=1)


def _cn(p, Keps, u_n):
    return cn_solve(p, *cn_operators(p, Keps), u_n)


def _step_gfem(p, u_n, u_old):
    return _cn(p, None, u_n)


def _step_rv_node(p, u_n, u_old):
    cfg = p.cfg
    Rh = residual_bdf1(p, u_n, u_old)
    if p.plan is not None:
        eps = blocked.rv_epsilon_linear(p.plan, cfg.Cvel, cfg.CRV, u_n, u_n,
                                        _wnorm(p), Rh, p.h_cg)
    else:
        eps = stab.rv_epsilon_linear(p.mesh, cfg.Cvel, cfg.CRV, u_n, u_n,
                                     p.w, Rh, p.h_cg)
    return _cn(p, _assemble_keps(p, eps), u_n)


def _step_rv_node_simple(p, u_n, u_old):
    cfg = p.cfg
    Rh = residual_bdf1_nobc(p, u_n, u_old)
    eps = stab.rv_epsilon_linear_simple(cfg.Cvel, cfg.CRV, p.w, Rh, u_n,
                                        p.h_cg)
    return _cn(p, _assemble_keps(p, eps), u_n)


def _step_rv_cell(p, u_n, u_old):
    cfg, m = p.cfg, p.mesh
    Rh = residual_bdf1(p, u_n, u_old)
    # the plain max of u_n - mean(u_n), not the inf-norm (reference)
    Rh = Rh / (u_n - u_n.mean()).max()
    beta_cell = _wnorm(p)[m.cells].amax(dim=1)
    if p.plan is not None:
        eps = blocked.rv_epsilon_cell_max(
            p.plan, cfg.Cvel, cfg.CRV, Rh, beta_cell,
            torch.ones_like(m.boundary_mask))
    else:
        eps = stab.rv_epsilon_cell(m, cfg.Cvel, cfg.CRV, Rh, beta_cell,
                                   m.h_cell, scatter=cfg.rv_cell_scatter)
    return _cn(p, _assemble_keps(p, eps), u_n)


def _step_si(p, u_n, u_old):
    cfg = p.cfg
    eps = stab.si_epsilon(p.mesh, cfg.Cm, p.K_bc, u_n, _wnorm(p), p.h_cg,
                          eps_floor=cfg.si_eps).epsilon
    return _cn(p, _assemble_keps(p, eps), u_n)


def _step_rk4(p, u_n, u_old):
    """Explicit RK4: each stage solves M k = -C u_stage with k|bc = 0."""
    bc = p.mesh.boundary_mask
    M_mv, M_diag = _linear_op(p, p.M)
    C_mv, _ = _linear_op(p, p.C)
    pre = jacobi_preconditioner(torch.where(bc, 1.0, M_diag))
    op = _constrained(bc, M_mv)

    def stage(u):
        return mass_solve(p.cfg, op, torch.where(bc, 0.0, -C_mv(u)), pre)

    dt = p.dt
    k1 = stage(u_n)
    k2 = stage(u_n + 0.5 * dt * k1)
    k3 = stage(u_n + 0.5 * dt * k2)
    k4 = stage(u_n + dt * k3)
    uh = u_n + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return torch.where(bc, 0.0, uh)


STEPS = {
    "gfem": _step_gfem,
    "rv_node": _step_rv_node,
    "rv_node_simple": _step_rv_node_simple,
    "rv_cell": _step_rv_cell,
    "si": _step_si,
    "rk4": _step_rk4,
}


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


class SolveResult(NamedTuple):
    u: torch.Tensor
    error_l2: torch.Tensor   # 0-dim: L2 error against the IC's interpolant
    dt: float
    num_steps: int


def l2_error_vs_ic(p, u):
    """sqrt(d^T M d), d = u - u0: the L2 error against the P1 interpolant
    of the IC (one full rotation returns the IC)."""
    d = u - p.u0
    return torch.sqrt(d @ ell_matvec(p.mesh, p.M, d))


def solve(p: AdvectionProblem) -> SolveResult:
    """Run the num_steps steps of the configured scheme from u0."""
    step = STEPS[p.cfg.stabilization]
    u_n, u_old, n = p.u0, p.u0, p.num_steps
    if p.cfg.stabilization in BOOTSTRAPPED:
        u_n, u_old, n = _step_gfem(p, p.u0, p.u0), p.u0, n - 1
    for _ in range(n):
        u_n, u_old = step(p, u_n, u_old), u_n
    return SolveResult(u_n, l2_error_vs_ic(p, u_n), p.dt, p.num_steps)


def run(cfg: AdvectionConfig | None = None, device=None,
        host_mesh: Mesh | None = None, **kw) -> SolveResult:
    """build + solve on ``device`` (None: the card)."""
    if cfg is None:
        cfg = AdvectionConfig(**kw)
    return solve(build(cfg, device=device, host_mesh=host_mesh))
