"""2D Burgers u_t + u (u_x + u_y) = 0 on the unit square, P1, ported from
conservation_fem_tpu/models/burgers.py.

Structured "/"-triangulation with N = mesh_size cells per side, flux
f(u) = (u^2/2, u^2/2), so f'(u) = (u, u), f''(u) = (1, 1) and |f'(u)| =
sqrt(2) |u|; quadrant Riemann IC with the closed-form 5-band solution as
oracle and as time-dependent Dirichlet data (or the bump IC with zero
data); dt = CFL min(h_CG), h_CG the projected nodal h (ops/helpers.py),
T = 0.5, Cvel 0.5, CRV 10; the SI variant Cm 0.5 with the l = 4
post-solve smoothing (``stabilization="si", smooth_l=4.0``). The stencil
backend runs on the structured mesh; backend="ell" (or a ``host_mesh``)
runs the generic ELL step, whose errors are taken on the ELL mass. The
step kernels compile this flux in (``FLUX.name``), so ``use_kernels`` on
the stencil backend runs the whole-step kernel that ``_fused_mode`` picks,
as for KPP; the Dirichlet data change every step, so a launch takes one
step.

degree 2 or 3 runs the Pk ELL step (models/pk_hyperbolic.py) on the
structured mesh's Pk space, with dt = CFL min(h_CG) / degree^2 (h_CG the
P1 projection of degree 1, ``time_step``: the JAX package's step counts
in f64 and f32) and the Chebyshev bounds of that degree.

``ell_matvec_backend="lattice"`` applies the ELL step's operators as
lattice-stencil planes (ops/lattice.py); "banded" applies them through
the ELL SpMV kernel, and "blocked" at degree 2 or 3 runs the blocked Pk
step (models/blocked_pk_hyperbolic.py) on the hand-written ELL kernels;
degree 1 with "blocked" is the gather step, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from conservation_fem_tpu_torch.models.advection_ho import (
    CN_BOUNDS as LIN_BOUNDS, MASS_BOUNDS)
from conservation_fem_tpu_torch.models.blocked_pk_hyperbolic import \
    BlockedPkHyperbolicProblem
from conservation_fem_tpu_torch.models.pk_hyperbolic import \
    PkHyperbolicProblem
from conservation_fem_tpu_torch.models.scalar_hyperbolic import (
    HyperbolicConfig, HyperbolicProblem)
from conservation_fem_tpu_torch.models.structured_hyperbolic import structure
from conservation_fem_tpu_torch.ops import structured as st
from conservation_fem_tpu_torch.ops.assembly import _DUN4_W, _quad_basis
from conservation_fem_tpu_torch.ops.helpers import (get_nodal_h,
                                                    get_nodal_h_ell)
from conservation_fem_tpu_torch.ops.mesh import (Mesh, rectangle_cell_sizes,
                                                 rectangle_mesh,
                                                 rectangle_mesh_lean)
from conservation_fem_tpu_torch.ops.spmv import ell_matvec


@dataclasses.dataclass(frozen=True)
class BurgersConfig:
    mesh_size: int = 200           # cells per side of the unit square
    stabilization: str = "rv"      # rv | si | gfem
    CFL: float = 0.5
    T: float = 0.5
    Cvel: float = 0.5
    CRV: float = 10.0
    Cm: float = 0.5                # SI only
    smooth_l: float = 0.0          # > 0: post-solve smoothing (SI: 4.0)
    newton_rtol: float = 1e-4
    krylov_rtol: float = 1e-12
    newton_linear_rtol: float | None = None
    modified_newton: bool = False
    dtype: str = "float64"
    record_metrics: bool = False
    backend: str = "auto"          # "auto" | "stencil" | "ell"
    ic: str = "riemann"            # riemann | bump
    residual_scheme: str = "bdf2"  # bdf2 | bdf1
    degree: int = 1                # 2, 3: the Pk ELL step
    # "gather" | "lattice" | "banded"; "blocked": at degree 2, 3 the
    # blocked Pk step (models/blocked_pk_hyperbolic.py, u in dof_perm
    # order), at degree 1 the gather step, as in the JAX package
    ell_matvec_backend: str = "gather"
    # fixed-iteration solvers (throughput paths; see KPPConfig)
    cg_iters: int | None = None
    newton_iters: int | None = None
    newton_linear_iters: int = 8
    inner_solver: str = "bicgstab"
    newton_final_residual: bool = True
    # None: the degree's Jacobi bounds (models/advection_ho.MASS_BOUNDS,
    # CN_BOUNDS; the CN Jacobian's as the CN advection operator's)
    cheby_mass_bounds: tuple | None = None
    cheby_lin_bounds: tuple | None = None
    use_kernels: bool = False      # see HyperbolicConfig (JAX: use_pallas)


def initial_condition(x, y):
    """Quadrant Riemann data."""
    u = torch.zeros_like(x)
    u = torch.where((x <= 0.5) & (y >= 0.5), -0.2, u)
    u = torch.where((x > 0.5) & (y >= 0.5), -1.0, u)
    u = torch.where((x <= 0.5) & (y < 0.5), 0.5, u)
    u = torch.where((x > 0.5) & (y < 0.5), 0.8, u)
    return u


def initial_condition_bump(x, y):
    """Smooth cosine bump of radius 0.2 centred at (0.3, 0.3)."""
    r2 = (x - 0.3) ** 2 + (y - 0.3) ** 2
    r0 = 0.2
    return torch.where(r2 <= r0**2,
                       0.5 * (1 + torch.cos(math.pi * torch.sqrt(r2) / r0)),
                       0.0)


def exact_solution(x, y, t):
    """Closed-form 5-band solution, the JAX package's bands in its order
    (later bands overwrite earlier ones, so band-edge ties resolve as
    there); at t = 0 the initial condition. t is cast to the field's dtype
    first, as the JAX function does: a number, or a column of S times > 0
    that gives (S, len(x)) in one call (the Dirichlet data of every step of
    a solve)."""
    t = torch.as_tensor(t, dtype=x.dtype)
    if t.ndim:
        if not bool((t > 0).all()):
            raise ValueError("exact_solution: a column of times must be > 0")
        t = t.to(x.device)
    elif not bool(t > 0):
        return initial_condition(x, y)
    u = torch.zeros_like(x)

    m1 = x <= 0.5 - 0.6 * t
    u = torch.where(m1 & (y > 0.5 + 0.15 * t), -0.2, u)
    u = torch.where(m1 & (y <= 0.5 + 0.15 * t), 0.5, u)

    m2 = (x >= 0.5 - 0.6 * t) & (x <= 0.5 - 0.25 * t)
    line2 = -8.0 * x / 7.0 + 15.0 / 14.0 - 15.0 * t / 28.0
    u = torch.where(m2 & (y > line2), -1.0, u)
    u = torch.where(m2 & (y <= line2), 0.5, u)

    m3 = (x >= 0.5 - 0.25 * t) & (x <= 0.5 + 0.5 * t)
    line3 = x / 6.0 + 5.0 / 12.0 - 5.0 * t / 24.0
    u = torch.where(m3 & (y > line3), -1.0, u)
    u = torch.where(m3 & (y <= line3), 0.5, u)

    m4 = (x >= 0.5 + 0.5 * t) & (x <= 0.5 + 0.8 * t)
    line4 = x - 5.0 / (18.0 * t) * (x + t - 0.5) ** 2
    fan = (2.0 * x - 1.0) / (2.0 * t)
    u = torch.where(m4 & (y > line4), -1.0, u)
    u = torch.where(m4 & (y <= line4), fan, u)

    m5 = x >= 0.5 + 0.8 * t
    u = torch.where(m5 & (y > 0.5 - 0.1 * t), -1.0, u)
    u = torch.where(m5 & (y <= 0.5 - 0.1 * t), 0.8, u)
    return u


def flux_prime_norm(u):
    """|f'(u)| = |(u, u)| = sqrt(2) |u|."""
    return math.sqrt(2.0) * u.abs()


flux_prime_xy = (lambda u: u, lambda u: u)
flux_prime2_xy = (torch.ones_like, torch.ones_like)
FLUX = st.Flux(name="burgers", fprime_xy=flux_prime_xy,
               fprime2_xy=flux_prime2_xy, fprime_norm=flux_prime_norm)


def _check_ported(cfg: BurgersConfig):
    """Raise for unknown options (the ELL matvec backends this port does
    not have yet raise in HyperbolicProblem, naming their ROADMAP
    items)."""
    if cfg.degree not in (1, 2, 3):
        raise ValueError("degree must be 1, 2 or 3")
    if cfg.degree > 1 and cfg.backend == "stencil":
        raise ValueError("the stencil backend is P1 only (degree 1)")
    if cfg.ic not in ("riemann", "bump"):
        raise ValueError(f"unknown ic {cfg.ic!r}")
    if cfg.backend not in ("auto", "stencil", "ell"):
        raise ValueError(f"unknown backend {cfg.backend!r}")


def stencil_min_h(host_mesh, N, cells=None):
    """dtype -> min h_CG, projected on the host on the structured mesh
    (ops/helpers.get_nodal_h). cells: (h_cell, area) of every cell; None:
    the host mesh's own (give them for rectangle_mesh_lean, whose
    identical cells would give 1/N exactly)."""
    h_cell, area = cells or (host_mesh.h_cell, host_mesh.area)

    def min_h(dtype):
        sd = st.build_structured(host_mesh, N, N, dtype, "cpu")
        return float(get_nodal_h(sd, h_cell, area).min())
    return min_h


def ell_min_h(host_mesh: Mesh):
    """dtype -> min h_CG, projected on the host on any mesh through its
    ELL mass (ops/helpers.get_nodal_h_ell, the JAX package's
    projection)."""
    def min_h(dtype):
        return float(get_nodal_h_ell(
            host_mesh.device_arrays(dtype, "cpu")).min())
    return min_h


def time_step(cfg: BurgersConfig, min_h):
    """(dt, num_steps): dt = CFL min(h_CG) and ceil(T / dt) steps, min_h
    the projection (stencil_min_h or ell_min_h). h_CG is projected on the
    host, so a run takes the same steps on the card as on the CPU, from
    the size of every cell as the JAX package's mesh has it: the linspace
    points make the sizes differ in their last bits, so the exact min h_CG
    lies a hair below 1/N, and the JAX package runs N + 1 steps unless N
    is a power of two (f64; in f32 always N + 1).

    The projection runs in the configuration's dtype. Below f64 it runs in
    f64 too, and the smaller of the two minima is taken: f32 rounding can
    land min h_CG on f32(1/N), above 1/N, where the JAX package's own f32
    projection (another summation order) lands below it (N = 20: f32 alone
    gives 20 steps, the JAX package 21). The f64 minimum lies below 1/N
    and the f32 one, wherever that is below 1/N, lies below the f64 one,
    so this changes dt only where f32 rounded up; it gives the JAX
    package's f32 step counts at N = 8, 12, 16, 20, 24, 50, 100, 200, 400,
    800 (scripts/burgers_time_steps.py --dtype float32).

    Degree k > 1 divides that dt by k^2, after the product, as the JAX
    package does."""
    h = min_h(getattr(torch, cfg.dtype))
    if cfg.dtype != "float64":
        h = min(h, min_h(torch.float64))
    dt = cfg.CFL * h
    if cfg.degree > 1:
        dt = dt / cfg.degree**2
    return dt, int(np.ceil(cfg.T / dt))


def build(cfg: BurgersConfig | None = None, device=None,
          host_mesh: Mesh | None = None, **kw):
    """The Burgers problem on ``device`` (None: the card; raises without
    one. device="cpu" for the CPU): the stencil backend on the structured
    mesh, or the ELL backend (backend="ell", or a host_mesh given); degree
    2 or 3: the Pk ELL step."""
    if cfg is None:
        cfg = BurgersConfig(**kw)
    _check_ported(cfg)
    N = cfg.mesh_size
    built_structured = host_mesh is None
    if cfg.backend == "stencil" and not built_structured:
        raise ValueError("the stencil backend runs on the structured mesh "
                         "only (no host_mesh)")
    use_stencil = (built_structured and cfg.backend != "ell"
                   and cfg.degree == 1)
    if not built_structured:
        min_h = ell_min_h(host_mesh)
    else:
        if use_stencil and N >= 512:
            host_mesh = rectangle_mesh_lean((0, 0), (1, 1), nx=N)
            cells = rectangle_cell_sizes((0, 0), (1, 1), nx=N)
        else:
            host_mesh, cells = rectangle_mesh((0, 0), (1, 1), nx=N), None
        min_h = stencil_min_h(host_mesh, N, cells)
    dt, num_steps = time_step(cfg, min_h)
    hcfg = HyperbolicConfig(
        stabilization=cfg.stabilization, residual_scheme=cfg.residual_scheme,
        Cvel=cfg.Cvel, CRV=cfg.CRV, Cm=cfg.Cm, newton_rtol=cfg.newton_rtol,
        krylov_rtol=cfg.krylov_rtol,
        newton_linear_rtol=cfg.newton_linear_rtol,
        modified_newton=cfg.modified_newton, smooth_l=cfg.smooth_l,
        cg_iters=cfg.cg_iters, newton_iters=cfg.newton_iters,
        newton_linear_iters=cfg.newton_linear_iters,
        inner_solver=cfg.inner_solver,
        newton_final_residual=cfg.newton_final_residual,
        cheby_mass_bounds=cfg.cheby_mass_bounds or MASS_BOUNDS[cfg.degree],
        cheby_lin_bounds=cfg.cheby_lin_bounds or LIN_BOUNDS[cfg.degree],
        ell_matvec_backend=cfg.ell_matvec_backend,
        use_kernels=cfg.use_kernels, dtype=cfg.dtype,
        record_metrics=cfg.record_metrics)
    if cfg.ic == "riemann":
        bc_fn = lambda pts, t: exact_solution(pts[:, 0], pts[:, 1], t)
        ic_fn = initial_condition
    else:
        bc_fn = lambda pts, t: torch.zeros(pts.shape[0], dtype=pts.dtype,
                                           device=pts.device)
        ic_fn = initial_condition_bump
    if cfg.degree > 1:
        # blocked: the RCM-permuted space (results in dof_perm order); P1
        # with blocked runs as gather, as in the JAX package
        cls = (BlockedPkHyperbolicProblem
               if cfg.ell_matvec_backend == "blocked" else PkHyperbolicProblem)
        prob = cls(hcfg, host_mesh, cfg.degree, flux=FLUX,
                                   bc_value=bc_fn, u0_fn=ic_fn, dt=dt,
                                   num_steps=num_steps, device=device)
    else:
        prob = HyperbolicProblem(hcfg, host_mesh, flux=FLUX, bc_value=bc_fn,
                                 u0_fn=ic_fn, dt=dt, num_steps=num_steps,
                                 device=device)
    prob.bc_static = False         # g = exact solution at each step's t
    if use_stencil:
        return structure(prob, N, N)
    return prob


def _exact_difference(problem, u, t):
    pts = problem.points
    return u - exact_solution(pts[:, 0], pts[:, 1], t)


def l2_error_vs_exact(problem, u, t):
    """sqrt(d^T M d), d = u - the exact solution's nodal interpolant, on
    the stencil or the ELL mass."""
    d = _exact_difference(problem, u, t)
    if hasattr(problem, "sd"):
        d = d.reshape(problem._shape2)
        return torch.sqrt(torch.sum(d * st.mass_matvec(problem.sd, d)))
    return torch.sqrt(d @ ell_matvec(problem.mesh, problem.M, d))


def l1_error_vs_exact(problem, u, t):
    """int |u - u_ex| dx, u_ex the nodal interpolant, by the degree-4
    quadrature on every cell (a Pk space: by its own rule)."""
    d = _exact_difference(problem, u, t)
    if hasattr(problem, "space"):
        sp = problem.mesh
        d_q = torch.einsum("qc,mc->mq", sp.phi, d[sp.cell_dofs])
        return ((d_q.abs() * sp.quad_w[None, :]).sum(dim=1)
                * 2.0 * sp.area).sum()
    phi = torch.as_tensor(_quad_basis(), dtype=u.dtype, device=u.device)
    w = torch.as_tensor(_DUN4_W * 0.5, dtype=u.dtype, device=u.device)
    if hasattr(problem, "sd"):
        sd = problem.sd
        d_q = torch.einsum("txya,qa->txyq",
                           st.cell_gather(sd, d.reshape(problem._shape2)),
                           phi)
        return ((d_q.abs() * w).sum(dim=-1) * 2.0 * sd.area).sum()
    m = problem.mesh
    d_q = torch.einsum("ma,qa->mq", d[m.cells], phi)
    return ((d_q.abs() * w).sum(dim=1) * 2.0 * m.area).sum()


def run(cfg: BurgersConfig | None = None, device=None,
        host_mesh: Mesh | None = None, **kw):
    """Solve (on host_mesh if given, as build) and compare with the exact
    solution: at t = 0.5 for the standard T = 0.5 (the loop overshoots it
    slightly, as the reference does), else at the end time. Returns
    (SolveResult, L2 error)."""
    if cfg is None:
        cfg = BurgersConfig(**kw)
    p = build(cfg, device=device, host_mesh=host_mesh)
    res = p.solve()
    t_cmp = 0.5 if cfg.T == 0.5 else res.num_steps * res.dt
    return res, float(l2_error_vs_exact(p, res.u, t_cmp))
