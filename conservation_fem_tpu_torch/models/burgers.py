"""2D Burgers u_t + u (u_x + u_y) = 0 on the unit square, P1 on the
structured stencil backend, ported from conservation_fem_tpu/models/
burgers.py.

Structured "/"-triangulation with N = mesh_size cells per side, flux
f(u) = (u^2/2, u^2/2), so f'(u) = (u, u), f''(u) = (1, 1) and |f'(u)| =
sqrt(2) |u|; quadrant Riemann IC with the closed-form 5-band solution as
oracle and as time-dependent Dirichlet data (or the bump IC with zero
data); dt = CFL min(h_CG), h_CG the projected nodal h (ops/helpers.py),
T = 0.5, Cvel 0.5, CRV 10. The step kernels compile this flux in
(``FLUX.name``), so ``use_kernels`` runs the whole-step kernel that
``_fused_mode`` picks, as for KPP; the Dirichlet data change every step,
so a launch takes one step.

Not ported yet, each raising NotImplementedError with its ROADMAP item:
SI and post-solve smoothing (queue 1 item 7), degree > 1 (item 10), the
ELL backend and its matvec backends (items 7 and 13).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from conservation_fem_tpu_torch.models.scalar_hyperbolic import (
    HyperbolicConfig, HyperbolicProblem)
from conservation_fem_tpu_torch.models.structured_hyperbolic import structure
from conservation_fem_tpu_torch.ops import structured as st
from conservation_fem_tpu_torch.ops.assembly import _DUN4_W, _quad_basis
from conservation_fem_tpu_torch.ops.helpers import get_nodal_h
from conservation_fem_tpu_torch.ops.mesh import (rectangle_cell_sizes,
                                                 rectangle_mesh,
                                                 rectangle_mesh_lean)


@dataclasses.dataclass(frozen=True)
class BurgersConfig:
    mesh_size: int = 200           # cells per side of the unit square
    stabilization: str = "rv"      # rv | gfem (si: not ported yet)
    CFL: float = 0.5
    T: float = 0.5
    Cvel: float = 0.5
    CRV: float = 10.0
    Cm: float = 0.5                # SI only
    smooth_l: float = 0.0          # post-solve smoothing: not ported yet
    newton_rtol: float = 1e-4
    krylov_rtol: float = 1e-12
    newton_linear_rtol: float | None = None
    modified_newton: bool = False
    dtype: str = "float64"
    record_metrics: bool = False
    backend: str = "auto"          # "auto" | "stencil" ("ell" not ported)
    ic: str = "riemann"            # riemann | bump
    residual_scheme: str = "bdf2"  # bdf2 | bdf1
    degree: int = 1                # > 1 not ported yet
    ell_matvec_backend: str = "gather"   # the ELL backend's; not ported
    # fixed-iteration solvers (throughput paths; see KPPConfig)
    cg_iters: int | None = None
    newton_iters: int | None = None
    newton_linear_iters: int = 8
    inner_solver: str = "bicgstab"
    newton_final_residual: bool = True
    cheby_mass_bounds: tuple | None = None   # None: (0.5, 2.0) for P1
    cheby_lin_bounds: tuple | None = None    # None: (0.4, 2.2) for P1
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
    """Raise for the options this port does not have yet, naming the
    ROADMAP item of each (SI and smoothing raise in HyperbolicProblem)."""
    todo = []
    if cfg.degree > 1:
        todo.append("degree > 1 (ROADMAP queue 1 item 10)")
    if cfg.backend not in ("auto", "stencil") \
            or cfg.ell_matvec_backend != "gather":
        todo.append("the ELL backend and its matvec backends (ROADMAP "
                    "queue 1 items 7 and 13)")
    if cfg.ic not in ("riemann", "bump"):
        raise ValueError(f"unknown ic {cfg.ic!r}")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def time_step(host_mesh, cfg: BurgersConfig, cells=None):
    """(dt, num_steps): dt = CFL min(h_CG) and ceil(T / dt) steps. h_CG is
    projected on the host in the configuration's dtype, so a run takes the
    same steps on the card as on the CPU, from the size of every cell as
    the JAX package's mesh has it: the linspace points make the sizes
    differ in their last bits. So h_CG comes out a few 1e-15 below 1/N
    (f64), and the run takes N + 1 steps unless N is a power of two, as in
    the JAX package. cells: (h_cell, area) of every cell; None: the host
    mesh's own (give them for rectangle_mesh_lean, whose identical cells
    would give 1/N exactly)."""
    h_cell, area = cells or (host_mesh.h_cell, host_mesh.area)
    N = cfg.mesh_size
    sd = st.build_structured(host_mesh, N, N, getattr(torch, cfg.dtype),
                             "cpu")
    h = get_nodal_h(sd, h_cell, area)
    dt = cfg.CFL * float(h.min())
    return dt, int(np.ceil(cfg.T / dt))


def build(cfg: BurgersConfig | None = None, device=None, **kw):
    """The Burgers problem on the structured stencil backend, on ``device``
    (None: the card; raises without one. device="cpu" for the CPU)."""
    if cfg is None:
        cfg = BurgersConfig(**kw)
    _check_ported(cfg)
    N = cfg.mesh_size
    if N >= 512:
        host_mesh = rectangle_mesh_lean((0, 0), (1, 1), nx=N)
        cells = rectangle_cell_sizes((0, 0), (1, 1), nx=N)
    else:
        host_mesh, cells = rectangle_mesh((0, 0), (1, 1), nx=N), None
    dt, num_steps = time_step(host_mesh, cfg, cells)
    hcfg = HyperbolicConfig(
        stabilization=cfg.stabilization, residual_scheme=cfg.residual_scheme,
        Cvel=cfg.Cvel, CRV=cfg.CRV, newton_rtol=cfg.newton_rtol,
        krylov_rtol=cfg.krylov_rtol,
        newton_linear_rtol=cfg.newton_linear_rtol,
        modified_newton=cfg.modified_newton, smooth_l=cfg.smooth_l,
        cg_iters=cfg.cg_iters, newton_iters=cfg.newton_iters,
        newton_linear_iters=cfg.newton_linear_iters,
        inner_solver=cfg.inner_solver,
        newton_final_residual=cfg.newton_final_residual,
        cheby_mass_bounds=cfg.cheby_mass_bounds or (0.5, 2.0),
        cheby_lin_bounds=cfg.cheby_lin_bounds or (0.4, 2.2),
        use_kernels=cfg.use_kernels, dtype=cfg.dtype,
        record_metrics=cfg.record_metrics)
    if cfg.ic == "riemann":
        bc_fn = lambda pts, t: exact_solution(pts[:, 0], pts[:, 1], t)
        ic_fn = initial_condition
    else:
        bc_fn = lambda pts, t: torch.zeros(pts.shape[0], dtype=pts.dtype,
                                           device=pts.device)
        ic_fn = initial_condition_bump
    prob = HyperbolicProblem(hcfg, host_mesh, flux=FLUX, bc_value=bc_fn,
                             u0_fn=ic_fn, dt=dt, num_steps=num_steps,
                             device=device)
    prob.bc_static = False         # g = exact solution at each step's t
    return structure(prob, N, N)


def l2_error_vs_exact(problem, u, t):
    """sqrt(d^T M d), d = u - the exact solution's nodal interpolant."""
    pts = problem.points
    d = (u - exact_solution(pts[:, 0], pts[:, 1], t)).reshape(
        problem._shape2)
    return torch.sqrt(torch.sum(d * st.mass_matvec(problem.sd, d)))


def l1_error_vs_exact(problem, u, t):
    """int |u - u_ex| dx, u_ex the nodal interpolant, by the degree-4
    quadrature on every cell."""
    pts, sd = problem.points, problem.sd
    d = (u - exact_solution(pts[:, 0], pts[:, 1], t)).reshape(
        problem._shape2)
    phi = torch.as_tensor(_quad_basis(), dtype=u.dtype, device=u.device)
    w = torch.as_tensor(_DUN4_W * 0.5, dtype=u.dtype, device=u.device)
    d_q = torch.einsum("txya,qa->txyq", st.cell_gather(sd, d), phi)
    return ((d_q.abs() * w).sum(dim=-1) * 2.0 * sd.area).sum()


def run(cfg: BurgersConfig | None = None, device=None, **kw):
    """Solve and compare with the exact solution: at t = 0.5 for the
    standard T = 0.5 (the loop overshoots it slightly, as the reference
    does), else at the end time. Returns (SolveResult, L2 error)."""
    if cfg is None:
        cfg = BurgersConfig(**kw)
    p = build(cfg, device=device)
    res = p.solve()
    t_cmp = 0.5 if cfg.T == 0.5 else res.num_steps * res.dt
    return res, float(l2_error_vs_exact(p, res.u, t_cmp))
