"""Compressible Euler equations U_t + div F(U) = 0, U = (rho, m1, m2, E),
ported from conservation_fem_tpu/models/euler.py: P1 group FEM with
residual-viscosity shock capturing and SSP-RK2 (or RK3) in time.

  * pressure p = (gamma - 1)(E - |m|^2 / (2 rho)), density and pressure
    floored at ``rho_floor`` (``primitives``);
  * group FEM: F_h = sum_j F(U_j) phi_j, so the divergence of the flux is
    two products per component with the precomputed Cx, Cy;
  * RV from the density residual with beta = |u| + c (``wavespeed``);
  * lumped mass; the far-field rows frozen at their initial values (the
    Sod tube: its x-ends only, with slip walls, m_y = 0, on its y-walls);
  * problems: "sod" (the exact Riemann solution of utils/riemann_exact.py
    is its oracle), "riemann2d" (configuration 3, four shocks) and
    "uniform" (a constant state, kept exactly).

Two backends, as in the JAX package: ``backend="auto"`` runs the stencil
step on the structured rectangle (every operator 7 planes over
(4, nx+1, ny+1) grids; the four components share each product), and
``backend="ell"`` (or a ``host_mesh`` that is not the rectangle, passed
with backend="ell") the gather step on the ELL operators. dt and the step
count come from a host numpy f64 wavespeed on the f64 mesh points, so an
f32 run and its f64 anchor take the same steps. No hand-written kernel
lies on this path: the JAX package runs it as XLA, and here it is plain
PyTorch. The JAX ``lax.scan`` is a Python loop that reads nothing on the
host. The sharded twin is parallel/euler_sharded.py (row blocks over
parallel/comm.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.ops import stabilization as stab
from conservation_fem_tpu_torch.ops import structured as st
from conservation_fem_tpu_torch.ops.helpers import get_nodal_h_ell
from conservation_fem_tpu_torch.ops.mesh import Mesh, rectangle_mesh
from conservation_fem_tpu_torch.ops.spmv import ell_matvec
from conservation_fem_tpu_torch.utils.riemann_exact import sod_exact


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    problem: str = "sod"          # sod | riemann2d | uniform
    nx: int = 100
    ny: int | None = None         # None: the problem's aspect ratio
    CFL: float = 0.25
    T: float | None = None        # None: the problem's (sod 0.2, 2D 0.3)
    Cvel: float = 0.5
    # None: 1.0 for sod and uniform, 4.0 for riemann2d (the four-shock
    # interaction needs it from nx 128; EulerConfig.CRV in the JAX package)
    CRV: float | None = None
    gamma: float = 1.4
    rho_floor: float = 1e-10
    rk_order: int = 2             # SSP-RK2 or SSP-RK3
    dtype: str = "float64"
    record_metrics: bool = False
    backend: str = "auto"         # auto (stencil on the rectangle) | ell


_PROBLEMS = {
    # problem: (p0, p1, T_default, aspect ny/nx)
    "sod": ((0.0, 0.0), (1.0, 0.25), 0.2, 0.25),
    "riemann2d": ((0.0, 0.0), (1.0, 1.0), 0.3, 1.0),
    "uniform": ((0.0, 0.0), (1.0, 1.0), 0.5, 1.0),
}


def primitive_to_conservative(rho, u1, u2, p, gamma, xp=torch):
    """(rho, m1, m2, E) stacked on the last axis; xp: torch or numpy."""
    E = p / (gamma - 1.0) + 0.5 * rho * (u1**2 + u2**2)
    return xp.stack([rho, rho * u1, rho * u2, E], axis=-1)


def _select(xp, conds, vals, default, like):
    """numpy.select for numpy or torch (the first true condition wins)."""
    if xp is np:
        return np.select(conds, vals, default)
    out = torch.full_like(like, default)
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def initial_state(problem, x, y, gamma, xp=torch):
    """(N,4) initial state at the points; xp=np evaluates on the host at
    the input's dtype (``build`` does so on the f64 points for dt)."""
    if problem == "sod":
        left = [x <= 0.5]
        rho = _select(xp, left, [1.0], 0.125, x)
        p = _select(xp, left, [1.0], 0.1, x)
        return primitive_to_conservative(rho, 0.0 * x, 0.0 * x, p, gamma, xp)
    if problem == "riemann2d":
        # 2D Riemann configuration 3 (four shocks)
        q1 = (x > 0.5) & (y > 0.5)
        q2 = (x <= 0.5) & (y > 0.5)
        q3 = (x <= 0.5) & (y <= 0.5)
        qs = [q1, q2, q3]
        rho = _select(xp, qs, [1.5, 0.5323, 0.138], 0.5323, x)
        u1 = _select(xp, qs, [0.0, 1.206, 1.206], 0.0, x)
        u2 = _select(xp, qs, [0.0, 0.0, 1.206], 1.206, x)
        p = _select(xp, qs, [1.5, 0.3, 0.029], 0.3, x)
        return primitive_to_conservative(rho, u1, u2, p, gamma, xp)
    if problem == "uniform":
        one = xp.ones_like(x)
        return xp.stack([one, 0.1 * one, 0.0 * one, 2.5 * one], axis=-1)
    raise ValueError(f"unknown problem {problem!r}")


class EulerProblem(NamedTuple):
    cfg: object
    host_mesh: object
    mesh: object          # MeshArrays on the device
    Cx: object            # (N,K) ELL
    Cy: object
    ml: object            # (N,) lumped mass
    h_cg: object          # (N,) nodal h (the ELL step's)
    dt: float
    num_steps: int
    U0: object            # (N,4)
    bc_mask: object = None      # far-field nodes, frozen
    sd: object = None           # StructuredData (stencil backend) or None
    Cx_c: object = None         # (7, nx+1, ny+1) stencil Cx
    Cy_c: object = None
    ml2: object = None          # lumped mass on the grid
    bc2: object = None          # grid form of bc_mask
    slip_mask: object = None    # y-wall nodes where m_y is zeroed
    slip2: object = None


def _primitives(rho, m1, m2, E, gamma, rho_floor):
    rho = torch.clamp_min(rho, rho_floor)
    u1 = m1 / rho
    u2 = m2 / rho
    p = (gamma - 1.0) * (E - 0.5 * rho * (u1**2 + u2**2))
    return rho, u1, u2, torch.clamp_min(p, rho_floor)


def primitives(U, gamma, rho_floor, axis=1):
    """Floored primitives (rho, u1, u2, p) of U, its components on
    ``axis`` (1: (N,4); 0: the stencil step's (4, nx+1, ny+1))."""
    return _primitives(*U.unbind(axis), gamma, rho_floor)


def flux(U, gamma, rho_floor, axis=1):
    """(Fx, Fy), each shaped as U (components on ``axis``)."""
    rho, u1, u2, p = primitives(U, gamma, rho_floor, axis)
    E = U.select(axis, 3)
    Fx = torch.stack([rho * u1, rho * u1**2 + p, rho * u1 * u2,
                      (E + p) * u1], dim=axis)
    Fy = torch.stack([rho * u2, rho * u1 * u2, rho * u2**2 + p,
                      (E + p) * u2], dim=axis)
    return Fx, Fy


def wavespeed(U, gamma, rho_floor, axis=1):
    """beta = |u| + c at every node."""
    rho, u1, u2, p = primitives(U, gamma, rho_floor, axis)
    c = torch.sqrt(gamma * torch.clamp_min(p, 0.0) / rho)
    return torch.sqrt(u1**2 + u2**2) + c


def _time_step(cfg, host_mesh, T):
    """(dt, num_steps) from the host f64 wavespeed of the initial state on
    the f64 mesh points: the same in every dtype."""
    pts = np.asarray(host_mesh.points, np.float64)
    U0h = initial_state(cfg.problem, pts[:, 0], pts[:, 1], cfg.gamma, xp=np)
    rho0 = np.maximum(U0h[:, 0], cfg.rho_floor)
    u10, u20 = U0h[:, 1] / rho0, U0h[:, 2] / rho0
    p_0 = np.maximum((cfg.gamma - 1.0) * (
        U0h[:, 3] - 0.5 * rho0 * (u10**2 + u20**2)), cfg.rho_floor)
    beta0 = np.sqrt(u10**2 + u20**2) + np.sqrt(cfg.gamma * p_0 / rho0)
    dt = cfg.CFL * float(host_mesh.hmin) / float(beta0.max())
    return dt, int(np.ceil(T / dt))


def build(cfg: EulerConfig | None = None, host_mesh: Mesh | None = None,
          device=None, **kw) -> EulerProblem:
    """The Euler problem on ``device`` (None: the card; raises without
    one. device="cpu" for the CPU)."""
    if cfg is None:
        cfg = EulerConfig(**kw)
    if cfg.backend not in ("auto", "ell"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.rk_order not in (2, 3):
        raise ValueError("rk_order must be 2 or 3")
    if cfg.CRV is None:
        crv = 4.0 if cfg.problem == "riemann2d" else 1.0
        cfg = dataclasses.replace(cfg, CRV=crv)
    device = get_device(device)
    p0, p1, T_def, aspect = _PROBLEMS[cfg.problem]
    T = cfg.T if cfg.T is not None else T_def
    ny = cfg.ny if cfg.ny is not None else max(2, int(round(cfg.nx * aspect)))
    if host_mesh is None:
        host_mesh = rectangle_mesh(p0, p1, nx=cfg.nx, ny=ny)
    dtype = getattr(torch, cfg.dtype)
    m = host_mesh.device_arrays(dtype, device)
    Cx, Cy = assembly.assemble_directional_convection(m)
    ml = assembly.lumped_mass(m)
    h_cg = get_nodal_h_ell(m)
    U0 = initial_state(cfg.problem, m.points[:, 0], m.points[:, 1],
                       cfg.gamma).to(dtype)
    dt, num_steps = _time_step(cfg, host_mesh, T)
    # far field: the Sod tube freezes its x-ends only, with slip walls on
    # its y-walls; the 2D problems freeze the whole boundary
    slip_np = np.zeros(host_mesh.n_nodes, dtype=bool)
    if cfg.problem == "sod":
        x = np.asarray(host_mesh.points[:, 0])
        bc_np = host_mesh.boundary_mask & (
            np.isclose(x, p0[0]) | np.isclose(x, p1[0]))
        slip_np = host_mesh.boundary_mask & ~bc_np
    else:
        bc_np = host_mesh.boundary_mask
    mask = lambda a: torch.as_tensor(a, device=device)
    sd = Cx_c = Cy_c = ml2 = bc2 = slip2 = None
    if cfg.backend == "auto":
        sd = st.build_structured(host_mesh, cfg.nx, ny, dtype, device)
        Cx_c, Cy_c = st.directional_convection_coefs(sd)
        ml2 = st.lumped_mass_grid(sd)
        bc2 = mask(bc_np.reshape(cfg.nx + 1, ny + 1))
        slip2 = mask(slip_np.reshape(cfg.nx + 1, ny + 1))
    return EulerProblem(cfg, host_mesh, m, Cx, Cy, ml, h_cg, dt, num_steps,
                        U0, mask(bc_np), sd, Cx_c, Cy_c, ml2, bc2,
                        mask(slip_np), slip2)


def _ssp_rk(cfg, dt, U, rhs, slip):
    """One SSP-RK2 (or RK3) step of U' = rhs(U), the slip projection after
    each stage."""
    U1 = slip(U + dt * rhs(U))
    if cfg.rk_order == 3:
        U2 = slip(0.75 * U + 0.25 * (U1 + dt * rhs(U1)))
        return slip(U / 3.0 + 2.0 / 3.0 * (U2 + dt * rhs(U2)))
    return slip(0.5 * U + 0.5 * (U1 + dt * rhs(U1)))


def _zero_component(U, k, mask, axis):
    """U with component k set to 0 where mask holds (a new tensor: the
    caller's state is not written)."""
    comps = list(U.unbind(axis))
    comps[k] = torch.where(mask, 0.0, comps[k])
    return torch.stack(comps, dim=axis)


# ---------------------------------------------------------------------------
# ELL (gather) step
# ---------------------------------------------------------------------------


def _div_flux(p: EulerProblem, U):
    """(Cx Fx + Cy Fy) per component: (N,4)."""
    Fx, Fy = flux(U, p.cfg.gamma, p.cfg.rho_floor)
    return torch.stack([
        ell_matvec(p.mesh, p.Cx, Fx[:, k]) + ell_matvec(p.mesh, p.Cy, Fy[:, k])
        for k in range(4)], dim=1)


def _rhs(p: EulerProblem, U, Keps):
    """L(U) = -ML^-1 [div-flux + Keps U], the far-field rows frozen."""
    visc = torch.stack([ell_matvec(p.mesh, Keps, U[:, k]) for k in range(4)],
                       dim=1)
    dU = -(_div_flux(p, U) + visc) / p.ml[:, None]
    return torch.where(p.bc_mask[:, None], 0.0, dU)


def step(p: EulerProblem, carry):
    """One ELL step: (U, U_old) -> (U_new, U)."""
    U, U_old = carry
    cfg = p.cfg
    rho_dot = (U[:, 0] - U_old[:, 0]) / p.dt
    div_m = (ell_matvec(p.mesh, p.Cx, U[:, 1])
             + ell_matvec(p.mesh, p.Cy, U[:, 2])) / p.ml
    R = rho_dot + div_m
    beta = wavespeed(U, cfg.gamma, cfg.rho_floor)
    eps = stab.rv_epsilon_system(p.mesh, cfg.Cvel, cfg.CRV, U[:, 0], beta, R,
                                 p.h_cg)
    Keps = assembly.assemble_eps_stiffness(p.mesh, eps)
    Un = _ssp_rk(cfg, p.dt, U, lambda V: _rhs(p, V, Keps),
                 lambda V: _zero_component(V, 2, p.slip_mask, 1))
    return Un, U


# ---------------------------------------------------------------------------
# stencil step: the same arithmetic on (4, nx+1, ny+1) grids
# ---------------------------------------------------------------------------


def _step_structured(p: EulerProblem, carry):
    """One stencil step on (4, nx+1, ny+1) grids."""
    cfg, sd = p.cfg, p.sd
    U, U_old = carry

    def rhs(Ug, Kc):
        Fx, Fy = flux(Ug, cfg.gamma, cfg.rho_floor, axis=0)
        div = st.matvec(sd, p.Cx_c, Fx) + st.matvec(sd, p.Cy_c, Fy)
        dU = -(div + st.matvec(sd, Kc, Ug)) / p.ml2[None]
        return torch.where(p.bc2[None], 0.0, dU)

    rho_dot = (U[0] - U_old[0]) / p.dt
    div_m = (st.matvec(sd, p.Cx_c, U[1])
             + st.matvec(sd, p.Cy_c, U[2])) / p.ml2
    R = rho_dot + div_m
    beta2 = wavespeed(U, cfg.gamma, cfg.rho_floor, axis=0)
    eps = st.rv_epsilon_system_grid(sd, cfg.Cvel, cfg.CRV, U[0], R, beta2)
    Kc = st.keps_coef(sd, eps)
    Un = _ssp_rk(cfg, p.dt, U, lambda V: rhs(V, Kc),
                 lambda V: _zero_component(V, 2, p.slip2, 0))
    return Un, U


def to_grid(p: EulerProblem, U):
    """(N,4) -> (4, nx+1, ny+1) (node id = i (ny+1) + j)."""
    sd = p.sd
    return U.reshape(sd.nx + 1, sd.ny + 1, 4).permute(2, 0, 1).contiguous()


def from_grid(U2):
    """(4, nx+1, ny+1) -> (N,4)."""
    return U2.permute(1, 2, 0).reshape(-1, 4)


class EulerResult(NamedTuple):
    U: object
    dt: float
    num_steps: int


def solve(p: EulerProblem, num_steps: int | None = None) -> EulerResult:
    """March ``num_steps`` steps (None: the problem's) from U0."""
    n = p.num_steps if num_steps is None else int(num_steps)
    if p.sd is not None:
        carry = (to_grid(p, p.U0),) * 2
        for _ in range(n):
            carry = _step_structured(p, carry)
        return EulerResult(from_grid(carry[0]), p.dt, p.num_steps)
    carry = (p.U0, p.U0)
    for _ in range(n):
        carry = step(p, carry)
    return EulerResult(carry[0], p.dt, p.num_steps)


def run(cfg: EulerConfig | None = None, device=None, **kw) -> EulerResult:
    return solve(build(cfg, device=device, **kw))


def sod_density_error(p: EulerProblem, U, t):
    """L1 nodal error of rho against the exact Riemann solution at time t,
    weighted by the lumped mass (host numpy)."""
    x = p.mesh.points[:, 0].double().cpu().numpy()
    rho_ex, _, _ = sod_exact(x, t)
    rho = U[:, 0].double().cpu().numpy()
    w = p.ml.double().cpu().numpy()
    return float(np.sum(np.abs(rho - rho_ex) * w) / np.sum(w) * 1.0)
