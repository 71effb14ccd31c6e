"""KPP rotating-wave benchmark: u_t + div(sin u, cos u) = 0, ported from
conservation_fem_tpu/models/kpp.py (structured mesh only).

Domain [-2,2]^2, IC = 14 pi/4 inside the unit circle else pi/4,
Dirichlet bc = pi/4, dt = 0.01, T = 1, Cvel = 0.5, CRV = 4.0; flux
derivative f'(u) = (cos u, -sin u), so |f'(u)| = 1 identically, and
f''(u) = (-sin u, -cos u).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from conservation_fem_tpu_torch.models.scalar_hyperbolic import (
    HyperbolicConfig, HyperbolicProblem)
from conservation_fem_tpu_torch.models.structured_hyperbolic import structure
from conservation_fem_tpu_torch.ops.mesh import (rectangle_mesh,
                                                 rectangle_mesh_lean)
from conservation_fem_tpu_torch.ops.structured import Flux


@dataclasses.dataclass(frozen=True)
class KPPConfig:
    mesh_size: int = 32            # cells per unit length: hmax = 1/mesh_size
    mesh_source: str = "structured"  # only "structured" is ported
    stabilization: str = "rv"      # rv | gfem
    dt: float = 0.01
    T: float = 1.0
    Cvel: float = 0.5
    CRV: float = 4.0
    smooth_l: float = 0.0
    newton_rtol: float = 1e-4
    newton_atol: float = 1e-10
    krylov_rtol: float = 1e-12
    newton_linear_rtol: float | None = None
    modified_newton: bool = False
    cg_iters: int | None = None
    newton_iters: int | None = None
    newton_linear_iters: int = 8
    inner_solver: str = "bicgstab"
    newton_final_residual: bool = True
    precise_reductions: bool = False
    # O(N) host mesh (identical geometry); None = auto at mesh_size >= 512
    lean_mesh: bool | None = None
    tiled_bf16_planes: bool = False
    xla_bf16_planes: bool = False
    use_kernels: bool = False      # see HyperbolicConfig
    dtype: str = "float64"
    record_metrics: bool = False
    backend: str = "auto"          # "auto" | "stencil" ("ell" not ported)


def initial_condition(x, y):
    """14*pi/4 inside the unit circle, pi/4 outside."""
    inside = (x**2 + y**2) <= 1.0
    return torch.where(inside, torch.full_like(x, 14.0 * math.pi / 4.0),
                       torch.full_like(x, math.pi / 4.0))


def flux_prime(u):
    """f(u) = (sin u, cos u) => f'(u) = (cos u, -sin u)."""
    return torch.stack([torch.cos(u), -torch.sin(u)], dim=-1)


def flux_prime_norm(u):
    return torch.ones_like(u)


flux_prime_xy = (torch.cos, lambda u: -torch.sin(u))
flux_prime2_xy = (lambda u: -torch.sin(u), lambda u: -torch.cos(u))
FLUX = Flux(name="kpp", fprime_xy=flux_prime_xy, fprime2_xy=flux_prime2_xy,
            fprime_norm=flux_prime_norm)


def build(cfg: KPPConfig | None = None, device=None, **kw):
    """The KPP problem on the structured stencil backend, on ``device``."""
    if cfg is None:
        cfg = KPPConfig(**kw)
    if cfg.mesh_source != "structured" or cfg.backend not in ("auto",
                                                              "stencil"):
        raise NotImplementedError(
            "only the structured stencil backend is ported (unstructured "
            "meshes and the ELL backend: ROADMAP queue 1 item 7)")
    n = 4 * cfg.mesh_size   # [-2,2] spans 4 units
    lean = cfg.lean_mesh if cfg.lean_mesh is not None else cfg.mesh_size >= 512
    mesh_fn = rectangle_mesh_lean if lean else rectangle_mesh
    host_mesh = mesh_fn((-2, -2), (2, 2), nx=n, ny=n)
    hcfg = HyperbolicConfig(
        stabilization=cfg.stabilization, Cvel=cfg.Cvel, CRV=cfg.CRV,
        newton_rtol=cfg.newton_rtol, newton_atol=cfg.newton_atol,
        krylov_rtol=cfg.krylov_rtol,
        newton_linear_rtol=cfg.newton_linear_rtol,
        modified_newton=cfg.modified_newton, smooth_l=cfg.smooth_l,
        cg_iters=cfg.cg_iters, newton_iters=cfg.newton_iters,
        newton_linear_iters=cfg.newton_linear_iters,
        inner_solver=cfg.inner_solver,
        newton_final_residual=cfg.newton_final_residual,
        precise_reductions=cfg.precise_reductions,
        tiled_bf16_planes=cfg.tiled_bf16_planes,
        xla_bf16_planes=cfg.xla_bf16_planes, use_kernels=cfg.use_kernels,
        dtype=cfg.dtype, record_metrics=cfg.record_metrics)
    bc_val = float(np.pi / 4.0)
    prob = HyperbolicProblem(
        hcfg, host_mesh, flux=FLUX,
        bc_value=lambda pts, t: torch.full((pts.shape[0],), bc_val,
                                           dtype=pts.dtype,
                                           device=pts.device),
        u0_fn=initial_condition, dt=cfg.dt,
        num_steps=int(np.ceil(cfg.T / cfg.dt)), device=device)
    prob.bc_static = True          # g = pi/4 for all t
    return structure(prob, n, n)


def run(cfg: KPPConfig | None = None, device=None, **kw):
    return build(cfg, device=device, **kw).solve()
