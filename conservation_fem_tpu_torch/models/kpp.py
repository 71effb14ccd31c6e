"""KPP rotating-wave benchmark: u_t + div(sin u, cos u) = 0, ported from
conservation_fem_tpu/models/kpp.py.

Domain [-2,2]^2, IC = 14 pi/4 inside the unit circle else pi/4,
Dirichlet bc = pi/4, dt = 0.01, T = 1, Cvel = 0.5, CRV = 4.0 (SI: Cm =
0.5); flux derivative f'(u) = (cos u, -sin u), so |f'(u)| = 1
identically, and f''(u) = (-sin u, -cos u).

The mesh is the structured triangulation of [-2,2]^2 (default), a stored
DOLFINx mesh (``mesh_source``: a path to an .h5 file), or one the caller
gives (``host_mesh``, e.g. ops/mesh.irregular_mesh). backend="auto" runs
the stencil backend on the structured mesh and the ELL backend on any
other; "ell" forces the ELL backend.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from conservation_fem_tpu_torch.models.blocked_hyperbolic import \
    BlockedHyperbolicProblem
from conservation_fem_tpu_torch.models.scalar_hyperbolic import (
    HyperbolicConfig, HyperbolicProblem)
from conservation_fem_tpu_torch.models.structured_hyperbolic import structure
from conservation_fem_tpu_torch.ops.mesh import (Mesh, load_h5_mesh,
                                                 rcm_permutation,
                                                 rectangle_mesh,
                                                 rectangle_mesh_lean,
                                                 reorder_mesh)
from conservation_fem_tpu_torch.ops.structured import Flux
from conservation_fem_tpu_torch.ops.tiling import tile_mesh


@dataclasses.dataclass(frozen=True)
class KPPConfig:
    mesh_size: int = 32            # cells per unit length: hmax = 1/mesh_size
    mesh_source: str = "structured"  # "structured" | path to an .h5 mesh
    stabilization: str = "rv"      # rv | si | gfem
    dt: float = 0.01
    T: float = 1.0
    Cvel: float = 0.5
    CRV: float = 4.0
    Cm: float = 0.5                # SI
    smooth_l: float = 0.0          # > 0: post-solve patch smoothing
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
    # on the stencil backend
    lean_mesh: bool | None = None
    tiled_bf16_planes: bool = False
    xla_bf16_planes: bool = False
    # ELL operator application: "gather", "banded" (the ELL SpMV kernel),
    # "blocked" or "blocked2d" (the hand-written ELL kernels, models/
    # blocked_hyperbolic.py). A mesh built here is RCM-ordered for banded
    # and blocked and laid out in tile slots for blocked2d (the solution
    # then in slot order: u_native = u[prob.slot_of_node]); a caller's
    # host_mesh keeps its order (give an RCM-ordered or tile_mesh one)
    ell_matvec_backend: str = "gather"
    # blocked backends: the per-step operators matrix-free from the cell
    # locals (see HyperbolicConfig)
    blocked_matrix_free: bool = False
    use_kernels: bool = False      # see HyperbolicConfig
    dtype: str = "float64"
    record_metrics: bool = False
    backend: str = "auto"          # "auto" | "stencil" | "ell"


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


def build(cfg: KPPConfig | None = None, device=None,
          host_mesh: Mesh | None = None, **kw):
    """The KPP problem on ``device`` (None: the card; raises without one.
    device="cpu" for the CPU). host_mesh: a mesh to run on (the ELL
    backend; its node order is kept, so give an RCM-ordered one for banded
    and blocked, a tiling.tile_mesh one for blocked2d). A mesh built here
    on the ELL backend is RCM-ordered (banded, blocked) or tiled
    (blocked2d, slot map in ``prob.slot_of_node``), as in the JAX
    package; on the stencil backend (a structured mesh, backend "auto")
    the ELL backends are not read."""
    if cfg is None:
        cfg = KPPConfig(**kw)
    if cfg.backend not in ("auto", "stencil", "ell"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    built_structured = host_mesh is None and cfg.mesh_source == "structured"
    if cfg.backend == "stencil" and not built_structured:
        raise ValueError("the stencil backend runs on the structured mesh "
                         "only (mesh_source='structured', no host_mesh)")
    use_stencil = built_structured and cfg.backend != "ell"
    n = 4 * cfg.mesh_size   # [-2,2] spans 4 units
    mv = cfg.ell_matvec_backend
    slot_of_node = None
    if host_mesh is None:
        if built_structured:
            lean = (cfg.lean_mesh if cfg.lean_mesh is not None
                    else use_stencil and cfg.mesh_size >= 512)
            mesh_fn = rectangle_mesh_lean if lean else rectangle_mesh
            host_mesh = mesh_fn((-2, -2), (2, 2), nx=n, ny=n)
        else:
            host_mesh = load_h5_mesh(cfg.mesh_source)
        if not use_stencil and mv in ("banded", "blocked"):
            host_mesh = reorder_mesh(host_mesh, rcm_permutation(host_mesh))
        elif not use_stencil and mv == "blocked2d":
            host_mesh, slot_of_node = tile_mesh(host_mesh)
    hcfg = HyperbolicConfig(
        stabilization=cfg.stabilization, Cvel=cfg.Cvel, CRV=cfg.CRV,
        Cm=cfg.Cm, newton_rtol=cfg.newton_rtol, newton_atol=cfg.newton_atol,
        krylov_rtol=cfg.krylov_rtol,
        newton_linear_rtol=cfg.newton_linear_rtol,
        modified_newton=cfg.modified_newton, smooth_l=cfg.smooth_l,
        cg_iters=cfg.cg_iters, newton_iters=cfg.newton_iters,
        newton_linear_iters=cfg.newton_linear_iters,
        inner_solver=cfg.inner_solver,
        newton_final_residual=cfg.newton_final_residual,
        precise_reductions=cfg.precise_reductions,
        tiled_bf16_planes=cfg.tiled_bf16_planes,
        xla_bf16_planes=cfg.xla_bf16_planes,
        ell_matvec_backend=cfg.ell_matvec_backend,
        blocked_matrix_free=cfg.blocked_matrix_free,
        use_kernels=cfg.use_kernels, dtype=cfg.dtype,
        record_metrics=cfg.record_metrics)
    bc_val = float(np.pi / 4.0)
    cls = (BlockedHyperbolicProblem
           if mv in ("blocked", "blocked2d") and not use_stencil
           else HyperbolicProblem)
    prob = cls(
        hcfg, host_mesh, flux=FLUX,
        bc_value=lambda pts, t: torch.full((pts.shape[0],), bc_val,
                                           dtype=pts.dtype,
                                           device=pts.device),
        u0_fn=initial_condition, dt=cfg.dt,
        num_steps=int(np.ceil(cfg.T / cfg.dt)), device=device)
    prob.bc_static = True          # g = pi/4 for all t
    if slot_of_node is not None:
        prob.slot_of_node = slot_of_node
    if use_stencil:
        return structure(prob, n, n)
    return prob


def run(cfg: KPPConfig | None = None, device=None, **kw):
    return build(cfg, device=device, **kw).solve()


def generate_reference(path: str, mesh_size: int = 64, device=None, **kw):
    """Generate a fine-mesh reference field, parity with
    Code/KPP/KPP_exact.py (hmax=1/64, dt=0.01, T=1, :38,75-78): runs the
    node-RV solver on ``device`` (None: the card) and writes the mesh and
    the final field as XDMF/HDF5 (needs h5py)."""
    from conservation_fem_tpu_torch.utils.io import XDMFWriter

    p = build(KPPConfig(mesh_size=mesh_size, **kw), device=device)
    res = p.solve()
    with XDMFWriter(path, p.host_mesh) as w:
        w.write_function(res.u, p.num_steps * p.dt, name="uh")
    return res


def compare_to_reference(path: str, u, host_mesh: Mesh, name="uh"):
    """L2 distance to a stored reference field on the same mesh — the
    comparison KPP_conv.py:30-33 stubs out — on the mass of host_mesh in
    u's dtype, on u's device."""
    from conservation_fem_tpu_torch.ops import assembly
    from conservation_fem_tpu_torch.ops.spmv import ell_matvec
    from conservation_fem_tpu_torch.utils.io import read_h5_series

    _, vals = read_h5_series(path.replace(".xdmf", ".h5"), name)
    u = torch.as_tensor(u)
    m = host_mesh.device_arrays(u.dtype, u.device)
    M = assembly.assemble_mass(m)
    d = u - torch.as_tensor(vals[-1], dtype=u.dtype, device=u.device)
    return float(torch.sqrt(d @ ell_matvec(m, M, d)))
