"""Higher-order (P1-P3) linear advection, ported from
conservation_fem_tpu/models/advection_ho.py: the solid-body rotation of
models/linear_advection.py in a Pk Lagrange space, with GFEM, RV, RV with
global normalisation or SI.

  * the same CN forms as the P1 path, assembled in the Pk space
    (ops/assembly_pk.py), with A = M + dt/2 (C + Keps);
  * "rv": the patch epsilon with the BDF1 residual solved with the bc;
    "rv_simple": the globally normalised epsilon (the P3 runs); both
    start with one plain GFEM step;
  * "si": the stiffness assembled once with the bc;
  * dt = CFL hmax / ||w||_inf from the dofs' velocities (the same row-sum
    quirk), ceil(T / dt) steps, no clamp of the last step;
  * the error: L2 against the Pk interpolant of the IC, through M;
  * ``curved_boundary``: the disk's boundary dofs projected onto the unit
    circle, isoparametric boundary cells.

The Chebyshev bounds of the fixed-iteration solvers default per degree
(the Jacobi-preconditioned spectra widen with it). ``ell_matvec_backend=
"blocked"`` permutes the dofs by RCM (ops/spaces.rcm_dof_permutation; the
solution then in the permuted numbering, ``u[problem.space_perm]`` the
native one, as in the JAX package) and runs the products and assemblies on
the hand-written ELL kernels (ops/blocked.py, ops/blocked_pk.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.models import linear_advection as la
from conservation_fem_tpu_torch.ops import assembly_pk as apk
from conservation_fem_tpu_torch.ops import blocked
from conservation_fem_tpu_torch.ops import blocked_pk as bpk
from conservation_fem_tpu_torch.ops import stabilization as stab
from conservation_fem_tpu_torch.ops.bc import ell_with_bc
from conservation_fem_tpu_torch.ops.krylov import cg, jacobi_preconditioner
from conservation_fem_tpu_torch.ops.mesh import Mesh, disk_mesh, rectangle_mesh
from conservation_fem_tpu_torch.ops.spaces import (FunctionSpace, build_space,
                                                   permute_dofs,
                                                   rcm_dof_permutation)
from conservation_fem_tpu_torch.ops.spmv import ell_diag, ell_matvec

STABILIZATIONS = ("gfem", "rv", "rv_simple", "si")
# Jacobi-preconditioned spectra by degree (the JAX package's measurements
# on the mass matrix: P1 [.5, 2], P2 [.39, 2.06], P3 [.29, 2.01]; the CN
# operator is a small dt-skew perturbation of it)
MASS_BOUNDS = {1: (0.5, 2.0), 2: (0.35, 2.1), 3: (0.25, 2.1)}
CN_BOUNDS = {1: (0.4, 2.2), 2: (0.3, 2.2), 3: (0.2, 2.2)}


@dataclasses.dataclass(frozen=True)
class HOAdvectionConfig:
    mesh_size: int = 16
    degree: int = 2
    domain: str = "disk"           # "disk" | "square"
    stabilization: str = "gfem"    # gfem | rv | rv_simple | si
    discontinuous_ic: bool = False
    CFL: float = 0.5
    T: float = 1.0
    Cvel: float = 0.25
    CRV: float = 1.0
    Cm: float = 0.5
    si_eps: float = 1e-8
    krylov_rtol: float = 1e-12
    # project the disk's boundary dofs onto the unit circle (isoparametric
    # boundary cells)
    curved_boundary: bool = False
    # "gather" or "blocked" (RCM dof order, the ELL kernels)
    ell_matvec_backend: str = "gather"
    # fixed-iteration solvers (None = adaptive)
    cg_iters: int | None = None
    krylov_iters: int | None = None
    inner_solver: str = "bicgstab"   # bicgstab | cheby
    cheby_mass_bounds: tuple | None = None   # None: MASS_BOUNDS[degree]
    cheby_cn_bounds: tuple | None = None     # None: CN_BOUNDS[degree]
    # blocked backend: the JAX package's quality flag, accepted and read by
    # nothing (see HyperbolicConfig.blocked_precise)
    blocked_precise: bool = True
    dtype: str = "float64"


def check_supported(cfg: HOAdvectionConfig):
    """Raise for unknown options, and NotImplementedError naming the
    ROADMAP item for the blocked backend."""
    if cfg.stabilization not in STABILIZATIONS:
        raise ValueError(f"unknown stabilization {cfg.stabilization!r}")
    if cfg.degree not in (1, 2, 3):
        raise ValueError("degree must be 1, 2 or 3")
    if cfg.domain not in ("disk", "square"):
        raise ValueError(f"unknown domain {cfg.domain!r}")
    if cfg.inner_solver not in ("bicgstab", "cheby"):
        raise ValueError(f"unknown inner_solver {cfg.inner_solver!r}")
    if cfg.ell_matvec_backend not in ("gather", "blocked"):
        raise ValueError(
            f"unknown ell_matvec_backend {cfg.ell_matvec_backend!r}")


ic_discontinuous = la.initial_condition_discont


@dataclasses.dataclass
class HOProblem:
    cfg: HOAdvectionConfig
    host_mesh: Mesh
    space: FunctionSpace   # host arrays
    dt: float
    num_steps: int
    mesh: object           # SpaceArrays on the problem's device (JAX: sp)
    w: torch.Tensor        # (ndof,2)
    M: torch.Tensor
    C: torch.Tensor
    h_cg: torch.Tensor | None
    K_bc: torch.Tensor | None
    u0: torch.Tensor
    plan: object = None    # ops/blocked.BlockedPlan (blocked backend)
    # blocked: the RCM dof permutation (old -> new); u[space_perm] is the
    # solution in the native dof order
    space_perm: np.ndarray | None = None


def get_nodal_h_pk(sp, M=None, rtol=1e-14):
    """The cells' shortest edges (DG0) L2-projected into the Pk space:
    M h = b, b_a = sum over the cells of 2 h_k area_k int phi_a dxi."""
    b_loc = 2.0 * (sp.h_cell * sp.area)[:, None] * torch.einsum(
        "q,qa->a", sp.quad_w, sp.phi)[None]
    b = apk.scatter_vector(sp, b_loc)
    if M is None:
        M = apk.assemble_mass(sp)
    pre = jacobi_preconditioner(ell_diag(sp, M))
    return cg(lambda x: ell_matvec(sp, M, x), b, precond=pre, rtol=rtol).x


def unit_disk_projector(p):
    """(n,2) -> the points scaled onto the unit circle."""
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def build(cfg: HOAdvectionConfig | None = None, device=None,
          host_mesh: Mesh | None = None, **kw) -> HOProblem:
    """The Pk advection problem on ``device`` (None: the card; raises
    without one. device="cpu" for the CPU)."""
    if cfg is None:
        cfg = HOAdvectionConfig(**kw)
    check_supported(cfg)
    device = get_device(device)
    dtype = getattr(torch, cfg.dtype)
    hmax = 1.0 / cfg.mesh_size
    if host_mesh is None:
        host_mesh = (disk_mesh(hmax) if cfg.domain == "disk" else
                     rectangle_mesh((0, 0), (1, 1), nx=cfg.mesh_size))
    projector = (unit_disk_projector
                 if cfg.curved_boundary and cfg.domain == "disk" else None)
    space = build_space(host_mesh, cfg.degree, boundary_projector=projector)
    plan = perm = None
    if cfg.ell_matvec_backend == "blocked":
        perm = rcm_dof_permutation(space)
        space = permute_dofs(space, perm)
        plan = bpk.make_blocked_pk_plan(space, dtype=dtype, device=device)
        sp = plan.mesh
    else:
        sp = space.device_arrays(dtype, device)
    w = la.velocity(sp.dof_coords)
    dt, num_steps = la.cfl_time_step(cfg.CFL, hmax, cfg.T, w)
    asm = ((lambda L: blocked.assemble_matrix(plan, L)) if plan is not None
           else (lambda L: apk.scatter_matrix(sp, L)))
    M = asm(apk.mass_locals(sp))
    C = asm(apk.convection_locals(sp, w))
    h_cg = K_bc = None
    if cfg.stabilization in ("rv", "rv_simple", "si"):
        h_cg = get_nodal_h_pk(sp, M)
    if cfg.stabilization == "si":
        K_bc = ell_with_bc(sp, asm(apk.stiffness_locals(sp)),
                           sp.boundary_mask)
    icfn = ic_discontinuous if cfg.discontinuous_ic else la.initial_condition
    u0 = icfn(sp.dof_coords[:, 0], sp.dof_coords[:, 1]).to(dtype)
    return HOProblem(cfg=cfg, host_mesh=host_mesh, space=space, dt=dt,
                     num_steps=num_steps, mesh=sp, w=w, M=M, C=C, h_cg=h_cg,
                     K_bc=K_bc, u0=u0, plan=plan, space_perm=perm)


def _cn_solve(p: HOProblem, Keps, u_n):
    """(M + dt/2 (C + Keps)) u = (M - dt/2 (C + Keps)) u_n, u|bc = 0."""
    dt = p.dt
    CK = p.C if Keps is None else p.C + Keps
    cfg = p.cfg
    return la.cn_solve(p, p.M + 0.5 * dt * CK, p.M - 0.5 * dt * CK, u_n,
                       cfg.cheby_cn_bounds or CN_BOUNDS[cfg.degree])


def _residual(p: HOProblem, u_n, u_old):
    """The BDF1 residual projection with Rh|bc = 0."""
    cfg = p.cfg
    return la.residual_bdf1(p, u_n, u_old,
                            cfg.cheby_mass_bounds or MASS_BOUNDS[cfg.degree])


def _epsilon(p: HOProblem, stabilization, u_n, u_old):
    cfg = p.cfg
    beta = torch.linalg.norm(p.w, dim=1)
    if stabilization == "si":
        return stab.si_epsilon(p.mesh, cfg.Cm, p.K_bc, u_n, beta, p.h_cg,
                               eps_floor=cfg.si_eps).epsilon
    Rh = _residual(p, u_n, u_old)
    if stabilization == "rv" and p.plan is not None:
        return blocked.rv_epsilon_linear(p.plan, cfg.Cvel, cfg.CRV, u_n, u_n,
                                         beta, Rh, p.h_cg)
    if stabilization == "rv":
        return stab.rv_epsilon_linear(p.mesh, cfg.Cvel, cfg.CRV, u_n, u_n,
                                      p.w, Rh, p.h_cg)
    return stab.rv_epsilon_linear_simple(cfg.Cvel, cfg.CRV, p.w, Rh, u_n,
                                         p.h_cg)


def _step(p: HOProblem, u_n, u_old, stabilization=None):
    """One step of ``stabilization`` (None: the config's)."""
    stabilization = stabilization or p.cfg.stabilization
    Keps = None
    if stabilization != "gfem":
        eps = _epsilon(p, stabilization, u_n, u_old)
        Keps = (blocked.assemble_matrix(p.plan, bpk.pk_eps_locals(p.plan,
                                                                  eps))
                if p.plan is not None
                else apk.assemble_eps_stiffness(p.mesh, eps))
    return _cn_solve(p, Keps, u_n)


def solve(p: HOProblem):
    """(u, L2 error against the IC's interpolant) after num_steps steps;
    rv and rv_simple start with one plain GFEM step."""
    u_n, u_old, n = p.u0, p.u0, p.num_steps
    if p.cfg.stabilization in ("rv", "rv_simple"):
        u_n, n = _step(p, p.u0, p.u0, "gfem"), n - 1
    for _ in range(n):
        u_n, u_old = _step(p, u_n, u_old), u_n
    return u_n, la.l2_error_vs_ic(p, u_n)


def run(cfg: HOAdvectionConfig | None = None, device=None,
        host_mesh: Mesh | None = None, **kw):
    """(problem, u, L2 error as a float), as the JAX package's run."""
    if cfg is None:
        cfg = HOAdvectionConfig(**kw)
    p = build(cfg, device=device, host_mesh=host_mesh)
    u, err = solve(p)
    return p, u, float(err)
