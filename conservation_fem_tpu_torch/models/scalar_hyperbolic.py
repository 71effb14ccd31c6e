"""Scalar nonlinear conservation law u_t + div f(u) = 0 in 2D, P1 FEM +
Crank-Nicolson + Newton with RV or SI shock capturing, ported from
conservation_fem_tpu/models/scalar_hyperbolic.py.

Per time step (``HyperbolicProblem.step``, the generic ELL backend):
  1. BDF2 (or BDF1) residual projection, a mass solve:
       M RH = M (3 u_n - 4 u_old + u_old_old)/(2 dt) + N(u_n),  RH|bc = 0,
     N(u)_a = int (f'(u) . grad u) phi_a dx;
  2. epsilon: the RV patch kernel, the SI kernel on the bc-applied
     stiffness, or 0 (gfem);
  3. the stabilised CN Newton solve
       F(v) = M(v - u_n) + dt/2 [N(v) + N(u_n)] + dt/2 Keps (v + u_n),
     v|bc = g(t), with the assembled exact Jacobian M + dt/2 (C'(v) +
     Keps) and BiCGStab (or fixed-iteration) inner solves;
  4. optional post-solve patch smoothing (smooth_l > 0);
  5. the history shift.
Every operator is an (N,K) ELL matrix over the mesh's node patches
(ops/assembly.py, ops/spmv.py); on the card they are plain PyTorch gathers
and segmented sums (no hand-written kernel: the JAX package runs this step
as XLA gathers, not Pallas). ``ell_matvec_backend="lattice"`` applies them
as lattice-stencil planes instead (ops/lattice.py; dofs on a regular
lattice: a structured rectangle mesh, any degree): each assembled operator
is laid out once, and its products are shifted multiply-adds between one
scatter onto the grid and one gather back. ``"banded"`` (an RCM-ordered
mesh) applies the products through the hand-written ELL SpMV kernel
(ops/ell_kernels.ell_spmv) and assembles as the gather backend does. The
JAX package stores each operator as its 2B+1 diagonals (B the bandwidth)
and applies it as shifted multiply-adds, because a gather is slow on the
TPU; on the card that costs 2B+1 multiply-adds a row where the ELL row
holds K entries (after RCM B is 1210 at irregular_mesh nx 640, K 11),
while a gather runs at the memory rate, so the diagonal storage is not
ported, and the Jacobi preconditioner reads ``ell_diag``, the band's
middle row there. ``"blocked"`` and ``"blocked2d"`` are the unstructured fast
path of models/blocked_hyperbolic.py, which this class, built directly
with them, runs as the gather backend (the JAX package's base class does
the same). The structured stencil backend
(models/structured_hyperbolic.py) overrides the step. The JAX
``lax.scan`` time loop is a Python loop here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.ops import lattice as lat
from conservation_fem_tpu_torch.ops import stabilization as stab
from conservation_fem_tpu_torch.ops.bc import constrain_residual, ell_with_bc
from conservation_fem_tpu_torch.ops.ell_kernels import ell_spmv
from conservation_fem_tpu_torch.ops.helpers import get_nodal_h_ell
from conservation_fem_tpu_torch.ops.krylov import (cg, cg_fixed,
                                                   chebyshev_fixed, dot,
                                                   jacobi_preconditioner)
from conservation_fem_tpu_torch.ops.mesh import Mesh, with_kernel_index
from conservation_fem_tpu_torch.ops.newton import newton_fixed, newton_solve
from conservation_fem_tpu_torch.ops.spmv import ell_diag, ell_matvec
from conservation_fem_tpu_torch.ops.structured import Flux
from conservation_fem_tpu_torch.utils.checkpoint import (checkpoint_file,
                                                         load_checkpoint,
                                                         save_checkpoint)


@dataclasses.dataclass(frozen=True)
class HyperbolicConfig:
    stabilization: str = "rv"      # rv | si | gfem
    residual_scheme: str = "bdf2"  # bdf2 | bdf1
    Cvel: float = 0.5
    CRV: float = 4.0
    Cm: float = 1.0                # SI: eps = psi(alpha) Cm h beta
    si_eps: float = 1e-8           # SI: floor of alpha's denominator
    newton_rtol: float = 1e-4
    newton_atol: float = 1e-10
    newton_max_it: int = 100
    krylov_rtol: float = 1e-12
    # inner Newton linear-solve tolerance; None = krylov_rtol
    newton_linear_rtol: float | None = None
    # modified Newton: one Jacobian per step instead of per iteration
    modified_newton: bool = False
    # FIXED iteration counts (throughput paths); None = adaptive solvers
    cg_iters: int | None = None          # residual-projection mass solve
    newton_iters: int | None = None      # outer Newton iterations
    newton_linear_iters: int = 8         # inner BiCGStab iterations
    inner_solver: str = "bicgstab"       # bicgstab | cheby (dot-free)
    # fixed path only: skip the residual at the final Newton iterate (it
    # feeds only the converged flag)
    newton_final_residual: bool = True
    cheby_mass_bounds: tuple = (0.5, 2.0)
    cheby_lin_bounds: tuple = (0.4, 2.2)
    # bf16 operator-plane streams of the TPU kernels: not ported
    tiled_bf16_planes: bool = False
    xla_bf16_planes: bool = False
    # f64-accumulated dots in the ELL step's solvers (ops/precision
    # dot_acc64); the stencil backend's solvers never read it, as in the
    # JAX package
    precise_reductions: bool = False
    smooth_l: float = 0.0          # > 0: post-solve patch smoothing
    # ELL operator application: "gather" ((N,K) gather and row sum),
    # "lattice" (ops/lattice.py planes), "banded" (the ELL SpMV kernel on
    # an RCM-ordered mesh), "blocked" / "blocked2d" (models/
    # blocked_hyperbolic.py, the hand-written ELL kernels)
    ell_matvec_backend: str = "gather"
    # blocked backends: the JAX package's quality flag (f32 one-hots and
    # HIGHEST contractions there, bf16 streams when False). Accepted so
    # that the JAX package's configurations build, and read by nothing:
    # the port computes f32 at f32 either way, so f32 blocked runs are held
    # by the anchor gates, not elementwise against the JAX package's f32
    # blocked runs (whose default streams bf16)
    blocked_precise: bool = False
    # blocked backends: apply the per-step operators (eps-stiffness, flux
    # Jacobian) matrix-free from the cell locals (ops/blocked.local_apply)
    # instead of assembling the Jacobian; the same contributions, summed
    # in another order
    blocked_matrix_free: bool = False
    # hand-written kernels: fused whole-step kernel on the fixed path, the
    # fused adaptive CG on the adaptive path (JAX: use_pallas); stencil
    # backend only
    use_kernels: bool = False
    # fused kernel: K full time steps per launch (time-independent bc)
    fused_substeps: int = 1
    dtype: str = "float64"
    record_metrics: bool = False


ELL_BACKENDS = ("gather", "lattice", "banded", "blocked", "blocked2d")


def check_supported(cfg: HyperbolicConfig):
    """Raise for the features this port does not have yet, naming the
    ROADMAP item that brings each."""
    todo = []
    if cfg.stabilization not in ("rv", "si", "gfem"):
        raise ValueError(f"unknown stabilization {cfg.stabilization!r}")
    if cfg.tiled_bf16_planes or cfg.xla_bf16_planes:
        todo.append("bf16 operator planes (ROADMAP queue 2 item 5c, only "
                    "if the H100 measures a reason)")
    if cfg.ell_matvec_backend not in ELL_BACKENDS:
        raise ValueError(
            f"unknown ell_matvec_backend {cfg.ell_matvec_backend!r}")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


class HyperbolicProblem:
    """Holds the static setup; ``step`` advances one time step and
    ``solve`` runs the time loop.

    flux: ops.structured.Flux (f', f'' and |f'|)
    bc_value: (points, t) -> Dirichlet data at the points, read on the
    boundary nodes only; t a number or a column of S times, giving (S, N)
    or a row that broadcasts to it
    """

    def __init__(self, cfg: HyperbolicConfig, host_mesh: Mesh, flux: Flux,
                 bc_value: Callable, u0_fn: Callable, dt: float,
                 num_steps: int, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.host_mesh = host_mesh
        self.device = get_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        points, boundary_nodes = self._host_nodes(host_mesh)
        self._lattice = None
        if cfg.ell_matvec_backend == "lattice":
            self._lattice = (lat.build_plan(points), None)
        self.points = torch.as_tensor(points, dtype=self.dtype,
                                      device=self.device)
        self.flux = flux
        self.bc_value = bc_value
        self.dt = float(dt)
        self.num_steps = int(num_steps)
        self.u0 = u0_fn(self.points[:, 0], self.points[:, 1]).to(self.dtype)
        self._carry = None
        self._start_step = 0
        self._mesh = self._M = self._h_cg = self._K_bc = None
        # the boundary nodes, flat: the only nodes at which a step reads g
        self._frame = torch.as_tensor(boundary_nodes, device=self.device)
        self._g_shape, self._g2 = tuple(self.u0.shape), None

    def _host_nodes(self, host_mesh):
        """(coordinates (N,2), boundary node ids) of the unknowns, host
        numpy: the mesh's vertices for P1 (the Pk subclass: its dofs)."""
        return host_mesh.points, host_mesh.boundary_nodes

    # -- lazily built ELL operators -------------------------------------------

    @property
    def mesh(self):
        """The mesh's tensors (MeshArrays) on the problem's device, built on
        first use: the stencil backend never reads them."""
        if self._mesh is None:
            m = self.host_mesh.device_arrays(self.dtype, self.device)
            if self.cfg.ell_matvec_backend == "banded":
                m = with_kernel_index(m)
            self._mesh = m
        return self._mesh

    @property
    def M(self):
        """ELL consistent mass, built lazily."""
        if self._M is None:
            self._M = assembly.assemble_mass(self.mesh)
        return self._M

    @property
    def h_cg(self):
        """Nodal h (the mass-solve projection of the cell sizes), lazily."""
        if self._h_cg is None:
            self._h_cg = get_nodal_h_ell(self.mesh, mass_ell=self.M)
        return self._h_cg

    @property
    def K_bc(self):
        """The bc-applied stiffness the SI kernel reads (SI only)."""
        if self._K_bc is None and self.cfg.stabilization == "si":
            K = assembly.assemble_stiffness(self.mesh)
            self._K_bc = ell_with_bc(self.mesh, K, self.mesh.boundary_mask)
        return self._K_bc

    def _force_lazy_operators(self):
        """Build the static operators before the time loop, so that the
        first step's time is a step's."""
        _ = self.M
        if self.cfg.stabilization in ("rv", "si"):
            _ = self.h_cg
        if self.cfg.stabilization == "si":
            _ = self.K_bc

    def _linear_op(self, A_ell):
        """(matvec, diag) of an assembled ELL operator: the gather SpMV, or
        on the lattice backend its planes, laid out here (the converter
        made at the first call)."""
        if self._lattice is not None:
            plan, conv = self._lattice
            if conv is None:
                conv = lat.ell_to_planes_fn(plan, self.mesh)
                self._lattice = (plan, conv)
            op = conv(A_ell)
            return ((lambda x: lat.from_grid(plan, op(lat.to_grid(plan, x)))),
                    ell_diag(self.mesh, A_ell))
        if self.cfg.ell_matvec_backend == "banded":
            return ((lambda x: ell_spmv(self.mesh, A_ell, x)),
                    ell_diag(self.mesh, A_ell))
        return ((lambda x: ell_matvec(self.mesh, A_ell, x)),
                ell_diag(self.mesh, A_ell))

    def _constrained_op(self, A_ell):
        """(x -> A_bc x, diag of A with 1 on the bc rows): the operator
        with its bc rows and columns replaced by the identity, as the
        solves with Dirichlet rows take it."""
        bc = self.mesh.boundary_mask
        mv, diag = self._linear_op(A_ell)
        return ((lambda x: torch.where(bc, x, mv(torch.where(bc, 0.0, x)))),
                torch.where(bc, 1.0, diag))

    # -- carry and Dirichlet data ---------------------------------------------

    def set_carry(self, u_n, u_old, u_old_old, start_step=0):
        """Start ``solve`` from the history (u_n, u_old, u_old_old), given as
        numpy arrays or tensors in the flat node order — e.g. a JAX state
        from the middle of a trajectory — instead of (u0, u0, u0).
        start_step: the steps that state has already taken (the JAX solve's
        start_step); ``solve`` then runs the remaining num_steps -
        start_step steps at their own times, which time-dependent
        Dirichlet data read."""
        if not 0 <= start_step <= self.num_steps:
            raise ValueError(f"start_step {start_step} outside [0, "
                             f"{self.num_steps}]")
        self._carry = tuple(
            torch.as_tensor(v if isinstance(v, torch.Tensor) else np.array(v),
                            dtype=self.dtype, device=self.device)
            .reshape(-1).clone() for v in (u_n, u_old, u_old_old))
        self._start_step = int(start_step)

    def _initial_carry(self):
        if self._carry is not None:
            return self._carry
        return (self.u0, self.u0, self.u0)

    def step_times(self, start_step=0):
        """t of steps start_step .. num_steps - 1, (k + 1) dt formed in the
        problem's dtype as the JAX time loop forms it (its Dirichlet data
        read t there)."""
        ks = torch.arange(start_step, self.num_steps, dtype=self.dtype)
        return ((ks + 1.0) * self.dt).tolist()

    def dirichlet_frames(self, times):
        """(len(times), boundary nodes): the Dirichlet data of each of
        ``times`` on the boundary nodes (on a structured grid its frame),
        from one call of bc_value with t a column (for data that change
        every step: no kernel a step for them)."""
        t = torch.tensor(times, dtype=self.dtype, device=self.device)
        g = self.bc_value(self.points[self._frame], t[:, None])
        return torch.broadcast_to(g, (len(times), self._frame.numel()))

    def dirichlet_grid(self, frame_values):
        """g in the step's layout (flat on the ELL backend, (n1x, n1y) on
        the stencil backend) from one step's boundary values: scattered
        into the problem's one g buffer, zero inside, so the previous
        step's g is overwritten (in stream order on the card)."""
        if self._g2 is None:
            self._g2 = torch.zeros(self._g_shape, dtype=self.dtype,
                                   device=self.device)
        self._g2.view(-1).index_copy_(0, self._frame, frame_values)
        return self._g2

    def step_dirichlet(self, times):
        """The Dirichlet data of each step of ``times``, in the form ``step``
        takes them."""
        return map(self.dirichlet_grid, self.dirichlet_frames(times))

    # -- step pieces ------------------------------------------------------------

    def _nonlinear_rhs(self, u):
        """N(u)_a = int (f'(u) . grad u) phi_a dx."""
        return assembly.convection_rhs_flux(self.mesh, u, self.flux)

    def _assemble_keps(self, eps):
        return assembly.assemble_eps_stiffness(self.mesh, eps)

    def _assemble_flux_jacobian(self, u):
        return assembly.assemble_flux_jacobian(self.mesh, u, self.flux)

    @property
    def _dot(self):
        """Inner product of the solvers: f64-accumulated under
        precise_reductions (ops/precision.dot_acc64)."""
        if self.cfg.precise_reductions:
            from conservation_fem_tpu_torch.ops.precision import dot_acc64

            return dot_acc64
        return dot

    def _residual_bdf2(self, u_n, u_old, u_old_old, N_un=None):
        """BDF1/BDF2 residual projection with RH|bc = 0."""
        cfg, dt = self.cfg, self.dt
        bc = self.mesh.boundary_mask
        if cfg.residual_scheme == "bdf1":
            du = (u_n - u_old) / dt
        else:
            du = (3.0 * u_n - 4.0 * u_old + u_old_old) / (2.0 * dt)
        if N_un is None:
            N_un = self._nonlinear_rhs(u_n)
        M_mv, _ = self._linear_op(self.M)
        rhs = torch.where(bc, 0.0, M_mv(du) + N_un)
        op, M_diag = self._constrained_op(self.M)
        pre = jacobi_preconditioner(M_diag)
        if cfg.cg_iters is not None:
            if cfg.inner_solver == "cheby":
                lo, hi = cfg.cheby_mass_bounds
                return chebyshev_fixed(op, rhs, precond=pre,
                                       iters=cfg.cg_iters, lmin=lo,
                                       lmax=hi).x
            return cg_fixed(op, rhs, precond=pre, iters=cfg.cg_iters,
                            dot=self._dot).x
        return cg(op, rhs, precond=pre, rtol=cfg.krylov_rtol,
                  dot=self._dot).x

    def _epsilon(self, u_n, RH):
        cfg = self.cfg
        if cfg.stabilization == "rv":
            return stab.rv_epsilon_nonlinear(
                self.mesh, cfg.Cvel, cfg.CRV, u_n, u_n,
                self.flux.fprime_norm, RH, self.h_cg)
        if cfg.stabilization == "si":
            return stab.si_epsilon(
                self.mesh, cfg.Cm, self.K_bc, u_n,
                self.flux.fprime_norm(u_n), self.h_cg,
                eps_floor=cfg.si_eps).epsilon
        return torch.zeros_like(u_n)     # gfem

    def _newton_cn(self, u_n, eps, g, N_un=None):
        """Stabilised CN Newton solve with u|bc = g."""
        dt = self.dt
        bc = self.mesh.boundary_mask
        Keps = self._assemble_keps(eps)
        if N_un is None:
            N_un = self._nonlinear_rhs(u_n)
        M_mv, _ = self._linear_op(self.M)
        K_mv, _ = self._linear_op(Keps)
        Keps_un = K_mv(u_n)

        def residual(v):
            F = (M_mv(v - u_n)
                 + 0.5 * dt * (self._nonlinear_rhs(v) + N_un)
                 + 0.5 * dt * (K_mv(v) + Keps_un))
            return constrain_residual(F, v, g, bc)

        base = self.M + 0.5 * dt * Keps

        def jacobian(u):
            """J = M + dt/2 (C'(u) + Keps), assembled: an inner iteration
            is one ELL product."""
            J = base + 0.5 * dt * self._assemble_flux_jacobian(u)
            matvec, J_diag = self._constrained_op(J)
            return matvec, jacobi_preconditioner(J_diag)

        return self._newton_dispatch(residual, jacobian,
                                     torch.where(bc, g, u_n))

    def _newton_dispatch(self, residual, jacobian, u_init, dot=None):
        """Fixed-iteration or adaptive Newton, per the config; dot: the
        solvers' inner product (None: the problem's, ``_dot``; the sharded
        twins pass their block-ordered one)."""
        cfg = self.cfg
        dot = self._dot if dot is None else dot
        if cfg.newton_iters is not None:
            return newton_fixed(
                residual, u_init, iters=cfg.newton_iters,
                linear_iters=cfg.newton_linear_iters, jacobian_fn=jacobian,
                freeze_jacobian=cfg.modified_newton, rtol=cfg.newton_rtol,
                atol=cfg.newton_atol, linear_solver=cfg.inner_solver,
                cheby_bounds=cfg.cheby_lin_bounds,
                final_residual=cfg.newton_final_residual, dot=dot)
        return newton_solve(
            residual, u_init, rtol=cfg.newton_rtol, atol=cfg.newton_atol,
            max_it=cfg.newton_max_it,
            linear_rtol=cfg.newton_linear_rtol or cfg.krylov_rtol,
            jacobian_fn=jacobian, freeze_jacobian=cfg.modified_newton,
            dot=dot)

    def _smooth(self, u):
        """Post-solve patch smoothing."""
        return stab.smooth_vector(self.mesh, u, self.cfg.smooth_l)

    def step(self, carry, t, g=None):
        """One full stabilised time step; carry = (u_n, u_old, u_old_old),
        g: the step's Dirichlet data from ``step_dirichlet`` (None: formed
        from t)."""
        if g is None:
            g = self.dirichlet_grid(self.dirichlet_frames([t])[0])
        u_n, u_old, u_old_old = carry
        N_un = RH = None
        if self.cfg.stabilization == "rv":
            N_un = self._nonlinear_rhs(u_n)
            RH = self._residual_bdf2(u_n, u_old, u_old_old, N_un=N_un)
        eps = self._epsilon(u_n, RH)
        res = self._newton_cn(u_n, eps, g, N_un=N_un)
        uh = res.u
        if self.cfg.smooth_l > 0:
            uh = self._smooth(uh)
        metrics = None
        if self.cfg.record_metrics:
            metrics = {
                "eps_max": eps.max(),
                "newton_iters": res.iters,
                "newton_converged": res.converged,
                "residual_norm": res.residual_norm,
                "u_min": uh.min(),
                "u_max": uh.max(),
            }
        return (uh, u_n, u_old), metrics

    def solve(self, checkpoint_path: str | None = None,
              checkpoint_every: int = 0, resume: bool = False,
              stream=None):
        """Run the time loop from the initial carry; returns SolveResult.
        With record_metrics the per-step metrics of the steps run are
        stacked into tensors.

        With checkpoint_path and checkpoint_every > 0 the carry (u_n,
        u_old, u_old_old), the step index and t are saved to the .npz
        file that utils/checkpoint.save_checkpoint writes for
        checkpoint_path after every checkpoint_every steps and after the
        last; resume=True restarts from that file when it exists (written
        by either package). The steps keep the times, and so the Dirichlet
        data, of the uninterrupted run.

        stream: a utils/streaming.StreamingSink; each step's (u, t) goes
        to its ``emit`` in step order (the JAX package's in-scan
        io_callback)."""
        checkpointed = bool(checkpoint_path) and checkpoint_every > 0
        if checkpointed and stream is not None:
            raise ValueError(
                "stream= is not supported together with checkpointing "
                "(the chunked scan would bypass the streaming sink); "
                "run with one or the other")
        self._force_lazy_operators()
        start, carry = self._start_step, self._initial_carry()
        if checkpointed:
            path = checkpoint_file(checkpoint_path)
            if resume and os.path.exists(path):
                ck = load_checkpoint(path)
                start = ck.step
                carry = tuple(
                    torch.as_tensor(ck.arrays[k], dtype=self.dtype,
                                    device=self.device)
                    for k in ("u_n", "u_old", "u_old_old"))
        per_step = []
        times = self.step_times(start)
        for k, (t, g) in enumerate(zip(times, self.step_dirichlet(times)),
                                   start + 1):
            carry, m = self.step(carry, t, g)
            if m is not None:
                per_step.append(m)
            if stream is not None:
                stream.emit(carry[0], t)
            if checkpointed and ((k - start) % checkpoint_every == 0
                                 or k == self.num_steps):
                save_checkpoint(path, step=k, t=k * self.dt, u_n=carry[0],
                                u_old=carry[1], u_old_old=carry[2])
        metrics = None
        if per_step:
            metrics = {key: torch.stack([torch.as_tensor(m[key])
                                         for m in per_step])
                       for key in per_step[0]}
        return SolveResult(u=carry[0], metrics=metrics, dt=self.dt,
                           num_steps=self.num_steps)


class SolveResult(NamedTuple):
    u: torch.Tensor
    metrics: object
    dt: float
    num_steps: int
