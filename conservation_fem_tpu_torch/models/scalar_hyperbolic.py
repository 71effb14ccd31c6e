"""Scalar nonlinear conservation law u_t + div f(u) = 0 in 2D, P1 FEM +
Crank-Nicolson + Newton with RV shock capturing — the configuration and
the step/solve skeleton ported from
conservation_fem_tpu/models/scalar_hyperbolic.py.

Per time step: BDF2 residual projection (a mass solve), the RV epsilon,
and the stabilised CN Newton solve. This base class holds the setup and
the time loop; the step itself lives in the structured stencil backend
(models/structured_hyperbolic.py). The JAX ``lax.scan`` time loop is a
Python loop here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.ops.mesh import Mesh
from conservation_fem_tpu_torch.ops.structured import Flux


@dataclasses.dataclass(frozen=True)
class HyperbolicConfig:
    stabilization: str = "rv"      # rv | gfem (si: not ported yet)
    residual_scheme: str = "bdf2"  # bdf2 | bdf1
    Cvel: float = 0.5
    CRV: float = 4.0
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
    precise_reductions: bool = False     # not ported yet
    smooth_l: float = 0.0                # post-solve smoothing: not ported
    # hand-written kernels: fused whole-step kernel on the fixed path, the
    # fused adaptive CG on the adaptive path (JAX: use_pallas)
    use_kernels: bool = False
    # fused kernel: K full time steps per launch (time-independent bc)
    fused_substeps: int = 1
    dtype: str = "float64"
    record_metrics: bool = False


def check_supported(cfg: HyperbolicConfig):
    """Raise for the features this port does not have yet, naming the
    ROADMAP item that brings each."""
    todo = []
    if cfg.stabilization == "si":
        todo.append("stabilization='si' (ROADMAP queue 1 item 7)")
    elif cfg.stabilization not in ("rv", "gfem"):
        raise ValueError(f"unknown stabilization {cfg.stabilization!r}")
    if cfg.smooth_l > 0:
        todo.append("smooth_l > 0 (ROADMAP queue 1 item 7)")
    if cfg.precise_reductions:
        todo.append("precise_reductions (ROADMAP queue 1 items 7, 13 and "
                    "15)")
    if cfg.tiled_bf16_planes or cfg.xla_bf16_planes:
        todo.append("bf16 operator planes (ROADMAP queue 2 item 5, only "
                    "if the H100 measures a reason)")
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
        self.points = torch.as_tensor(host_mesh.points, dtype=self.dtype,
                                      device=self.device)
        self.flux = flux
        self.bc_value = bc_value
        self.dt = float(dt)
        self.num_steps = int(num_steps)
        self.u0 = u0_fn(self.points[:, 0], self.points[:, 1]).to(self.dtype)
        self._carry = None
        self._start_step = 0

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

    def step_dirichlet(self, times):
        """The Dirichlet data of each step of ``times``, in the form ``step``
        takes them (None: the step forms them from its t)."""
        return [None] * len(times)

    def step(self, carry, t, g=None):
        """One full stabilised time step; carry = (u_n, u_old, u_old_old),
        g: the step's Dirichlet data from ``step_dirichlet``."""
        raise NotImplementedError(
            "the unstructured (ELL) step is not ported yet (ROADMAP queue 1 "
            "item 7); build on a structured mesh")

    def solve(self, checkpoint_path: str | None = None,
              checkpoint_every: int = 0, resume: bool = False,
              stream=None):
        """Run the time loop from the initial carry; returns SolveResult.
        With record_metrics the per-step metrics are stacked into tensors
        of length num_steps."""
        if checkpoint_path or checkpoint_every or resume or stream:
            raise NotImplementedError(
                "checkpointing and streaming are not ported yet (ROADMAP "
                "queue 1 item 14)")
        carry = self._initial_carry()
        per_step = []
        times = self.step_times(self._start_step)
        for t, g in zip(times, self.step_dirichlet(times)):
            carry, m = self.step(carry, t, g)
            if m is not None:
                per_step.append(m)
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
