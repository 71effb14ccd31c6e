"""Newton solvers with an assembled Jacobian callback, ported from
conservation_fem_tpu/ops/newton.py.

``jacobian_fn(u) -> (matvec, precond)`` supplies the Jacobian action (the
structured backend assembles stencil planes), so no automatic
differentiation is involved. Semantics follow the JAX package:
its "residual" criterion (||F(u)|| <= rtol ||F(u0)|| + atol), the
10%-stagnation guard, and for ``newton_fixed`` the frozen Jacobian and
``final_residual``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from conservation_fem_tpu_torch.ops.krylov import (bicgstab, bicgstab_fixed,
                                                   chebyshev_fixed, dot)


class NewtonResult(NamedTuple):
    u: torch.Tensor
    iters: int
    converged: torch.Tensor  # metric <= tol OR stagnated at the dtype floor
    residual_norm: torch.Tensor


def newton_solve(residual_fn: Callable, u0, *, jacobian_fn: Callable,
                 rtol=1e-4, atol=1e-10, max_it=100, linear_rtol=1e-12,
                 linear_maxiter=2000, freeze_jacobian: bool = False,
                 dot: Callable = dot) -> NewtonResult:
    """Solve residual_fn(u) = 0 with BiCGStab inner solves; ``dot``: the
    inner product of the norms and of the inner solves."""
    norm = lambda v: torch.sqrt(dot(v, v))
    F = residual_fn(u0)
    r0_norm = norm(F)
    frozen = jacobian_fn(u0) if freeze_jacobian else None

    def linear_solve(u, F):
        matvec, precond = frozen if frozen is not None else jacobian_fn(u)
        return bicgstab(matvec, -F, precond=precond, rtol=linear_rtol,
                        maxiter=linear_maxiter, dot=dot).x

    # the first iteration always runs (the loop tests after an update)
    u = u0 + linear_solve(u0, F)
    F = residual_fn(u)
    tiny = torch.tensor(1e-300, dtype=u0.dtype, device=u0.device)
    metric = norm(F)
    tol = rtol * torch.maximum(r0_norm, tiny) + atol
    stall_tol = math.sqrt(rtol) * r0_norm + atol
    prev = torch.tensor(math.inf, dtype=u0.dtype, device=u0.device)
    k = 1
    while k < max_it and bool(metric > tol) and not bool(metric > 0.9 * prev):
        u = u + linear_solve(u, F)
        F = residual_fn(u)
        prev, metric = metric, norm(F)
        k += 1
    stalled_ok = (metric > 0.9 * prev) & (metric <= stall_tol)
    return NewtonResult(u, k, (metric <= tol) | stalled_ok, norm(F))


def newton_fixed(residual_fn: Callable, u0, *, iters: int,
                 linear_iters: int, jacobian_fn: Callable,
                 freeze_jacobian: bool = False, rtol=1e-4, atol=1e-10,
                 linear_solver: str = "bicgstab",
                 cheby_bounds: tuple = (0.4, 2.2),
                 final_residual: bool = True,
                 dot: Callable = dot) -> NewtonResult:
    """Newton with FIXED outer and inner iteration counts. The returned
    ``converged`` flag reports the residual criterion; with
    final_residual=False the last iterate's residual is skipped and the
    flag reports the residual before the last correction."""
    norm = lambda v: torch.sqrt(dot(v, v))
    F = residual_fn(u0)
    r0_norm = norm(F)
    frozen = jacobian_fn(u0) if freeze_jacobian else None
    u = u0
    for k in range(iters):
        matvec, precond = frozen if frozen is not None else jacobian_fn(u)
        if linear_solver == "cheby":
            du = chebyshev_fixed(matvec, -F, precond=precond,
                                 iters=linear_iters, lmin=cheby_bounds[0],
                                 lmax=cheby_bounds[1]).x
        else:
            du = bicgstab_fixed(matvec, -F, precond=precond,
                                iters=linear_iters, dot=dot).x
        u = u + du
        if k < iters - 1 or final_residual:
            F = residual_fn(u)
    rnorm = norm(F)
    return NewtonResult(u, iters, rnorm <= rtol * r0_norm + atol, rnorm)
