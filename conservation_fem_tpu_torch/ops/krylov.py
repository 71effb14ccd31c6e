"""Matrix-free Krylov solvers with Jacobi preconditioning, ported from
conservation_fem_tpu/ops/krylov.py.

The adaptive solvers (``cg``, ``bicgstab``) run the JAX ``while_loop`` as
a Python loop whose stopping test reads one scalar per iteration on the
host. The fixed-iteration solvers read nothing on the host and keep the
JAX breakdown guards exactly (``safe_div``, the CG ``rz > 0`` freeze).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from conservation_fem_tpu_torch.ops.structured import tiny_of


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor   # final ||r||
    converged: torch.Tensor  # bool


def _identity(x):
    return x


def dot(a, b):
    return torch.sum(a * b)


def cg(matvec: Callable, b, *, precond: Callable = _identity, rtol=1e-12,
       maxiter=1000) -> KrylovResult:
    """Preconditioned conjugate gradient for SPD operators, from x = 0."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    tol2 = (rtol * torch.sqrt(dot(b, b))) ** 2
    rz = dot(r, z)
    k = 0
    while k < maxiter and bool(dot(r, r) > tol2):
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    rnorm = torch.sqrt(dot(r, r))
    return KrylovResult(x, k, rnorm, rnorm <= torch.sqrt(tol2))


def bicgstab(matvec: Callable, b, *, precond: Callable = _identity,
             rtol=1e-12, maxiter=2000) -> KrylovResult:
    """Preconditioned BiCGStab for nonsymmetric operators (CN Newton
    Jacobians), from x = 0; stops on convergence, maxiter or breakdown."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    rhat = r
    tol = rtol * torch.sqrt(dot(b, b))
    eps_break = tiny_of(b.dtype)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    k, brk = 0, False
    while k < maxiter and not brk and bool(torch.sqrt(dot(r, r)) > tol):
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        denom = dot(rhat, v)
        alpha = rho_new / denom
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        tt = dot(t, t)
        omega = dot(t, s) / torch.where(tt == 0, 1.0, tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        brk = bool((rho_new.abs() < eps_break) | (denom.abs() < eps_break)
                   | (omega.abs() < eps_break))
        k += 1
    rnorm = torch.sqrt(dot(r, r))
    return KrylovResult(x, k, rnorm, rnorm <= tol)


def cg_fixed(matvec: Callable, b, *, iters: int,
             precond: Callable = _identity) -> KrylovResult:
    """CG with a FIXED iteration count (no adaptive stopping reduction),
    from x = 0."""
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = dot(r, p)
    tiny = tiny_of(b.dtype)
    for _ in range(iters):
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp.abs() > 0, pAp, tiny)
        # freeze once converged (rz ~ 0): take a zero step
        alpha = torch.where(rz > 0, alpha, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz > 0, rz, tiny)
        p = z + beta * p
        rz = rz_new
    rnorm = torch.sqrt(dot(r, r))
    return KrylovResult(x, iters, rnorm,
                        torch.ones((), dtype=torch.bool, device=b.device))


def safe_div(num, den, tiny):
    ok = den.abs() > tiny
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def bicgstab_fixed(matvec: Callable, b, *, iters: int,
                   precond: Callable = _identity) -> KrylovResult:
    """BiCGStab with a FIXED iteration count, from x = 0. Breakdown-safe:
    when a denominator underflows the remaining iterations take zero
    steps."""
    x = torch.zeros_like(b)
    r = b
    rhat = r
    tiny = tiny_of(b.dtype)
    p, rho = r, dot(rhat, r)
    for _ in range(iters):
        phat = precond(p)
        v = matvec(phat)
        alpha = safe_div(rho, dot(rhat, v), tiny)
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        omega = safe_div(dot(t, s), dot(t, t), tiny)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_new = dot(rhat, r)
        beta = safe_div(rho_new, rho, tiny) * safe_div(alpha, omega, tiny)
        p = r + beta * (p - omega * v)
        rho = rho_new
    rnorm = torch.sqrt(dot(r, r))
    return KrylovResult(x, iters, rnorm,
                        torch.ones((), dtype=torch.bool, device=b.device))


def chebyshev_fixed(matvec: Callable, b, *, iters: int, lmin: float,
                    lmax: float,
                    precond: Callable = _identity) -> KrylovResult:
    """Preconditioned Chebyshev semi-iteration over eigenvalue bounds
    [lmin, lmax] of the preconditioned operator, from x = 0 — zero inner
    products."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    f = lambda c: torch.tensor(c, dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    d = precond(r) / f(theta)
    rho = f(1.0 / sigma1)
    for _ in range(iters):
        x = x + d
        r = r - matvec(d)
        z = precond(r)
        rho_new = 1.0 / (f(2.0 * sigma1) - rho)
        d = rho_new * rho * d + rho_new * f(2.0 / delta) * z
        rho = rho_new
    rnorm = torch.linalg.norm(r)
    return KrylovResult(x, iters, rnorm, torch.isfinite(rnorm))


def jacobi_preconditioner(diag):
    """Inverse-diagonal preconditioner; safe where diag == 0."""
    inv = torch.where(diag != 0, 1.0 / diag, 1.0)
    return lambda r: inv * r
