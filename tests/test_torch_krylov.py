"""Krylov and Newton solvers of the port against the JAX package, on the
structured stencil operators of the KPP step (mesh 2, 9x9 grid, f64).

Tolerance 1e-12 absolute on O(1) solutions: both sides run the same
recurrences in f64; only reduction order differs. The adaptive solvers
stop on the same tests, so they take the same iteration counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops import krylov as jk
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.ops import newton as jn
from conservation_fem_tpu.ops import structured as jst
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import krylov as tk
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import newton as tn
from conservation_fem_tpu_torch.ops import structured as tst

TOL = 1e-12
N = 8
DT = 0.01


class Side:
    """One package's view of the same KPP step operators."""

    def __init__(self, is_jax, u, eps):
        self.is_jax = is_jax
        if is_jax:
            self.st, self.k, self.nw = jst, jk, jn
            self.x = jnp.asarray
            self.where = jnp.where
            host = jmesh.rectangle_mesh((-2, -2), (2, 2), nx=N, ny=N)
            self.sd = jst.build_structured(host, N, N, jnp.float64)
            self.N_kw = dict(fprime=jkpp.flux_prime,
                             fprime_xy=jkpp.flux_prime_xy)
        else:
            self.st, self.k, self.nw = tst, tk, tn
            self.x = torch.tensor
            self.where = torch.where
            host = tmesh.rectangle_mesh((-2, -2), (2, 2), nx=N, ny=N)
            self.sd = tst.build_structured(host, N, N, torch.float64, "cpu")
            self.N_kw = dict(flux=tkpp.FLUX)
        sd, st = self.sd, self.st
        self.u = self.x(u)
        self.Kc = st.keps_coef(sd, self.x(eps))
        self.bc = sd.bc2
        self.N_u = st.nonlinear_rhs(sd, self.u, **self.N_kw)
        self.K_u = st.matvec(sd, self.Kc, self.u)

    def mass_op(self):
        sd = self.sd
        pre = self.k.jacobi_preconditioner(self.where(sd.bc2, 1.0, sd.diagM2))
        return (lambda v: self.st.constrained_matvec(sd, sd.M_coef, v)), pre

    def jacobian(self, w):
        sd, st = self.sd, self.st
        C = st.flux_jacobian_coef(sd, w, **self.N_kw)
        J = sd.M_coef + 0.5 * DT * (self.Kc + C)
        pre = self.k.jacobi_preconditioner(self.where(sd.bc2, 1.0, J[0]))
        return (lambda v: st.constrained_matvec(sd, J, v)), pre

    def residual(self, v):
        sd, st = self.sd, self.st
        F = (st.mass_matvec(sd, v - self.u)
             + 0.5 * DT * (st.nonlinear_rhs(sd, v, **self.N_kw) + self.N_u)
             + 0.5 * DT * (st.matvec(sd, self.Kc, v) + self.K_u))
        g = np.pi / 4
        return self.where(sd.bc2, v - g, F)

    def rhs(self, r):
        return self.where(self.bc, 0.0, self.x(r))


@pytest.fixture(scope="module")
def sides():
    rng = np.random.default_rng(0)
    n1 = N + 1
    u = np.pi / 4 + 3.0 * rng.random((n1, n1))
    eps = 0.05 * rng.random((n1, n1))
    r = rng.normal(size=(n1, n1))
    return Side(True, u, eps), Side(False, u, eps), r


def _solve(side, name, r):
    k = side.k
    mop, mpre = side.mass_op()
    jop, jpre = side.jacobian(side.u)
    b = side.rhs(r)
    if name == "cg":
        return k.cg(mop, b, precond=mpre, rtol=1e-12).x
    if name == "bicgstab":
        return k.bicgstab(jop, b, precond=jpre, rtol=1e-12).x
    if name == "cg_fixed":
        return k.cg_fixed(mop, b, precond=mpre, iters=6).x
    if name == "bicgstab_fixed":
        return k.bicgstab_fixed(jop, b, precond=jpre, iters=4).x
    if name == "chebyshev_fixed_mass":
        return k.chebyshev_fixed(mop, b, precond=mpre, iters=10, lmin=0.5,
                                 lmax=2.0).x
    if name == "chebyshev_fixed_jacobian":
        return k.chebyshev_fixed(jop, b, precond=jpre, iters=16, lmin=0.4,
                                 lmax=2.2).x
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "cg", "bicgstab", "cg_fixed", "bicgstab_fixed", "chebyshev_fixed_mass",
    "chebyshev_fixed_jacobian"])
def test_krylov_matches_jax(sides, name):
    js, ts, r = sides
    ref = np.asarray(_solve(js, name, r))
    got = _solve(ts, name, r).numpy()
    # the solve is not trivial: x is O(1) and not the right-hand side
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_safe_div_guards_fixed_solvers_at_exact_convergence(sides):
    """A zero right-hand side: every denominator is 0 and the fixed solvers
    take zero steps instead of producing NaNs (JAX safe_div semantics)."""
    _, ts, _ = sides
    b = torch.zeros_like(ts.u)
    jop, jpre = ts.jacobian(ts.u)
    mop, mpre = ts.mass_op()
    for x in (tk.bicgstab_fixed(jop, b, precond=jpre, iters=4).x,
              tk.cg_fixed(mop, b, precond=mpre, iters=6).x):
        assert torch.equal(x, torch.zeros_like(x))


def _newton(side, kind):
    u0 = side.where(side.bc, np.pi / 4, side.u)
    nw = side.nw
    if kind == "solve":
        return nw.newton_solve(side.residual, u0, jacobian_fn=side.jacobian,
                               rtol=1e-10, linear_rtol=1e-12).u
    if kind == "solve_frozen":
        return nw.newton_solve(side.residual, u0, jacobian_fn=side.jacobian,
                               freeze_jacobian=True, rtol=1e-8,
                               linear_rtol=1e-12).u
    frozen = kind == "fixed_frozen"
    solver = "cheby" if kind == "fixed_cheby" else "bicgstab"
    return nw.newton_fixed(side.residual, u0, iters=2,
                           linear_iters=16 if solver == "cheby" else 4,
                           jacobian_fn=side.jacobian,
                           freeze_jacobian=frozen, linear_solver=solver,
                           final_residual=False).u


@pytest.mark.parametrize("kind", ["solve", "solve_frozen", "fixed_frozen",
                                  "fixed_fresh", "fixed_cheby"])
def test_newton_matches_jax(sides, kind):
    js, ts, _ = sides
    ref = np.asarray(jax.jit(lambda: _newton(js, kind))())
    got = _newton(ts, kind).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_newton_fixed_converged_flag_and_final_residual(sides):
    """final_residual=False leaves u unchanged and reports the residual
    before the last correction (a larger norm)."""
    _, ts, _ = sides
    u0 = torch.where(ts.bc, np.pi / 4, ts.u)
    kw = dict(iters=3, linear_iters=8, jacobian_fn=ts.jacobian)
    a = tn.newton_fixed(ts.residual, u0, final_residual=True, **kw)
    b = tn.newton_fixed(ts.residual, u0, final_residual=False, **kw)
    assert torch.equal(a.u, b.u)
    assert float(b.residual_norm) > float(a.residual_norm)
    assert bool(a.converged)
