"""CPU sparse-direct reference implementation of the KPP RV step, ported
from conservation_fem_tpu/utils/baseline_proxy.py (numpy and scipy on the
host; it takes the port's Mesh).

Two roles:

1. **Measured performance baseline.** The reference stack (DOLFINx + PETSc
   LU + per-node Python epsilon loops, ref Code/KPP/KPP_NodeRV.py:127-172)
   is not installable here; this solver reproduces its algorithmic
   structure with scipy.sparse CSR assembly, SuperLU factorization per
   Newton iteration, and the RV epsilon computed by a per-node Python loop
   over patches exactly as Code/Utils/RV.py:56-90 does. The JAX package's
   bench.py times it
   to ground the "vs DOLFINx" throughput ratio. Generosities vs the real
   reference: the mass factorization is reused across steps (the reference
   re-creates LinearProblem + LU every step, ref RV_node.py:209-214) and
   assembly is vectorized NumPy (the reference's ffcx kernels are compiled
   C) — i.e. this proxy is, if anything, faster than the true baseline.

2. **Independent correctness oracle.** The same step as
   models/scalar_hyperbolic.HyperbolicProblem.step computed with a
   completely different stack (scipy LU vs matrix-free Krylov); tests
   assert agreement to ~1e-10. It is the independent reference of the
   port's benchmark.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from conservation_fem_tpu_torch.ops.mesh import Mesh

# degree-4 quadrature (must match ops/assembly.py for oracle-level parity)
_W = np.array(
    [0.223381589678011] * 3 + [0.109951743655322] * 3
)
_a1, _b1 = 0.445948490915965, 0.108103018168070
_a2, _b2 = 0.091576213509771, 0.816847572980459
_P = np.array(
    [[_a1, _a1], [_b1, _a1], [_a1, _b1], [_a2, _a2], [_b2, _a2], [_a2, _b2]]
)
_PHI = np.stack([1 - _P[:, 0] - _P[:, 1], _P[:, 0], _P[:, 1]], axis=1)  # (Q,3)


class ScipyHyperbolicSolver:
    """Sparse-direct CN + Newton + RV for u_t + div f(u) = 0."""

    def __init__(self, host_mesh: Mesh, dt, Cvel, CRV, fprime, fprime_norm,
                 bc_value=np.pi / 4, newton_rtol=1e-4, newton_atol=1e-10):
        # bc_value: scalar, or callable (points (N,2), t) -> (N,)
        self.m = host_mesh
        self.dt = dt
        self.Cvel, self.CRV = Cvel, CRV
        self.fprime = fprime            # u -> (...,2) numpy
        self.fprime_norm = fprime_norm  # u -> |f'| numpy
        self.bc_value = bc_value
        self.newton_rtol = newton_rtol
        self.newton_atol = newton_atol
        n, cells = host_mesh.n_nodes, host_mesh.cells
        self.n = n
        area, grads = host_mesh.area, host_mesh.grads
        # mass matrix (CSR)
        mloc = (np.ones((3, 3)) + np.eye(3)) / 12.0
        vals = area[:, None, None] * mloc[None]
        rows = np.repeat(cells, 3, axis=1).reshape(-1)
        cols = np.tile(cells, (1, 3)).reshape(-1)
        self.M = sp.coo_matrix(
            (vals.reshape(-1), (rows, cols)), shape=(n, n)
        ).tocsr()
        self._rows, self._cols = rows, cols
        # constrained mass (bc rows/cols identity) factored once
        bmask = host_mesh.boundary_mask
        self.bmask = bmask
        Mbc = self._apply_bc_mat(self.M)
        self.lu_Mbc = spla.splu(Mbc.tocsc())
        # patches as python lists (the reference's node_patches dict,
        # ref SI.py:12-28)
        self.patches = [
            host_mesh.patch_cols[i][host_mesh.patch_mask[i]].tolist()
            for i in range(n)
        ]
        # nodal h by mass-solve projection (ref helpers.py:29-36)
        rhs = np.zeros(n)
        np.add.at(rhs, cells.reshape(-1),
                  np.repeat(host_mesh.h_cell * area / 3.0, 3))
        self.h_cg = spla.splu(self.M.tocsc()).solve(rhs)

    # -- pieces -------------------------------------------------------------

    def _apply_bc_mat(self, A):
        A = A.tolil(copy=True)
        idx = np.nonzero(self.bmask)[0]
        A[idx, :] = 0.0
        A[:, idx] = 0.0
        for i in idx:
            A[i, i] = 1.0
        return A.tocsr()

    def nonlinear_rhs(self, u):
        """N(u)_a = int (f'(u).grad u) phi_a, vectorized quadrature."""
        m = self.m
        u_cell = u[m.cells]                        # (M,3)
        u_q = u_cell @ _PHI.T                      # (M,Q)
        fp = self.fprime(u_q)                      # (M,Q,2)
        grad_u = np.einsum("ma,mad->md", u_cell, m.grads)
        conv = np.einsum("mqd,md->mq", fp, grad_u)
        r = np.einsum("mq,qa->ma", conv * (_W * 0.5)[None], _PHI)
        r = 2.0 * m.area[:, None] * r
        out = np.zeros(self.n)
        np.add.at(out, m.cells.reshape(-1), r.reshape(-1))
        return out

    def _keps(self, eps):
        m = self.m
        gg = np.einsum("mad,mbd->mab", m.grads, m.grads)
        scale = m.area * eps[m.cells].mean(axis=1)
        vals = (scale[:, None, None] * gg).reshape(-1)
        return sp.coo_matrix(
            (vals, (self._rows, self._cols)), shape=(self.n, self.n)
        ).tocsr()

    def _conv_jac(self, u):
        """d/du N(u) as CSR: int (f''(u).grad u phi_b + f'(u).g_b) phi_a."""
        m = self.m
        u_cell = u[m.cells]
        u_q = u_cell @ _PHI.T                      # (M,Q)
        fp = self.fprime(u_q)                      # (M,Q,2)
        # f'' via finite difference-free: for our fluxes f'' is analytic but
        # keep generic with numerical directional derivative
        du = 1e-7
        fpp = (self.fprime(u_q + du) - self.fprime(u_q - du)) / (2 * du)
        grad_u = np.einsum("ma,mad->md", u_cell, m.grads)  # (M,2)
        w = (_W * 0.5)[None, :]
        # term1[m,a,b] = 2A sum_q w_q (fpp.grad_u) phi_b phi_a
        t1q = np.einsum("mqd,md->mq", fpp, grad_u)
        term1 = np.einsum("mq,qa,qb->mab", t1q * w, _PHI, _PHI)
        # term2[m,a,b] = 2A sum_q w_q (fp . g_b) phi_a
        t2 = np.einsum("mqd,mbd->mqb", fp, m.grads)
        term2 = np.einsum("mqb,qa->mab", t2 * w[..., None], _PHI)
        vals = 2.0 * m.area[:, None, None] * (term1 + term2)
        return sp.coo_matrix(
            (vals.reshape(-1), (self._rows, self._cols)), shape=(self.n, self.n)
        ).tocsr()

    def rv_epsilon(self, u, RH):
        """Per-node Python loop, mirroring the reference's serial cost
        (ref RV.py:56-90)."""
        n = self.n
        eps = np.zeros(n)
        abs_term = np.abs(u - u.mean()).max()
        absRH = np.abs(RH)
        beta_all = self.fprime_norm(u)
        for i in range(n):
            pj = self.patches[i]
            up = u[pj]
            u_tilde = up.max() - up.min()
            n_i = abs(u_tilde - abs_term)
            R_i = absRH[pj].max() / max(n_i, 1e-300)
            beta = beta_all[pj].max()
            hi = self.h_cg[i]
            eps[i] = min(self.Cvel * hi * beta, self.CRV * hi * hi * abs(R_i))
        return eps

    # -- step ---------------------------------------------------------------

    def step(self, u_n, u_old, u_old_old, t=None):
        dt, bmask = self.dt, self.bmask
        rhs = self.M @ ((3 * u_n - 4 * u_old + u_old_old) / (2 * dt)) \
            + self.nonlinear_rhs(u_n)
        rhs[bmask] = 0.0
        RH = self.lu_Mbc.solve(rhs)
        eps = self.rv_epsilon(u_n, RH)
        Keps = self._keps(eps)
        N_un = self.nonlinear_rhs(u_n)
        Keps_un = Keps @ u_n
        if callable(self.bc_value):
            g = np.asarray(self.bc_value(self.m.points, t))
        else:
            g = np.full(self.n, self.bc_value)
        u = u_n.copy()
        u[bmask] = g[bmask]

        def residual(v):
            F = (self.M @ (v - u_n)
                 + 0.5 * dt * (self.nonlinear_rhs(v) + N_un)
                 + 0.5 * dt * (Keps @ v + Keps_un))
            F[bmask] = v[bmask] - g[bmask]
            return F

        F = residual(u)
        r0 = np.linalg.norm(F)
        for _ in range(100):
            if np.linalg.norm(F) <= self.newton_rtol * r0 + self.newton_atol:
                break
            J = self.M + 0.5 * dt * (self._conv_jac(u) + Keps)
            J = self._apply_bc_mat(J)
            du = spla.splu(J.tocsc()).solve(-F)
            u = u + du
            F = residual(u)
        return u, eps

    def solve(self, u0, num_steps):
        u_n = u_old = u_old_old = u0.copy()
        for i in range(num_steps):
            u, _ = self.step(u_n, u_old, u_old_old, t=(i + 1) * self.dt)
            u_old_old, u_old, u_n = u_old, u_n, u
        return u_n


def make_kpp_proxy(host_mesh: Mesh, dt=0.01):
    """KPP flux instantiation (ref KPP_NodeRV.py:53-55,75-76)."""
    fprime = lambda u: np.stack([np.cos(u), -np.sin(u)], axis=-1)
    fprime_norm = lambda u: np.ones_like(u)
    return ScipyHyperbolicSolver(
        host_mesh, dt, Cvel=0.5, CRV=4.0,
        fprime=fprime, fprime_norm=fprime_norm, bc_value=np.pi / 4,
    )


def make_burgers_proxy(host_mesh: Mesh, dt):
    """Burgers flux instantiation with the exact-solution time-dependent bc
    (ref Exact_Burger_RV.py:33-35,110-111,171-176): the port's
    models/burgers.exact_solution, evaluated in f64 on the host."""
    import torch

    from conservation_fem_tpu_torch.models.burgers import exact_solution

    fprime = lambda u: np.stack([u, u], axis=-1)
    fprime_norm = lambda u: np.sqrt(2.0) * np.abs(u)

    def bc(points, t):
        p = torch.as_tensor(np.asarray(points, dtype=np.float64))
        return exact_solution(p[:, 0], p[:, 1], float(t)).numpy()

    return ScipyHyperbolicSolver(
        host_mesh, dt, Cvel=0.5, CRV=10.0,
        fprime=fprime, fprime_norm=fprime_norm, bc_value=bc,
    )
