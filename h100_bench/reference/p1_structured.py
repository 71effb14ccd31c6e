"""Plain PyTorch reference of the P1 structured RV step and its time loop.

This is the yardstick that decides `correct`: a straightforward version of
the published scheme (upstream ``Code/KPP/KPP_NodeRV.py`` and
``Code/Burgers_equation/Exact_Burger_RV.py``, node-based residual
viscosity), written with torch and numpy alone. It imports nothing of the
program under test and takes nothing it made: the grid, the geometry, the
mass planes, the quadrature and the Dirichlet data are worked out here from
the configuration.

One step on the "/"-triangulated rectangle, node id = i * (ny + 1) + j:

  1. BDF2 residual projection: M RH = M (3 u - 4 u_old + u_old_old) / (2 dt)
     + N(u), RH = 0 on the frame, by a fixed number of Jacobi-PCG
     iterations from 0;
  2. RV viscosity eps = min(Cvel h beta, CRV h^2 |R|), beta the patch max of
     |f'(u)|, R the patch max of |RH| over |patch range - max|u - mean u||;
  3. CN Newton with a fixed number of iterations on
     F(v) = M (v - u) + dt/2 (N(v) + N(u)) + dt/2 K_eps (v + u), v = g on
     the frame, each correction a fixed number of Jacobi-BiCGStab
     iterations on J = M + dt/2 (K_eps + N'(w)), w the first iterate under
     modified Newton.

N(u)_a = int (f'(u) . grad u) phi_a dx by the degree-4 Dunavant rule; every
operator is a 7-plane stencil over the offsets OFFSETS. Dirichlet rows and
columns are replaced by the identity in the solves.

On a CUDA device ``trajectory`` captures one step in a CUDA graph and
replays it, so the check costs the device time of the plain step and not
the host's launches; ``graphed=False`` runs the same step eagerly.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

OFFSETS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1))
PLANE = {o: k for k, o in enumerate(OFFSETS)}
# corners of the lower and the upper triangle of quad (i, j)
CORNERS = (((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1)))

# Dunavant's degree-4 rule on the reference triangle (weights sum to 1)
DUNAVANT4_W = np.array(
    [0.223381589678011, 0.223381589678011, 0.223381589678011,
     0.109951743655322, 0.109951743655322, 0.109951743655322])
_A1, _B1 = 0.445948490915965, 0.108103018168070
_A2, _B2 = 0.091576213509771, 0.816847572980459
DUNAVANT4_P = np.array([[_A1, _A1], [_B1, _A1], [_A1, _B1],
                        [_A2, _A2], [_B2, _A2], [_A2, _B2]])


class Flux(NamedTuple):
    """f'(u) = (fx, fy), f''(u) = (dfx, dfy) and |f'(u)|, pointwise."""
    fx: Callable
    fy: Callable
    dfx: Callable
    dfy: Callable
    norm: Callable


class Solver(NamedTuple):
    """The fixed-iteration solver of a configuration."""
    Cvel: float
    CRV: float
    cg_iters: int
    newton_iters: int
    lin_iters: int
    modified_newton: bool


def tiny_of(dtype) -> float:
    """Breakdown guard of the fixed solvers and the floor of the RV
    normaliser."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def cell_geometry(p):
    """(area, gradients (3, 2), shortest edge) of the triangle p (3, 2),
    f64."""
    e1, e2 = p[1] - p[0], p[2] - p[0]
    det = e1[0] * e2[1] - e1[1] * e2[0]
    g1 = np.array([e2[1], -e2[0]]) / det
    g2 = np.array([-e1[1], e1[0]]) / det
    grads = np.stack([-(g1 + g2), g1, g2])
    edges = [np.linalg.norm(p[a] - p[b]) for a, b in ((0, 1), (0, 2), (1, 2))]
    return 0.5 * abs(det), grads, min(edges)


class Grid:
    """The structured P1 discretisation of the grid x (n1x,) by y (n1y,)
    (f64 node coordinates) in ``dtype`` on ``device``."""

    def __init__(self, x, y, dtype, device):
        self.x, self.y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        self.n1x, self.n1y = len(x), len(y)
        self.nx, self.ny = self.n1x - 1, self.n1y - 1
        self.dtype, self.device = dtype, device
        pts = lambda c: np.array([[self.x[i], self.y[j]] for i, j in c])
        geo = [cell_geometry(pts(c)) for c in CORNERS]
        area, _, h = geo[0]
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                      device=device)
        self.area = area
        self.h = h
        self.grads_np = np.stack([g for _, g, _ in geo])       # (2, 3, 2)
        phi = np.stack([1.0 - DUNAVANT4_P[:, 0] - DUNAVANT4_P[:, 1],
                        DUNAVANT4_P[:, 0], DUNAVANT4_P[:, 1]], axis=1)
        qw = DUNAVANT4_W * 0.5
        self.phi = t(phi)                                        # (Q, 3)
        # 2 area qw_q phi_qa: the weight of quadrature point q in row a
        self.wphi = t(2.0 * area * qw[:, None] * phi)            # (Q, 3)
        self.grads = t(self.grads_np)
        bc = np.zeros((self.n1x, self.n1y), bool)
        bc[0, :] = bc[-1, :] = bc[:, 0] = bc[:, -1] = True
        self.bc = torch.as_tensor(bc, device=device)
        mloc = area * (np.ones((3, 3)) + np.eye(3)) / 12.0
        self.M = self.local_to_stencil([mloc, mloc])
        self.h2 = torch.full((self.n1x, self.n1y), h, dtype=dtype,
                             device=device)

    # -- grid primitives --------------------------------------------------

    def corners(self, x2, t):
        """x at the three corners of every triangle of type t: (3, nx, ny)."""
        nx, ny = self.nx, self.ny
        return torch.stack([x2[di:di + nx, dj:dj + ny]
                            for di, dj in CORNERS[t]])

    def add_corners(self, out, t, vals):
        """out[corner a of every type-t triangle] += vals[a]."""
        nx, ny = self.nx, self.ny
        for a, (di, dj) in enumerate(CORNERS[t]):
            out[di:di + nx, dj:dj + ny] += vals[a]

    def local_to_stencil(self, locs):
        """Stencil planes (7, n1x, n1y) of the constant local matrices
        locs[t] (3, 3), one per triangle type."""
        nx, ny = self.nx, self.ny
        coef = torch.zeros((7, self.n1x, self.n1y), dtype=self.dtype,
                           device=self.device)
        for t, cs in enumerate(CORNERS):
            for a, (dai, daj) in enumerate(cs):
                for b, (dbi, dbj) in enumerate(cs):
                    p = PLANE[(dbi - dai, dbj - daj)]
                    coef[p, dai:dai + nx, daj:daj + ny] += float(locs[t][a, b])
        return coef

    def shifted(self, x2, pad):
        """The 7 neighbour values of every node, (7, n1x, n1y), ``pad``
        outside the grid."""
        n1x, n1y = self.n1x, self.n1y
        xp = F.pad(x2, (1, 1, 1, 1), value=pad)
        return torch.stack([xp[1 + di:1 + di + n1x, 1 + dj:1 + dj + n1y]
                            for di, dj in OFFSETS])

    def matvec(self, coef, x2):
        return (coef * self.shifted(x2, 0.0)).sum(0)

    def pinned(self, coef, x2):
        """The operator with its Dirichlet rows and columns the identity."""
        y = self.matvec(coef, torch.where(self.bc, 0.0, x2))
        return torch.where(self.bc, x2, y)

    # -- FEM operators ------------------------------------------------------

    def _quad(self, u2, t):
        """(u at the quadrature points (Q, nx, ny), du/dx, du/dy) of every
        type-t triangle."""
        c = self.corners(u2, t)
        g = self.grads[t]
        gx = (g[:, 0, None, None] * c).sum(0)
        gy = (g[:, 1, None, None] * c).sum(0)
        uq = (self.phi[:, :, None, None] * c[None]).sum(1)
        return uq, gx, gy

    def convection(self, u2, flux):
        """N(u)_a = int (f'(u) . grad u) phi_a dx."""
        out = torch.zeros_like(u2)
        for t in range(2):
            uq, gx, gy = self._quad(u2, t)
            conv = flux.fx(uq) * gx + flux.fy(uq) * gy               # (Q, ...)
            vals = (self.wphi[:, :, None, None] * conv[:, None]).sum(0)
            self.add_corners(out, t, vals)
        return out

    def convection_jacobian(self, u2, flux):
        """Stencil planes of dN/du at u."""
        nx, ny = self.nx, self.ny
        coef = torch.zeros((7, self.n1x, self.n1y), dtype=u2.dtype,
                           device=u2.device)
        for t, cs in enumerate(CORNERS):
            uq, gx, gy = self._quad(u2, t)
            fpx, fpy = flux.fx(uq), flux.fy(uq)
            t1 = flux.dfx(uq) * gx + flux.dfy(uq) * gy               # (Q, ...)
            g = self.grads[t]
            # d/du_b of the integrand at q:
            #   f''(u) . grad u phi_b + f'(u) . grad phi_b
            term = (t1[:, None] * self.phi[:, :, None, None]
                    + fpx[:, None] * g[None, :, 0, None, None]
                    + fpy[:, None] * g[None, :, 1, None, None])  # (Q, 3, ..)
            for a, (dai, daj) in enumerate(cs):
                row = (self.wphi[:, a, None, None, None] * term).sum(0)
                for b, (dbi, dbj) in enumerate(cs):
                    p = PLANE[(dbi - dai, dbj - daj)]
                    coef[p, dai:dai + nx, daj:daj + ny] += row[b]
        return coef

    def eps_stiffness(self, eps2):
        """Stencil planes of the stiffness weighted by the P1 field eps
        (its mean over each triangle)."""
        nx, ny = self.nx, self.ny
        coef = torch.zeros((7, self.n1x, self.n1y), dtype=eps2.dtype,
                           device=eps2.device)
        for t, cs in enumerate(CORNERS):
            ae = self.area / 3.0 * self.corners(eps2, t).sum(0)
            g = self.grads_np[t]
            for a, (dai, daj) in enumerate(cs):
                for b, (dbi, dbj) in enumerate(cs):
                    p = PLANE[(dbi - dai, dbj - daj)]
                    coef[p, dai:dai + nx, daj:daj + ny] += (
                        float(g[a] @ g[b]) * ae)
        return coef

    def rv_epsilon(self, u2, rh2, solver, flux):
        """Node-based residual viscosity."""
        spread = (u2 - u2.mean()).abs().max()
        u_max = self.shifted(u2, -math.inf).amax(0)
        u_min = self.shifted(u2, math.inf).amin(0)
        n_i = ((u_max - u_min) - spread).abs()
        r_i = (self.shifted(rh2.abs(), -math.inf).amax(0)
               / n_i.clamp_min(tiny_of(u2.dtype)))
        beta = self.shifted(flux.norm(u2), -math.inf).amax(0)
        return torch.minimum(solver.Cvel * self.h2 * beta,
                             solver.CRV * self.h2 ** 2 * r_i.abs())


# -- fixed-iteration solvers --------------------------------------------------


def _dot(a, b):
    return torch.sum(a * b)


def _safe_div(num, den, tiny):
    ok = den.abs() > tiny
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def cg_fixed(op, b, inv_diag, iters):
    """Jacobi-PCG from 0, ``iters`` iterations; a converged residual
    (r.z = 0) takes zero steps."""
    tiny = tiny_of(b.dtype)
    x, r = torch.zeros_like(b), b
    p = inv_diag * r
    rz = _dot(r, p)
    for _ in range(iters):
        Ap = op(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp.abs() > 0, pAp, tiny)
        alpha = torch.where(rz > 0, alpha, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = _dot(r, z)
        p = z + rz_new / torch.where(rz > 0, rz, tiny) * p
        rz = rz_new
    return x


def bicgstab_fixed(op, b, inv_diag, iters):
    """Jacobi-BiCGStab from 0, ``iters`` iterations; a vanishing
    denominator makes the rest of the iterations zero steps."""
    tiny = tiny_of(b.dtype)
    x, r = torch.zeros_like(b), b
    rhat, p, rho = r, r, _dot(r, r)
    for _ in range(iters):
        phat = inv_diag * p
        v = op(phat)
        alpha = _safe_div(rho, _dot(rhat, v), tiny)
        s = r - alpha * v
        shat = inv_diag * s
        t = op(shat)
        omega = _safe_div(_dot(t, s), _dot(t, t), tiny)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_new = _dot(rhat, r)
        beta = _safe_div(rho_new, rho, tiny) * _safe_div(alpha, omega, tiny)
        p = r + beta * (p - omega * v)
        rho = rho_new
    return x


def _inv_diag(grid, coef):
    d = torch.where(grid.bc, 1.0, coef[0])
    return torch.where(d != 0, 1.0 / d, 1.0)


# -- the step and the time loop ----------------------------------------------


class Scheme:
    """The RV BDF2/CN scheme of one configuration on one grid: ``step``
    advances (u, u_old, u_old_old) by dt with Dirichlet data g on the
    frame; ``trajectory`` runs the whole time loop."""

    def __init__(self, grid: Grid, flux: Flux, solver: Solver, dt: float,
                 num_steps: int, boundary: Callable):
        """boundary(x, y, k0, k1) -> (k1 - k0, len(x)): the Dirichlet data
        of steps k0 .. k1 - 1 at the points (x, y), tensors in the grid's
        dtype on its device."""
        self.grid, self.flux, self.solver = grid, flux, solver
        self.dt, self.num_steps = float(dt), int(num_steps)
        frame = torch.nonzero(grid.bc.reshape(-1)).reshape(-1)
        xy = lambda v: torch.as_tensor(v, dtype=grid.dtype,
                                       device=grid.device)
        X, Y = np.meshgrid(grid.x, grid.y, indexing="ij")
        fr = frame.cpu().numpy()
        self.frame = frame
        self.frame_xy = (xy(X.reshape(-1)[fr]), xy(Y.reshape(-1)[fr]))
        self.boundary = boundary

    def step(self, u, uo, uoo, g):
        grid, flux, s, dt = self.grid, self.flux, self.solver, self.dt
        M, bc = grid.M, grid.bc
        n_u = grid.convection(u, flux)
        du = (3.0 * u - 4.0 * uo + uoo) / (2.0 * dt)
        rhs = torch.where(bc, 0.0, grid.matvec(M, du) + n_u)
        rh = cg_fixed(lambda v: grid.pinned(M, v), rhs, _inv_diag(grid, M),
                      s.cg_iters)
        eps = grid.rv_epsilon(u, rh, s, flux)
        K = grid.eps_stiffness(eps)
        k_u = grid.matvec(K, u)

        def residual(v):
            r = (grid.matvec(M, v - u)
                 + 0.5 * dt * (grid.convection(v, flux) + n_u)
                 + 0.5 * dt * (grid.matvec(K, v) + k_u))
            return torch.where(bc, v - g, r)

        def jacobian(w):
            J = M + 0.5 * dt * (K + grid.convection_jacobian(w, flux))
            return (lambda v: grid.pinned(J, v)), _inv_diag(grid, J)

        v = torch.where(bc, g, u)
        r = residual(v)
        frozen = jacobian(v) if s.modified_newton else None
        for it in range(s.newton_iters):
            op, inv_d = frozen if frozen is not None else jacobian(v)
            v = v + bicgstab_fixed(op, -r, inv_d, s.lin_iters)
            if it < s.newton_iters - 1:
                r = residual(v)
        return v

    def trajectory(self, u0, graphed=None):
        """u after num_steps steps from (u0, u0, u0); u0 flat in node
        order. graphed: replay one step captured in a CUDA graph (None: on
        a CUDA device)."""
        grid = self.grid
        u = u0.to(grid.dtype).reshape(grid.n1x, grid.n1y).clone()
        if graphed is None:
            graphed = u.device.type == "cuda"
        values = self.boundary(*self.frame_xy, 0, self.num_steps)
        g = torch.zeros_like(u)
        set_g = lambda k: g.view(-1).index_copy_(0, self.frame, values[k])
        if not graphed:
            uo, uoo = u, u
            for k in range(self.num_steps):
                set_g(k)
                u, uo, uoo = self.step(u, uo, uoo, g), u, uo
            return u.reshape(-1)
        state = [u, u.clone(), u.clone()]
        set_g(0)
        side = torch.cuda.Stream(device=u.device)
        side.wait_stream(torch.cuda.current_stream(u.device))
        with torch.cuda.stream(side):
            self.step(*state, g)          # allocations before the capture
        torch.cuda.current_stream(u.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.step(*state, g)
        for k in range(self.num_steps):
            set_g(k)
            graph.replay()
            state[2].copy_(state[1])
            state[1].copy_(state[0])
            state[0].copy_(out)
        result = state[0].reshape(-1).clone()
        del graph
        return result
