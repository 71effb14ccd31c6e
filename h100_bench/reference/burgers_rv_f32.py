"""Plain reference of the configuration ``burgers_rv_f32``: 2D Burgers
u_t + u (u_x + u_y) = 0 on the unit square with the quadrant Riemann data
and its closed-form five-band solution as time-dependent Dirichlet data
(upstream ``Code/Burgers_equation/Exact_Burger_RV.py:26-28,105-111``).

dt = CFL min h_CG, h_CG the nodal h: the cell sizes projected on the
mass by Jacobi-PCG to rtol 1e-14. Upstream projects in f64. The program
projects in the configuration's dtype and in f64 and takes the smaller
(its step counts then match in f32 and f64); ``time_step`` follows that
rule statement for statement, on the CPU, so that both sides step the same
times t_k = (k + 1) dt, formed in the configuration's dtype, at which the
exact solution gives the frame's values.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference import p1_structured as p1

SQRT2 = math.sqrt(2.0)
FLUX = p1.Flux(fx=lambda u: u, fy=lambda u: u, dfx=torch.ones_like,
               dfy=torch.ones_like, norm=lambda u: SQRT2 * u.abs())
IC_RANGE = 0.8 - (-1.0)


def axes(mesh: int):
    return np.linspace(0.0, 1.0, mesh + 1), np.linspace(0.0, 1.0, mesh + 1)


def initial_condition(x, y):
    """Quadrant Riemann data."""
    u = torch.zeros_like(x)
    u = torch.where((x <= 0.5) & (y >= 0.5), -0.2, u)
    u = torch.where((x > 0.5) & (y >= 0.5), -1.0, u)
    u = torch.where((x <= 0.5) & (y < 0.5), 0.5, u)
    u = torch.where((x > 0.5) & (y < 0.5), 0.8, u)
    return u


def exact_solution(x, y, t):
    """The five-band solution at times t > 0 (a column (S, 1) in x's
    dtype): later bands overwrite earlier ones, so ties at band edges go
    to the later band."""
    u = torch.zeros(torch.broadcast_shapes(x.shape, t.shape), dtype=x.dtype,
                    device=x.device)

    m1 = x <= 0.5 - 0.6 * t
    u = torch.where(m1 & (y > 0.5 + 0.15 * t), -0.2, u)
    u = torch.where(m1 & (y <= 0.5 + 0.15 * t), 0.5, u)

    m2 = (x >= 0.5 - 0.6 * t) & (x <= 0.5 - 0.25 * t)
    line2 = -8.0 * x / 7.0 + 15.0 / 14.0 - 15.0 * t / 28.0
    u = torch.where(m2 & (y > line2), -1.0, u)
    u = torch.where(m2 & (y <= line2), 0.5, u)

    m3 = (x >= 0.5 - 0.25 * t) & (x <= 0.5 + 0.5 * t)
    line3 = x / 6.0 + 5.0 / 12.0 - 5.0 * t / 24.0
    u = torch.where(m3 & (y > line3), -1.0, u)
    u = torch.where(m3 & (y <= line3), 0.5, u)

    m4 = (x >= 0.5 + 0.5 * t) & (x <= 0.5 + 0.8 * t)
    line4 = x - 5.0 / (18.0 * t) * (x + t - 0.5) ** 2
    fan = (2.0 * x - 1.0) / (2.0 * t)
    u = torch.where(m4 & (y > line4), -1.0, u)
    u = torch.where(m4 & (y <= line4), fan, u)

    m5 = x >= 0.5 + 0.8 * t
    u = torch.where(m5 & (y > 0.5 - 0.1 * t), -1.0, u)
    u = torch.where(m5 & (y <= 0.5 - 0.1 * t), 0.8, u)
    return u


def _min_h_cg(mesh: int, dtype):
    """min over the nodes of h_CG in ``dtype``, on the CPU: the shortest
    edge of each cell times its area over 3, summed at its corners, solved
    on the consistent mass by Jacobi-PCG from 0 to rtol 1e-14 (at most
    1000 iterations). Cells in the mesh's order: every lower triangle of
    the quads (i, j) in row-major order, then every upper one."""
    x, y = axes(mesh)
    X, Y = np.meshgrid(x, y, indexing="ij")
    P = np.stack([X, Y], axis=-1)                    # (n1x, n1y, 2)
    nx = ny = mesh
    sizes, areas = [], []
    for cs in p1.CORNERS:
        p = [P[di:di + nx, dj:dj + ny].reshape(-1, 2) for di, dj in cs]
        e1, e2 = p[1] - p[0], p[2] - p[0]
        areas.append(0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]))
        edge = lambda a, b: np.linalg.norm(p[a] - p[b], axis=1)
        sizes.append(np.minimum(np.minimum(edge(0, 1), edge(0, 2)),
                                edge(1, 2)))
    h_cell, area = np.concatenate(sizes), np.concatenate(areas)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)
    shape = (2, nx, ny)
    vals = (t(h_cell).reshape(shape) * t(area).reshape(shape)
            / 3.0)[..., None].expand(*shape, 3)
    n1x, n1y = nx + 1, ny + 1
    b = torch.zeros((n1x, n1y), dtype=dtype)
    for ti, cs in enumerate(p1.CORNERS):
        for a, (di, dj) in enumerate(cs):
            b[di:di + nx, dj:dj + ny] += vals[ti, :, :, a]
    a0 = t(area[0])
    eye = torch.eye(3, dtype=dtype)
    mloc = (a0 * (torch.ones_like(eye) + eye) / 12.0).expand(2, nx, ny, 3, 3)
    M = torch.zeros((7, n1x, n1y), dtype=dtype)
    for ti, cs in enumerate(p1.CORNERS):
        for a, (dai, daj) in enumerate(cs):
            for c, (dbi, dbj) in enumerate(cs):
                k = p1.PLANE[(dbi - dai, dbj - daj)]
                M[k, dai:dai + nx, daj:daj + ny] += mloc[ti, :, :, a, c]

    def matvec(v):
        vp = F.pad(v, (1, 1, 1, 1))
        out = M[0] * v
        for k, (di, dj) in enumerate(p1.OFFSETS[1:], start=1):
            out = out + M[k] * vp[1 + di:1 + di + n1x, 1 + dj:1 + dj + n1y]
        return out

    dot = lambda u, v: torch.sum(u * v)
    inv = torch.where(M[0] != 0, 1.0 / M[0], 1.0)
    xk = torch.zeros_like(b)
    r = b - matvec(xk)
    z = inv * r
    p = z
    tol2 = (1e-14 * torch.sqrt(dot(b, b))) ** 2
    rz = dot(r, z)
    k = 0
    while k < 1000 and bool(dot(r, r) > tol2):
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        xk = xk + alpha * p
        r = r - alpha * Ap
        z = inv * r
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return float(xk.min())


def time_step(config, mesh: int, dtype):
    """dt = CFL min h_CG, the smaller of the projections in ``dtype`` and
    in f64."""
    h = _min_h_cg(mesh, dtype)
    if dtype != torch.float64:
        h = min(h, _min_h_cg(mesh, torch.float64))
    return config["solver"]["CFL"] * h


def scheme(config, traffic, dtype, device):
    """The scheme in ``dtype``; dt and the step times follow the
    configuration's dtype (``config['solver']['dtype']``) whatever dtype
    the scheme computes in, as they are inputs of the configuration."""
    mesh, T = traffic["mesh"], traffic["T"]
    x, y = axes(mesh)
    grid = p1.Grid(x, y, dtype, device)
    cfg_dtype = getattr(torch, config["solver"]["dtype"])
    dt = time_step(config, mesh, cfg_dtype)
    steps = int(np.ceil(T / dt))
    times = ((torch.arange(0, steps, dtype=cfg_dtype) + 1.0) * dt).tolist()

    def boundary(xb, yb, k0, k1):
        t = torch.tensor(times[k0:k1], dtype=xb.dtype, device=xb.device)
        return exact_solution(xb, yb, t[:, None])

    s = config["solver"]
    solver = p1.Solver(Cvel=s["Cvel"], CRV=s["CRV"], cg_iters=s["cg_iters"],
                       newton_iters=s["newton_iters"],
                       lin_iters=s["newton_linear_iters"],
                       modified_newton=s["modified_newton"])
    return p1.Scheme(grid, FLUX, solver, dt, steps, boundary)
