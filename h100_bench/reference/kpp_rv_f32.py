"""Plain reference of the configuration ``kpp_rv_f32``: the KPP rotating
wave u_t + div(sin u, cos u) = 0 on [-2, 2]^2 (Kurganov, Petrova and Popov
2007; upstream ``Code/KPP/KPP_exact.py:75-78``, ``KPP_NodeRV.py:75-76``).

Initial data 14 pi / 4 inside the unit circle and pi / 4 outside; Dirichlet
data pi / 4 on the whole frame at every time; 4 * mesh cells a side; dt
from the configuration's rule, ceil(T / dt) steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import p1_structured as p1

FLUX = p1.Flux(fx=torch.cos, fy=lambda u: -torch.sin(u),
               dfx=lambda u: -torch.sin(u), dfy=lambda u: -torch.cos(u),
               norm=torch.ones_like)
BOUNDARY_VALUE = math.pi / 4.0
# the range of the initial data, the scale of the traffic's perturbations
IC_RANGE = 14.0 * math.pi / 4.0 - math.pi / 4.0


def axes(mesh: int):
    """The grid's node coordinates along x and along y (f64)."""
    n = 4 * mesh
    return np.linspace(-2.0, 2.0, n + 1), np.linspace(-2.0, 2.0, n + 1)


def initial_condition(x, y):
    inside = (x ** 2 + y ** 2) <= 1.0
    return torch.where(inside, torch.full_like(x, 14.0 * math.pi / 4.0),
                       torch.full_like(x, math.pi / 4.0))


def time_step(config, mesh: int):
    """dt = dt_rule.dt * min(1, dt_rule.mesh / mesh) (the upstream dt at
    its mesh, scaled with h beyond it)."""
    rule = config["dt_rule"]
    return rule["dt"] * min(1.0, rule["mesh"] / mesh)


def scheme(config, traffic, dtype, device):
    mesh, T = traffic["mesh"], traffic["T"]
    x, y = axes(mesh)
    grid = p1.Grid(x, y, dtype, device)
    dt = time_step(config, mesh)
    s = config["solver"]

    def boundary(xb, yb, k0, k1):
        return torch.full((k1 - k0, xb.shape[0]), BOUNDARY_VALUE,
                          dtype=xb.dtype, device=xb.device)

    solver = p1.Solver(Cvel=s["Cvel"], CRV=s["CRV"], cg_iters=s["cg_iters"],
                       newton_iters=s["newton_iters"],
                       lin_iters=s["newton_linear_iters"],
                       modified_newton=s["modified_newton"])
    return p1.Scheme(grid, FLUX, solver, dt, int(np.ceil(T / dt)), boundary)
