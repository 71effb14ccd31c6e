"""The one generator of the benchmark's traffic: the initial data of each
trajectory of a cell.

A traffic file (``traffic/<name>.json``) fixes the grid (``mesh``), the
horizon (``T``) and the perturbation; the configuration's plain reference
(``reference/<config>.py``) gives the grid's axes, the published initial
data and their range. Trajectory k starts from

    u0_k = u0 + amplitude * range * w(s) / modes
           * sum_m a_m exp(-|s - c_m|^2 / (2 r_m^2))

in the domain's unit coordinates s: centres c_m uniform in the inner box
[margin, 1 - margin]^2, widths r_m uniform in ``width``, signs and sizes
a_m uniform in [-1, 1], and w the product over both axes of
sin^2(pi (s - margin) / (1 - 2 margin)) inside the box and 0 outside it,
so the perturbation is smooth and vanishes on and near the frame, where
the published Dirichlet data hold. Every trajectory does the same work:
the solvers run fixed iteration counts.

The parameters of every trajectory come from ``--seed`` alone, drawn at
set-up in one call on the device (a torch.Generator seeded with it): row k
of ``ROWS`` for trajectory k (k modulo ROWS), the last row for the
warm-up.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROWS = 1 << 16
WARMUP = ROWS


class Traffic:
    """The initial data of the trajectories of a cell, on ``device``."""

    def __init__(self, spec, reference, seed: int, dtype, device):
        self.spec = spec
        x, y = reference.axes(spec["mesh"])
        X, Y = np.meshgrid(x, y, indexing="ij")
        t = lambda a: torch.as_tensor(a.reshape(-1), dtype=dtype,
                                      device=device)
        self.x, self.y = t(X), t(Y)
        self.base = reference.initial_condition(self.x, self.y)
        unit = lambda a, lo, hi: t((a - lo) / (hi - lo))
        self.sx = unit(X, x[0], x[-1])
        self.sy = unit(Y, y[0], y[-1])
        p = spec["perturbation"]
        m = p["margin"]
        window = 1.0
        for s in (self.sx, self.sy):
            inner = (s >= m) & (s <= 1.0 - m)
            bump = torch.sin(math.pi * (s - m) / (1.0 - 2.0 * m)) ** 2
            window = window * torch.where(inner, bump, 0.0)
        self.scale = p["amplitude"] * reference.IC_RANGE * window / p["modes"]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (1 << 63))
        self.params = torch.rand((ROWS + 1, p["modes"], 4), generator=gen,
                                 dtype=dtype, device=device)

    @property
    def n_nodes(self) -> int:
        return self.x.numel()

    def u0(self, k: int):
        """The initial data of trajectory k (flat, node order)."""
        p, spec = self.params[k if k == WARMUP else k % ROWS], self.spec
        m = spec["perturbation"]["margin"]
        lo, hi = spec["perturbation"]["width"]
        cx = m + (1.0 - 2.0 * m) * p[:, 0, None]
        cy = m + (1.0 - 2.0 * m) * p[:, 1, None]
        r2 = 2.0 * (lo + (hi - lo) * p[:, 2, None]) ** 2
        a = 2.0 * p[:, 3, None] - 1.0
        d2 = (self.sx - cx) ** 2 + (self.sy - cy) ** 2
        return self.base + self.scale * (a * torch.exp(-d2 / r2)).sum(0)
