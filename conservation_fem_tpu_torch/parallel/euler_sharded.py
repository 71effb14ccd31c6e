"""Row-sharded compressible Euler: the structured-row decomposition of
parallel/structured_sharded.py for the 4-component system, ported from
conservation_fem_tpu/parallel/euler_sharded.py.

Every stencil product, cell kernel and patch reduction is
ShardedStructuredKPP's; the step is the stencil step of models/euler.py
(density RV, then SSP-RK2 or RK3 with the slip projection after each
stage) on (blocks, 4, L, n1y) fields, the layout ``blocks.extend`` takes:
the four components are exchanged together, once per stage, and the
fluxes of the halo rows are formed from the exchanged state (each is a
pointwise function of it, so they are the neighbour's own values). The RV
normalisation takes the density's mean by ``blocks.sum`` and its maximum
deviation by ``blocks.max``. Nothing in a step reads a value on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from conservation_fem_tpu_torch.models import euler
from conservation_fem_tpu_torch.parallel.structured_sharded import (
    ShardedStructuredKPP)


class ShardedStructuredEuler(ShardedStructuredKPP):
    """Construct from a built EulerProblem on the stencil backend
    (backend="auto" on the rectangle); ``solve()`` returns the (N, 4)
    global state, as the single-device ``euler.solve(p).U`` does."""

    _carry_names = ("U", "U_old")

    def __init__(self, problem, blocks):
        p = problem
        if p.sd is None:
            raise ValueError("build the Euler problem with backend='auto' "
                             "(the stencil backend)")
        self.p, self.blocks = p, blocks
        self._layout(p.sd, p.U0)
        self.Mc = self._coef_blocks(p.sd.M_coef)
        self.Cx = self._coef_blocks(p.Cx_c)
        self.Cy = self._coef_blocks(p.Cy_c)
        self.ml = self._blocks_of(p.ml2, 1.0)
        self.bc = self._blocks_of(p.bc2, True)
        self.slip = self._blocks_of(p.slip2, False)
        self.h2 = self._blocks_of(p.sd.h_cg2)

    # -- layout: (blocks, 4, L, n1y) ------------------------------------------

    def _from_global(self, V):
        """An (N, 4) global state (numpy array or tensor) in the blocks'
        layout."""
        V = torch.as_tensor(V if isinstance(V, torch.Tensor) else np.array(V),
                            dtype=self.dtype, device=self.device)
        rows = V.reshape(self.n1x, self.n1y, 4).permute(0, 2, 1)
        return self._blocks_of(rows).permute(0, 2, 1, 3).contiguous()

    def _to_global(self, X):
        """The blocks' layout -> the (N, 4) global state."""
        rows = self.blocks.gather(X).permute(0, 2, 1, 3).reshape(
            -1, 4, self.n1y)
        return rows[:self.n1x].permute(0, 2, 1).reshape(-1, 4)

    def init_carry(self):
        U0 = self._from_global(self.p.U0)
        return (U0, U0)

    # -- step -----------------------------------------------------------------

    def make_step(self):
        """step(U, U_old) -> (U_new, U) on the blocks held here, each
        (blocks, 4, L, n1y)."""
        p, cfg = self.p, self.p.cfg
        dt, gamma, floor = p.dt, cfg.gamma, cfg.rho_floor
        extend = lambda V: self.blocks.extend(V, 1)
        slip = lambda V: euler._zero_component(V, 2, self.slip, 1)

        def rhs(Ve, Kc):
            """-ML^-1 [Cx Fx + Cy Fy + Keps U] from the halo'd state Ve,
            the far-field rows frozen."""
            Fx, Fy = euler.flux(Ve, gamma, floor, axis=1)
            div = self._apply(self.Cx, Fx) + self._apply(self.Cy, Fy)
            dU = -(div + self._apply(Kc, Ve)) / self.ml[:, None]
            return torch.where(self.bc[:, None], 0.0, dU)

        def step(U, U_old):
            Ue = extend(U)
            # RV from the density residual
            rho_dot = (U[:, 0] - U_old[:, 0]) / dt
            div_m = (self._apply(self.Cx, Ue[:, 1])
                     + self._apply(self.Cy, Ue[:, 2])) / self.ml
            R = rho_dot + div_m
            beta_e = euler.wavespeed(Ue, gamma, floor, axis=1)
            eps = self._rv_eps(U[:, 0], Ue[:, 0], R, beta_e)
            Kc = self._keps(eps)
            Un = euler._ssp_rk(
                cfg, dt, U,
                lambda V: rhs(Ue if V is U else extend(V), Kc), slip)
            return Un, U

        return step

    def _step_data(self, start_step, n):
        """Nothing besides the carry: the Euler data do not depend on t."""
        return [()] * n

def shard_euler(problem, blocks):
    return ShardedStructuredEuler(problem, blocks)
