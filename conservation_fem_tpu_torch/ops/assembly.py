"""P1 quadrature tables and local closed forms (port of
conservation_fem_tpu/ops/assembly.py, the parts the stencil path reads).

Local mass on a triangle of area A: M_ab = A/12 * (1 + delta_ab). The
nonlinear convection integrals use the degree-4 Dunavant rule (6 points).
Tables are host numpy f64; callers cast them to the compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch

# degree-4 Dunavant rule on the reference triangle (6 points), exact to p=4
_DUN4_W = np.array(
    [0.223381589678011, 0.223381589678011, 0.223381589678011,
     0.109951743655322, 0.109951743655322, 0.109951743655322])
_a1, _b1 = 0.445948490915965, 0.108103018168070
_a2, _b2 = 0.091576213509771, 0.816847572980459
_DUN4_P = np.array(
    [[_a1, _a1], [_b1, _a1], [_a1, _b1],
     [_a2, _a2], [_b2, _a2], [_a2, _b2]])


def _quad_basis():
    """P1 basis values at the quadrature points: (Q,3) f64."""
    x, y = _DUN4_P[:, 0], _DUN4_P[:, 1]
    return np.stack([1.0 - x - y, x, y], axis=1)


def local_mass(area):
    """(M,) tensor -> (M,3,3) local mass matrices."""
    base = (torch.ones(3, 3, dtype=area.dtype, device=area.device)
            + torch.eye(3, dtype=area.dtype, device=area.device)) / 12.0
    return area[:, None, None] * base[None]
