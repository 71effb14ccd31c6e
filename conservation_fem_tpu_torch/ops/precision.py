"""f64-accumulated reductions, ported from
conservation_fem_tpu/ops/precision.py (``dot_acc64``, ``sum_acc64``).

The inputs stay in their dtype; the products and the sum are formed in
f64 and the result is cast back. ``precise_reductions`` hands
``dot_acc64`` to the solvers of the ELL step, which shrinks the seed that
a change of summation order plants in an f32 shock trajectory from f32
eps to f64 eps. ``einsum_exact`` is not needed: TF32 is off and asserted
in the package root. The sharded twins (``pdot_acc64``, ``psum_acc64``)
belong to the sharded blocked path (ROADMAP queue 1 item 15c).
"""

from __future__ import annotations

import torch


def dot_acc64(a, b):
    """sum(a * b) accumulated in f64, cast back to a's dtype."""
    if a.dtype == torch.float64:
        return torch.sum(a * b)
    return torch.sum(a.double() * b.double()).to(a.dtype)


def sum_acc64(x):
    """sum(x) accumulated in f64, cast back to x's dtype."""
    if x.dtype == torch.float64:
        return torch.sum(x)
    return torch.sum(x.double()).to(x.dtype)
