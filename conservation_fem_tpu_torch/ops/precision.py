"""f64-accumulated reductions, ported from
conservation_fem_tpu/ops/precision.py (``dot_acc64``, ``sum_acc64`` and
their sharded twins ``pdot_acc64``, ``psum_acc64``).

The inputs stay in their dtype; the products and the sum are formed in
f64 and the result is cast back. ``precise_reductions`` hands
``dot_acc64`` to the solvers of the ELL step (``pdot_acc64`` to those of
the sharded blocked step, parallel/blocked_sharded.py), which shrinks the
seed that a change of summation order plants in an f32 shock trajectory
from f32 eps to f64 eps. ``einsum_exact`` is not needed: TF32 is off and
asserted in the package root.

The sharded twins take the blocks' owner (parallel/comm.py) where the JAX
ones take a mesh axis: each block's partial is formed in f64 and the
partials are added in f64, in block order, by ``blocks.sum`` (on a process
group: all-gathered and added in block order, as its ``sum`` does).
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


def _block_dot(a, b):
    """(blocks held,) per-block sums of a * b; a, b: (blocks held, ...)."""
    return (a * b).reshape(a.shape[0], -1).sum(dim=1)


def pdot_acc64(blocks):
    """The sharded twin of dot_acc64: pdot(a, b) for a, b laid out
    (blocks held, ...), a 0-dim tensor in a's dtype; f64 inputs pass
    straight through (per-block sums added in block order)."""
    def pdot(a, b):
        if a.dtype == torch.float64:
            return blocks.sum(_block_dot(a, b)).reshape(())
        return blocks.sum(_block_dot(a.double(), b.double())).reshape(
            ()).to(a.dtype)

    return pdot


def psum_acc64(parts, blocks):
    """blocks.sum of the per-block partials ``parts`` (blocks held,) with
    f64 carriage: cast up, added in f64 in block order, cast back."""
    if parts.dtype == torch.float64:
        return blocks.sum(parts)
    return blocks.sum(parts.double()).to(parts.dtype)
