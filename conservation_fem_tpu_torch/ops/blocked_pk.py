"""The blocked backend for Pk (degree 2-3) spaces, ported from
conservation_fem_tpu/ops/blocked_pk.py.

The JAX module extends its one-hot window machinery to any degree. The
port's blocked plan is a plan over the ELL structure (ops/blocked.py), and
a SpaceArrays stands in for a MeshArrays there, so a Pk plan is a
``BlockedPlan`` over an RCM-permuted space (ops/spaces.rcm_dof_permutation
+ permute_dofs) with nd = (k+1)(k+2)/2: its products are kernel A, its
assemblies kernel B (both serve any degree), and the Pk quadrature
locals (``pk_*``) stay plain PyTorch, the ``*_locals`` of
ops/assembly_pk.py, in the cell-major layout (M, nd, nd) / (M, nd).
"""

from __future__ import annotations

import torch

from conservation_fem_tpu_torch.ops import assembly_pk as apk
from conservation_fem_tpu_torch.ops import blocked
from conservation_fem_tpu_torch.ops.mesh import with_kernel_index
from conservation_fem_tpu_torch.ops.spaces import FunctionSpace


def make_blocked_pk_plan(space: FunctionSpace, dtype=torch.float32,
                         device=None, arrays=None) -> blocked.BlockedPlan:
    """The plan of an (RCM-permuted) space; arrays: the space's tensors
    when the caller has them (made here on ``device`` otherwise: None is
    the card)."""
    if arrays is None:
        arrays = space.device_arrays(dtype, device)
    return blocked.BlockedPlan(
        n=space.ndof,
        B=blocked.bandwidth(space.patch_cols, space.patch_mask),
        mesh=with_kernel_index(arrays), nd=space.nloc)


def pk_conv_plus_locals_rhs(plan, u, flux, L=None):
    """(N(u) [+ A(L) u])_a -> (n,): the convection quadrature with an
    optional local-matrix action, summed by kernel B."""
    v = apk.convection_rhs_locals(plan.mesh, u, flux)
    if L is not None:
        v = v + torch.einsum("mab,mb->ma", L.reshape(-1, plan.nd, plan.nd),
                             blocked.gather_components(plan, u))
    return blocked.scatter_components(plan, v)


def pk_mass_locals(plan, dtype=None):
    L = apk.mass_locals(plan.mesh)
    return L if dtype is None else L.to(dtype)


def pk_stiffness_locals(plan, dtype=None):
    L = apk.stiffness_locals(plan.mesh)
    return L if dtype is None else L.to(dtype)


def pk_eps_locals(plan, eps):
    return apk.eps_stiffness_locals(plan.mesh, eps)


def pk_flux_jacobian_locals(plan, u, flux):
    return apk.flux_jacobian_locals(plan.mesh, u, flux)


def pk_convection_locals(plan, w):
    """Convection locals with a Pk vector field w (ndof, 2)."""
    return apk.convection_locals(plan.mesh, w)
