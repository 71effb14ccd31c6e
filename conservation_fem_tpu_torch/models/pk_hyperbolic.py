"""Pk (degree 2-3) nonlinear scalar conservation law, ported from
conservation_fem_tpu/models/pk_hyperbolic.py: the ELL step of
models/scalar_hyperbolic.HyperbolicProblem in a Pk Lagrange space
(ops/spaces.py), with the quadrature assembly of ops/assembly_pk.py.

The step's ELL machinery (SpMV, constrained matvecs, the RV and SI patch
kernels, smoothing) reads only the adjacency, the boundary mask and the
scatter orderings, which a SpaceArrays carries as a MeshArrays does; so
only the assemblies, the nodal h and the unknowns' coordinates change:
the dofs stand where the mesh's vertices stood (the Dirichlet data are
read at the boundary dofs).
"""

from __future__ import annotations

import numpy as np

from conservation_fem_tpu_torch.models.advection_ho import get_nodal_h_pk
from conservation_fem_tpu_torch.models.scalar_hyperbolic import (
    HyperbolicConfig, HyperbolicProblem)
from conservation_fem_tpu_torch.ops import assembly_pk as apk
from conservation_fem_tpu_torch.ops.bc import ell_with_bc
from conservation_fem_tpu_torch.ops.mesh import Mesh, with_kernel_index
from conservation_fem_tpu_torch.ops.spaces import build_space


class PkHyperbolicProblem(HyperbolicProblem):
    """HyperbolicProblem on a Pk Lagrange space (k = 2, 3)."""

    def __init__(self, cfg: HyperbolicConfig, host_mesh: Mesh, degree: int,
                 flux, bc_value, u0_fn, dt, num_steps, device=None):
        self.degree = degree
        self.space = self._make_space(host_mesh, degree)
        super().__init__(cfg, host_mesh, flux=flux, bc_value=bc_value,
                         u0_fn=u0_fn, dt=dt, num_steps=num_steps,
                         device=device)

    def _make_space(self, host_mesh, degree):
        return build_space(host_mesh, degree)

    def _host_nodes(self, host_mesh):
        return (self.space.dof_coords,
                np.nonzero(self.space.boundary_mask)[0])

    @property
    def mesh(self):
        """The space's tensors (SpaceArrays) on the problem's device."""
        if self._mesh is None:
            m = self.space.device_arrays(self.dtype, self.device)
            if self.cfg.ell_matvec_backend == "banded":
                m = with_kernel_index(m)
            self._mesh = m
        return self._mesh

    @property
    def M(self):
        if self._M is None:
            self._M = apk.assemble_mass(self.mesh)
        return self._M

    @property
    def h_cg(self):
        if self._h_cg is None:
            self._h_cg = get_nodal_h_pk(self.mesh, self.M)
        return self._h_cg

    @property
    def K_bc(self):
        if self._K_bc is None and self.cfg.stabilization == "si":
            self._K_bc = ell_with_bc(self.mesh,
                                     apk.assemble_stiffness(self.mesh),
                                     self.mesh.boundary_mask)
        return self._K_bc

    def _nonlinear_rhs(self, u):
        return apk.convection_rhs_flux(self.mesh, u, self.flux)

    def _assemble_keps(self, eps):
        return apk.assemble_eps_stiffness(self.mesh, eps)

    def _assemble_flux_jacobian(self, u):
        return apk.assemble_flux_jacobian(self.mesh, u, self.flux)
