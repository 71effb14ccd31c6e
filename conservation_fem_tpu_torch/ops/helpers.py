"""Nodal mesh-size field, ported from conservation_fem_tpu/ops/helpers.py
(the structured stencil backend's part).

The per-cell size h_k (the cell's shortest edge, DG0) is L2-projected onto
P1 by solving M h = b, b_a = sum over the cells at node a of h_k area / 3,
with the port's adaptive Jacobi-PCG to rtol 1e-14 on the stencil mass, as
the JAX package solves it on the ELL mass. The projection of a constant is
exact, so on a uniform mesh the solve returns 1/N up to its tolerance: a
few 1e-15 below it at most sizes, and that is what a caller's time step
(Burgers: dt = CFL min h) and step count inherit.
"""

from __future__ import annotations

import numpy as np
import torch

from conservation_fem_tpu_torch.ops import structured as st
from conservation_fem_tpu_torch.ops.krylov import cg, jacobi_preconditioner


def get_nodal_h(sd: st.StructuredData, h_cell, area, rtol=1e-14):
    """The projected nodal h on the (nx+1, ny+1) grid of ``sd``; h_cell and
    area: the per-cell size and area in the mesh's cell order (all lower
    triangles, then all upper ones), numpy or tensors."""
    shape = (2, sd.nx, sd.ny)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=sd.M_coef.dtype,
                                  device=sd.M_coef.device).reshape(shape)
    rhs_cell = (t(h_cell) * t(area) / 3.0)[..., None].expand(*shape, 3)
    b = st.node_scatter(sd, rhs_cell)
    precond = jacobi_preconditioner(sd.diagM2)
    return cg(lambda x: st.mass_matvec(sd, x), b, precond=precond,
              rtol=rtol).x
