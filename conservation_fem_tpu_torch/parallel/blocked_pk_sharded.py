"""The sharded blocked Pk solver: the fast higher-order path
(models/blocked_pk_hyperbolic.py) over contiguous row ranges, ported from
conservation_fem_tpu/parallel/blocked_pk_sharded.py.

The layout, the halo and the block plans are parallel/blocked_sharded.py's
over the Pk plan (a SpaceArrays in the RCM-permuted dof numbering): each
block runs the single-device Pk step's launches on its rows (kernel A for
the products, B for the assemblies of the Pk locals, D for the RV patch)
and its Pk quadrature locals in plain PyTorch, on the cells with a dof
among its own rows. Covers rv | si | gfem, bdf1 | bdf2, time-dependent
Dirichlet data, patch smoothing, the adaptive and fixed-iteration solvers
(the assembled Jacobian, as the single-device Pk step has no other).
"""

from __future__ import annotations

from conservation_fem_tpu_torch.ops import blocked_pk as bpk
from conservation_fem_tpu_torch.parallel.blocked_sharded import \
    DistributedBlocked


class DistributedBlockedPk(DistributedBlocked):
    """The sharded twin of a BlockedPkHyperbolicProblem; ``solve()``
    returns the flat global solution in the problem's (RCM-permuted) dof
    numbering: ``u[problem.dof_perm]`` is native. The RV mean is a plain
    sum, as in the single-device Pk step; precise_reductions reaches the
    dots only."""

    PRECISE_MEAN = False
    MATRIX_FREE = False

    def __init__(self, problem, blocks):
        p = problem
        if p.cfg.ell_matvec_backend != "blocked" or not hasattr(p, "space"):
            raise ValueError("DistributedBlockedPk needs a Pk problem on the "
                             "blocked backend")
        p._force_lazy_operators()
        self._setup_layout(p, blocks, p.plan, p.u0)
        stabz = p.cfg.stabilization
        self.M = self.ext_rows(p.M)
        self.Kbc = self.ext_rows(p.K_bc) if stabz == "si" else None
        self.h_ext = (self.ext_rows(p.h_cg) if stabz in ("rv", "si")
                      else None)
        self.h = self.cut(self.h_ext) if self.h_ext is not None else None
        self._L_mass = bpk.pk_mass_locals(self.bp)

    def _newton_parts(self, ee):
        bp, flux, dt = self.bp, self.p.flux, self.p.dt
        L_keps = bpk.pk_eps_locals(bp, ee)
        L_cn = self._L_mass + 0.5 * dt * L_keps
        return ((lambda ve: self.cut(bpk.pk_conv_plus_locals_rhs(
                    bp, ve, flux, L_keps))),
                (lambda ve: L_cn + 0.5 * dt * bpk.pk_flux_jacobian_locals(
                    bp, ve, flux)))

    def _nonlinear_rhs(self, ue):
        return self.cut(bpk.pk_conv_plus_locals_rhs(self.bp, ue,
                                                    self.p.flux))
