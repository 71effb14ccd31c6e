"""IPCS Navier-Stokes on row-sharded lattice grids, ported from
conservation_fem_tpu/parallel/stokes_sharded.py.

The step of models/stokes.py (P2-P1 Taylor-Hood, Chorin/IPCS) with the P2
velocity on the fine (2 nx + 1)^2 lattice and the P1 pressure on the
coarse (nx + 1)^2 lattice, both cut into row blocks that line up: block d
holds coarse rows [d L1, (d + 1) L1) and fine rows [d L2, (d + 1) L2),
L2 = 2 L1 (the last blocks padded with pinned rows). Every operator is a
set of lattice planes (ops/lattice.py), converted once on the host:

  * the momentum matrix A, its right-hand-side companion R = (rho/dt) M -
    visc/2 + mu edge/2 and the P2 mass M: fine planes, halo 2 rows;
  * the pressure Poisson K1: coarse planes, halo 1 row;
  * the linear couplings (pressure-div minus pressure-edge, div, grad,
    models/stokes.host_coupling_coo): rectangular planes on the joint fine
    grid (ops/lattice.to_planes_coo, embed_plan), so the boundary-edge
    integral is plain matrix entries and the step needs no facet
    exchange.
The one per-step quadrature, the convection, runs cell by coarse row
(strided slices of the fine grid extended by the next block's first two
rows); the two rows a block's last cells add past its range go to the
next block (``blocks.from_previous``), which adds them to its first rows.
The halos are ``blocks.extend``; the Krylov dots are per-block sums added
in block order (``blocks.sum``).

``multigrid`` composes the V-cycle of ops/multigrid.py with the row
blocks: level-0 weighted-Jacobi smoothing on the own rows with the same
halo products, the post-smoothing residual gathered (``blocks.gather``),
levels >= 1 run whole on every owner (multigrid.coarse_correction), each
block taking its rows of the prolonged correction; a hierarchy with no
stencil level is one dense solve of the gathered residual. No
hand-written kernel lies on this path (the JAX package runs it as XLA).
``solve()`` returns dof vectors, as the single-device solver does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from conservation_fem_tpu_torch.models.stokes import (_phys_grads, auto_kip,
                                                      host_coupling_coo)
from conservation_fem_tpu_torch.ops import lattice as lat
from conservation_fem_tpu_torch.ops import multigrid as mgrid
from conservation_fem_tpu_torch.ops.krylov import (bicgstab, bicgstab_fixed,
                                                   cg, cg_fixed,
                                                   jacobi_preconditioner)
from conservation_fem_tpu_torch.ops.spmv import ell_diag


def _check_halo(offsets, w, name):
    """An offset beyond the halo would read the wrong rows: refuse it."""
    m = max((max(abs(di), abs(dj)) for di, dj in offsets), default=0)
    if m > w:
        raise ValueError(f"{name}: stencil offset {m} exceeds halo width {w}")


class _Planes:
    """Lattice planes cut into the held row blocks: (blocks held, P, L,
    nJ), with their offsets and the index of each offset in the unfolded
    (2 w + 1)^2 window of a halo of w rows."""

    def __init__(self, offsets, planes, w, rows_of, dtype, device):
        self.offsets = tuple(offsets)
        self.w = w
        k = 2 * w + 1
        self.rows = torch.tensor([(di + w) * k + dj + w
                                  for di, dj in self.offsets],
                                 device=device)
        self.planes = rows_of(torch.as_tensor(
            np.asarray(planes), dtype=dtype, device=device).transpose(0, 1))
        self.planes = self.planes.transpose(1, 2).contiguous()


class ShardedStokes:
    """The row-sharded IPCS solver of a StokesProblem (models/stokes.build
    gives (problem, facet data)); ``solve()`` returns (u (2, N2), p (N1))
    dof vectors on the problem's device.

    blocks: LocalBlocks or ProcessGroupBlocks (parallel/comm.py) on the
    problem's device."""

    def __init__(self, p, fd, blocks):
        self.p, self.blocks = p, blocks
        cfg = p.cfg
        nx = self.nx = cfg.nx
        dtype = self.dtype = p.u0.dtype
        device = self.device = p.u0.device
        n_dev = self.n_dev = blocks.n_dev
        self._held = list(blocks.ranks)
        nI1, nI2 = self.nI1, self.nI2 = nx + 1, 2 * nx + 1
        self.nJ1, self.nJ2 = nI1, nI2
        L1 = self.L1 = -(-nI1 // n_dev)
        self.L2 = 2 * L1
        self.rows1, self.rows2 = n_dev * L1, n_dev * self.L2

        plan2 = self.plan2 = lat.build_plan(p.vspace.dof_coords)
        plan1 = self.plan1 = lat.build_plan(p.host_mesh.points)
        plan1e = lat.embed_plan(plan1, 2, nI2, self.nJ2)
        if (plan2.nI, plan2.nJ) != (nI2, self.nJ2):
            raise ValueError("the P2 dofs do not fill the fine lattice")

        # -- the operators as planes, converted once on the host -----------
        sp, mp = p.sp, p.mp
        rho, mu, dt = cfg.rho, cfg.mu, p.dt
        host = lambda t: t.detach().cpu().numpy()
        M2 = host(p.M2)
        zero = np.zeros_like(M2)
        eye = np.stack([np.stack([M2, zero]), np.stack([zero, M2])])
        visc, edge = host(p.visc), host(p.edge)
        A_blocks = (rho / dt) * eye + 0.5 * visc - 0.5 * mu * edge
        R_blocks = (rho / dt) * eye - 0.5 * visc + 0.5 * mu * edge
        fine = lambda t: self._rows(t, self.L2, self.rows2)
        coarse = lambda t: self._rows(t, L1, self.rows1)

        def planes(off_pl, w, name, rows_of):
            _check_halo(off_pl[0], w, name)
            return _Planes(off_pl[0], off_pl[1], w, rows_of, dtype, device)

        s_cols, m_cols = host(sp.patch_cols), host(mp.patch_cols)
        self.A = [planes(lat.to_planes(plan2, s_cols, A_blocks[s, d]), 2,
                         "A", fine) for s in range(2) for d in range(2)]
        self.R = [planes(lat.to_planes(plan2, s_cols, R_blocks[s, d]), 2,
                         "R", fine) for s in range(2) for d in range(2)]
        self.M = planes(lat.to_planes(plan2, s_cols, M2), 2, "M", fine)
        self.K = planes(lat.to_planes(plan1, m_cols, host(p.K1)), 1, "K",
                        coarse)
        coo = host_coupling_coo(p, fd)
        pair = lambda tri, rp, cp, name: planes(
            lat.to_planes_coo(rp, cp, *tri), 2, name, fine)
        self.DE = [pair(coo["DE"][s], plan2, plan1e, "DE") for s in range(2)]
        self.B = [pair(coo["B"][s], plan1e, plan2, "B") for s in range(2)]
        self.G = [pair(coo["G"][s], plan2, plan1e, "G") for s in range(2)]

        # -- masks and diagonals (pad rows pinned, unit diagonal) ----------
        g2 = lambda x, fill=0.0: lat.to_grid(plan2, x, fill)
        g1 = lambda x, fill=0.0: lat.to_grid(plan1, x, fill)
        self.wall = fine(g2(p.wall_mask)) | ~self._valid(self.L2, nI2)
        self.pbc = coarse(g1(p.p_bc_mask)) | ~self._valid(L1, nI1)
        self.pbcval = coarse(g1(p.p_bc_val))
        diag1 = ((rho / dt) * ell_diag(sp, p.M2)
                 + 0.5 * ell_diag(sp, p.visc[0, 0])
                 - 0.5 * mu * ell_diag(sp, p.edge[0, 0]))
        pad1 = lambda t, valid: torch.where(valid, t, 1.0)
        self.diag1 = pad1(fine(g2(diag1, 1.0)), self._valid(self.L2, nI2))
        self.diagK = pad1(coarse(g1(ell_diag(mp, p.K1), 1.0)),
                          self._valid(L1, nI1))
        self.diagM = pad1(fine(g2(ell_diag(sp, p.M2), 1.0)),
                          self._valid(self.L2, nI2))

        # -- the convection: per cell type, its dofs' lattice offsets and
        # the (constant) physical gradients of the basis --------------------
        cd = np.asarray(p.vspace.cell_dofs)
        coords = np.asarray(p.vspace.dof_coords)
        g_all = host(_phys_grads(sp))                  # (M, Q, n, 2)
        half = cd.shape[0] // 2                        # lowers, then uppers
        h_f = 1.0 / (2 * nx)
        self.conv_off, self.conv_g = [], []
        for m_ex in (0, half):
            origin = coords[cd[m_ex]].min(axis=0)
            off = np.rint((coords[cd[m_ex]] - origin) / h_f).astype(int)
            self.conv_off.append([tuple(int(v) for v in o) for o in off])
            self.conv_g.append(torch.as_tensor(g_all[m_ex], dtype=dtype,
                                               device=device))
            if not np.allclose(g_all[m_ex], g_all[m_ex + half - 1]):
                raise ValueError("the mesh's cells are not the structured "
                                 "mesh's two cell types")
        self.phi_q = sp.phi.to(dtype)                  # (Q, n)
        self.qw_q = sp.quad_w.to(dtype)
        self.area_c = float(sp.area[0])
        ci = (torch.as_tensor(self._held, device=device)[:, None] * L1
              + torch.arange(L1, device=device))
        self.cell_valid = ci < nx                      # (blocks held, L1)

        # -- multigrid: level 0 on the row blocks, the rest whole ----------
        self.mg = bool(cfg.multigrid)
        self._mg1 = self._mg2 = None
        self._mg1_n = self._mg2_n = 0
        if self.mg:
            kw = dict(dtype=dtype, device=device)
            s1, a1 = mgrid.build_mg(
                plan2, sp.patch_cols, sp.patch_mask,
                [[A_blocks[s, d] for d in range(2)] for s in range(2)],
                p.wall_mask, **kw)
            s2, a2 = mgrid.build_mg(plan1, mp.patch_cols, mp.patch_mask,
                                    [[host(p.K1)]], p.p_bc_mask, **kw)
            self._mg1 = self._shard_mg(s1, a1, 2, fine, self.L2, "mg1")
            self._mg2 = self._shard_mg(s2, a2, 1, coarse, L1, "mg2")
            # the level-0 arrays a hierarchy holds on the blocks (0: dense)
            self._mg1_n = len(self._mg1[2]) + bool(self._mg1[2])
            self._mg2_n = len(self._mg2[2]) + bool(self._mg2[2])

    # -- layout ---------------------------------------------------------------

    def _rows(self, t, L, rows):
        """(nI, ...) grid rows -> the held blocks' (blocks held, L, ...),
        pad rows 0 (False)."""
        pad = torch.zeros((rows - t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        full = torch.cat([t, pad]).reshape((-1, L) + tuple(t.shape[1:]))
        return full[self._held].contiguous()

    def _valid(self, L, nI):
        r = (torch.as_tensor(self._held, device=self.device)[:, None] * L
             + torch.arange(L, device=self.device))
        return (r < nI)[:, :, None]

    def _shard_mg(self, static, arrs, w, rows_of, L, name):
        """(static, tail, level-0 planes, level-0 inverse diagonal): level 0
        cut into the row blocks, levels >= 1 and the dense inverse kept
        whole (the tail)."""
        if not static.shapes:                          # dense only
            return static, arrs, [], None
        C = static.ncomp
        pl0 = []
        for s in range(C):
            for d in range(C):
                off = static.offsets[0][s][d]
                if off is None:
                    raise ValueError(f"{name}: a zero level-0 block")
                _check_halo(off, w, name)
                pl0.append(_Planes(off, arrs["planes"][0][s][d].cpu(), w,
                                   rows_of, self.dtype, self.device))
        nI = static.shapes[0][0]
        dinv0 = torch.stack([
            torch.where(self._valid(L, nI), rows_of(arrs["dinv"][0][c]), 1.0)
            for c in range(C)], dim=1)                 # (blocks, C, L, nJ)
        tail = {"planes": [None] + list(arrs["planes"][1:]),
                "dinv": [None] + list(arrs["dinv"][1:]),
                "cinv": arrs["cinv"]}
        return static, tail, pl0, dinv0

    # -- block primitives -----------------------------------------------------

    def _pmv(self, op: _Planes, x):
        """The lattice product of the planes op on x (blocks held, F, L,
        nJ): F fields sharing the operator, each extended by the halo rows
        (ops/lattice.matvec's unfolded window, on the block rows)."""
        n, nf, L, nJ = x.shape
        w = op.w
        xe = self.blocks.extend(x, w)                  # (n, F, L + 2w, nJ)
        k = 2 * w + 1
        cols = F.unfold(xe.reshape(n * nf, 1, L + 2 * w, nJ), (k, k),
                        padding=(0, w))                # (nF, k k, L nJ)
        shifted = cols.index_select(1, op.rows).reshape(
            n, nf, len(op.offsets), L * nJ)
        y = (op.planes.reshape(n, 1, len(op.offsets), L * nJ)
             * shifted).sum(dim=2)
        return y.reshape(n, nf, L, nJ)

    def _mv1(self, op, x):
        """One field (blocks held, L, nJ)."""
        return self._pmv(op, x[:, None])[:, 0]

    def _embed(self, pc):
        """coarse (blocks, L1, nJ1) -> fine (blocks, L2, nJ2) (the coarse
        values at the even rows and columns)."""
        out = pc.new_zeros((pc.shape[0], self.L2, self.nJ2))
        out[:, 0:self.L2:2, 0:self.nJ2:2] = pc
        return out

    def _extract(self, xf):
        return xf[:, 0:self.L2:2, 0:self.nJ2:2]

    def _pdot(self, a, b):
        return self.blocks.sum(
            (a * b).reshape(a.shape[0], -1).sum(dim=1)).reshape(())

    def _blockmv(self, ops, x):
        """The 2 x 2 block operator ops (row-major) on x (blocks, 2, L2,
        nJ2)."""
        return torch.stack([
            self._mv1(ops[0], x[:, 0]) + self._mv1(ops[1], x[:, 1]),
            self._mv1(ops[2], x[:, 0]) + self._mv1(ops[3], x[:, 1])], dim=1)

    def _conv_rhs(self, u):
        """rho (u . grad u) . v on the block's cells: u (blocks, 2, L2,
        nJ2) -> the same shape."""
        n = u.shape[0]
        L1, L2, nJ2, ncy = self.L1, self.L2, self.nJ2, self.nx
        # cells of the last coarse row read two rows past the block
        xe = self.blocks.extend(u, 2)[:, :, 2:]        # (n, 2, L2 + 2, nJ2)
        out = u.new_zeros((n, 2, L2 + 2, nJ2))
        valid = self.cell_valid[:, None]               # (n, 1, L1, 1)
        for offs, g in zip(self.conv_off, self.conv_g):
            uc = torch.stack([xe[:, :, oi:oi + 2 * L1:2, oj:oj + 2 * ncy:2]
                              for oi, oj in offs])     # (A, n, 2, L1, ncy)
            u_q = torch.einsum("qa,ansij->qnsij", self.phi_q, uc)
            gu = torch.einsum("qad,ansij->qdnsij", g, uc)
            conv = u_q[:, :, 0:1] * gu[:, 0] + u_q[:, :, 1:2] * gu[:, 1]
            val = (2.0 * self.area_c) * torch.einsum(
                "q,qa,qnsij->ansij", self.qw_q, self.phi_q, conv)
            val = torch.where(valid[None, ..., None], val, 0.0)
            for a, (oi, oj) in enumerate(offs):
                out[:, :, oi:oi + 2 * L1:2, oj:oj + 2 * ncy:2] += val[a]
        # the two overflow rows go to the next block's first rows
        out[:, :, :2] += self.blocks.from_previous(out[:, :, L2:].contiguous())
        return self.p.cfg.rho * out[:, :, :L2]

    # -- multigrid on the blocks ----------------------------------------------

    def _gather_rows(self, r, nreal):
        """(blocks held, C, L, nJ) -> the whole grid (C, nreal, nJ)."""
        full = self.blocks.gather(r)                   # (n_dev, C, L, nJ)
        C, L, nJ = full.shape[1:]
        return full.transpose(0, 1).reshape(C, -1, nJ)[:, :nreal]

    def _own(self, e, L):
        """(C, nreal, nJ) whole grid -> the held blocks' (blocks, C, L,
        nJ)."""
        C, nreal, nJ = e.shape
        e = F.pad(e, (0, 0, 0, self.n_dev * L - nreal))
        return e.reshape(C, self.n_dev, L, nJ).transpose(0, 1)[self._held]

    def _mg_precond(self, mg, nreal, L):
        """The V(nu, nu) preconditioner r (blocks, C, L, nJ) -> e: level-0
        smoothing on the own rows, the coarse correction whole from the
        gathered residual; or, with no stencil level, the dense solve of
        the gathered residual."""
        static, tail, pl0, dinv0 = mg
        C = static.ncomp
        if not pl0:
            nI, nJ = static.coarse_shape

            def dense(r):
                full = self._gather_rows(r, nreal)
                e = (tail["cinv"] @ full.reshape(-1).to(tail["cinv"].dtype))
                return self._own(e.reshape(C, nI, nJ).to(r.dtype), L)

            return dense

        def blockmv(x):
            return torch.stack([
                sum(self._mv1(pl0[s * C + d], x[:, d]) for d in range(C))
                for s in range(C)], dim=1)

        om = static.omega[0]

        def pre(r):
            x = om * dinv0 * r
            for _ in range(static.nu - 1):
                x = x + om * dinv0 * (r - blockmv(x))
            e = mgrid.coarse_correction(
                static, tail, self._gather_rows(r - blockmv(x), nreal))
            x = x + self._own(e, L)
            for _ in range(static.nu):
                x = x + om * dinv0 * (r - blockmv(x))
            return x

        return pre

    # -- the step -------------------------------------------------------------

    def make_step(self):
        """step(u, p) -> (u_new, p_new): u (blocks held, 2, L2, nJ2), p
        (blocks held, L1, nJ1)."""
        cfg = self.p.cfg
        rho, dt, rtol = cfg.rho, self.p.dt, cfg.krylov_rtol
        ki, kip = cfg.krylov_iters, auto_kip(cfg)
        pdot = self._pdot
        wall, pbc = self.wall[:, None], self.pbc

        def _bicg(op, b, x0, precond):
            if ki is not None:
                return bicgstab_fixed(op, b, x0=x0, precond=precond,
                                      iters=ki, dot=pdot)
            return bicgstab(op, b, x0=x0, precond=precond, rtol=rtol,
                            dot=pdot)

        def _cg(op, b, x0, precond, mass=False, iters=None):
            it = iters if iters is not None else ki
            if it is not None:
                return cg_fixed(op, b, x0=x0, precond=precond,
                                iters=min(8, it) if mass else it, dot=pdot)
            return cg(op, b, x0=x0, precond=precond, rtol=rtol, dot=pdot)

        if self.mg:
            pre1 = self._mg_precond(self._mg1, self.nI2, self.L2)
            m2 = self._mg_precond(self._mg2, self.nI1, self.L1)
            pre2 = lambda r: m2(r[:, None])[:, 0]
        else:
            pre1 = jacobi_preconditioner(
                torch.where(wall, 1.0, self.diag1[:, None]).expand(
                    -1, 2, -1, -1))
            pre2 = jacobi_preconditioner(torch.where(pbc, 1.0, self.diagK))
        preM = jacobi_preconditioner(
            (rho * self.diagM)[:, None].expand(-1, 2, -1, -1))
        g_ext = torch.where(pbc, self.pbcval, 0.0)
        Kg = self._mv1(self.K, g_ext)

        def A1(x):
            y = self._blockmv(self.A, torch.where(wall, 0.0, x))
            return torch.where(wall, x, y)

        def A2(x):
            return torch.where(pbc, x,
                               self._mv1(self.K, torch.where(pbc, 0.0, x)))

        def Mop(x):
            return rho * self._pmv(self.M, x)

        def step(u, pn):
            pe = self._embed(pn)
            # step 1: tentative velocity
            rhs = (self._blockmv(self.R, u) - self._conv_rhs(u)
                   + torch.stack([self._mv1(self.DE[s], pe)
                                  for s in range(2)], dim=1))
            rhs = torch.where(wall, 0.0, rhs)
            u_star = _bicg(A1, rhs, u, pre1).x
            # step 2: pressure Poisson (coarse grid)
            div = sum(self._extract(self._mv1(self.B[s], u_star[:, s]))
                      for s in range(2))
            b2 = self._mv1(self.K, pn) - (rho / dt) * div
            b2 = b2 - Kg
            b2 = torch.where(pbc, self.pbcval, b2)
            p_new = _cg(A2, b2, pn, pre2, iters=kip).x
            # step 3: velocity correction
            dpe = self._embed(p_new - pn)
            b3 = (rho * self._pmv(self.M, u_star)
                  - dt * torch.stack([self._mv1(self.G[s], dpe)
                                      for s in range(2)], dim=1))
            u_new = _cg(Mop, b3, u_star, preM, mass=True).x
            return u_new, p_new

        return step

    def init_state(self):
        n = len(self._held)
        u0 = torch.zeros((n, 2, self.L2, self.nJ2), dtype=self.dtype,
                         device=self.device)
        p0 = torch.zeros((n, self.L1, self.nJ1), dtype=self.dtype,
                         device=self.device)
        return u0, p0

    def solve(self, num_steps=None):
        """March num_steps steps (None: the config's) from rest; (u (2,
        N2), p (N1)) dof vectors."""
        n = num_steps if num_steps is not None else self.p.cfg.num_steps
        step = self.make_step()
        u, pn = self.init_state()
        for _ in range(n):
            u, pn = step(u, pn)
        ug = self.blocks.gather(u).transpose(0, 1).reshape(
            2, -1, self.nJ2)[:, :self.nI2]
        pg = self.blocks.gather(pn).reshape(-1, self.nJ1)[:self.nI1]
        idx2 = self.plan2.index(ug.device)
        u_dof = torch.stack([ug[s].reshape(-1)[idx2] for s in range(2)])
        return u_dof, pg.reshape(-1)[self.plan1.index(pg.device)]
