"""The sharded blocked unstructured solver: the fast unstructured path
(models/blocked_hyperbolic.py, the ELL kernels A-D) over contiguous row
ranges, ported from conservation_fem_tpu/parallel/blocked_sharded.py.

The blocked plan reads a row's neighbours only within a band of H rows
(H = B, the bandwidth after RCM, on the 1D plan; (T + k) nb on the tiled
plan), so cutting the rows into ``n_dev`` contiguous ranges of L = Lb nb
rows (Lb = ceil(blocks / n_dev) of the JAX plan's blocks of nb rows, the
last ranges padded with inert rows) needs one communication primitive: the
band of H rows on each side, ``blocks.extend`` on the rows seen as an
(n, 1, L, 1) grid; plus block-ordered sums for the dots, the RV mean and
``blocks.max`` for max|u - mean u|.

Each block runs the single-device kernels on its own plan, the global plan
cut down (``block_arrays``):

  * rows: the E = L + 2 H rows of its extended range [r0 - H, r0 + L + H),
    of which the middle L are its own; the halo rows keep their patch
    columns that fall in the range and are read by nothing;
  * columns: renumbered into that extended range;
  * cells: every cell with a dof among its own rows, in the global cell
    order (a cell is duplicated into each block that owns one of its dofs,
    as the JAX plan does);
  * contribution orders: each (row, slot) segment lists its contributions
    in the global stable order, so every own row's sum is the single-device
    sum.
So each own row's product (kernel A), assembly (B), cell locals (C) and RV
patch (D) come out as on one device, bit for bit; the twin differs from the
single-device blocked run only in its block-ordered dots, its mean and the
maximum of |u - mean u|.

On ``LocalBlocks`` the blocks' plans are stacked into one plan over n E
rows, so that every operation is one launch of A, B, C or D for all blocks,
as on one device; on ``ProcessGroupBlocks`` each rank holds its own
block's plan. Vectors live in the blocks' own rows, (blocks held, L); an
operation extends its vector operands and cuts the own rows out of its
result. Pad rows (past the mesh) and the phantom slots of a tile-slot mesh
are pinned rows holding 0.
"""

from __future__ import annotations

import numpy as np
import torch

from conservation_fem_tpu_torch.models.linear_advection import mass_solve
from conservation_fem_tpu_torch.ops import blocked
from conservation_fem_tpu_torch.ops import ell_kernels as ek
from conservation_fem_tpu_torch.ops import stabilization as stab
from conservation_fem_tpu_torch.ops.krylov import jacobi_preconditioner
from conservation_fem_tpu_torch.ops.mesh import with_kernel_index
from conservation_fem_tpu_torch.ops.precision import pdot_acc64, psum_acc64
from conservation_fem_tpu_torch.ops.spmv import ell_diag

# the fields a block plan takes row by row, cell by cell, and rebuilds
_ROW_FIELDS = ("points", "dof_coords")
_CELL_FIELDS = ("cell_slots", "area", "grads", "h_cell", "jinv_t",
                "cell_p0", "cell_e1", "cell_e2", "jinv_t_q", "detj_q")
_KERNEL_FIELDS = ("patch_cols32", "patch_cols_bc32", "patch_cols_d16",
                  "cells32", "mat_perm32", "mat_off8", "mat_base32",
                  "mat_tile32", "vec_perm32", "vec_off8", "vec_base32",
                  "vec_tile32")


def _host(t):
    return t.detach().cpu().numpy()


def _targets(perm, segs, n):
    """The sorted order's target of each contribution, by contribution."""
    out = np.empty(n, dtype=np.int64)
    out[perm] = segs
    return out


def block_arrays(arrays, held, L, H):
    """The plans of the blocks ``held`` (global block indices) stacked
    into one MeshArrays / SpaceArrays over len(held) E rows, E = L + 2 H,
    with the kernels' index (ops/mesh.with_kernel_index). arrays: the
    global plan's tensors. Raises ValueError where a cell of a block reaches
    past its extended range (a halo too shallow for the mesh)."""
    cells_f = "cells" if "cells" in arrays._fields else "cell_dofs"
    cols = _host(arrays.patch_cols)
    pmask = _host(arrays.patch_mask)
    diag = _host(arrays.diag_slot)
    bc = _host(arrays.boundary_mask)
    cells = _host(getattr(arrays, cells_f))
    N, K = cols.shape
    M, nd = cells.shape
    E = L + 2 * H
    mat_t = _targets(_host(arrays.mat_perm), _host(arrays.mat_segs),
                     M * nd * nd).reshape(M, nd * nd)
    vec_t = _targets(_host(arrays.vec_perm), _host(arrays.vec_segs),
                     M * nd).reshape(M, nd)
    owner = cells // L                      # each dof's block

    rows, c_ids, c_nodes, m_tgt, v_tgt = [], [], [], [], []
    pc_l, pm_l, dg_l, bc_l = [], [], [], []
    for j, d in enumerate(held):
        w0 = d * L - H                      # global row of extended row 0
        base = j * E
        g = w0 + np.arange(E)
        real = (g >= 0) & (g < N)
        gs = np.where(real, g, 0)
        rows.append(gs)
        c = cols[gs] - w0
        inside = (c >= 0) & (c < E)
        m = pmask[gs] & real[:, None] & inside
        own = np.zeros(E, dtype=bool)
        own[H:H + L] = True
        if (pmask[gs] & (real & own)[:, None] & ~inside).any():
            raise ValueError("a patch reaches past the block's halo")
        self_col = (base + np.arange(E))[:, None]
        pc_l.append(np.where(m, c + base, self_col))
        pm_l.append(m)
        dg_l.append(np.where(real, diag[gs], 0))
        bc_l.append(np.where(real, bc[gs], True))
        ids = np.nonzero((owner == d).any(axis=1))[0]
        e = cells[ids] - w0
        if ids.size and (e.min() < 0 or e.max() >= E):
            raise ValueError("a cell reaches past the block's halo")
        c_ids.append(ids)
        c_nodes.append(e + base)
        mt = mat_t[ids]
        m_tgt.append((mt // K - w0 + base) * K + mt % K)
        v_tgt.append(vec_t[ids] - w0 + base)
    rows = np.concatenate(rows)
    c_ids = np.concatenate(c_ids)
    n_s = len(held) * E
    m_tgt = np.concatenate(m_tgt).reshape(-1)
    v_tgt = np.concatenate(v_tgt).reshape(-1)
    m_perm = np.argsort(m_tgt, kind="stable")
    v_perm = np.argsort(v_tgt, kind="stable")
    dev = arrays.patch_cols.device
    i64 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.int64, device=dev)
    fields = dict(
        patch_cols=i64(np.concatenate(pc_l)),
        patch_mask=torch.as_tensor(np.concatenate(pm_l), device=dev),
        diag_slot=i64(np.concatenate(dg_l)),
        boundary_mask=torch.as_tensor(np.concatenate(bc_l), device=dev),
        mat_perm=i64(m_perm), mat_segs=i64(m_tgt[m_perm]),
        vec_perm=i64(v_perm), vec_segs=i64(v_tgt[v_perm]),
        mat_lens=i64(np.bincount(m_tgt, minlength=n_s * K)),
        vec_lens=i64(np.bincount(v_tgt, minlength=n_s)))
    fields[cells_f] = i64(np.concatenate(c_nodes))
    rows_t, ids_t = i64(rows), i64(c_ids)
    for f in _ROW_FIELDS:
        if f in arrays._fields:
            fields[f] = getattr(arrays, f)[rows_t]
    for f in _CELL_FIELDS:
        if f in arrays._fields:
            fields[f] = getattr(arrays, f)[ids_t]
    for f in _KERNEL_FIELDS:
        if f in arrays._fields:
            fields[f] = None
    return with_kernel_index(arrays._replace(**fields))


class DistributedBlocked:
    """The sharded twin of a BlockedHyperbolicProblem (blocked or
    blocked2d; KPP, Burgers, any flux with a kernel instance): its step
    with rv | si | gfem, bdf1 | bdf2, time-dependent Dirichlet data, patch
    smoothing, the assembled or the matrix-free Newton
    (``blocked_matrix_free``), the adaptive or fixed-iteration solvers
    (Chebyshev, cg_fixed, BiCGStab) and ``precise_reductions``
    (ops/precision.pdot_acc64 and psum_acc64). ``solve()`` returns the
    flat global solution (a tensor on the problem's device), in the
    problem's numbering.

    blocks: LocalBlocks or ProcessGroupBlocks (parallel/comm.py) on the
    problem's device."""

    # the single-device step's use of precise_reductions beyond its dots
    # (the RV mean) and of blocked_matrix_free
    PRECISE_MEAN = True
    MATRIX_FREE = True

    # -- layout ---------------------------------------------------------------

    def _setup_layout(self, problem, blocks, plan, u0):
        """The block-range layout shared with the Pk and advection twins:
        Lb blocks of nb rows a range, H halo rows, the stacked block plan
        and the static row masks."""
        self.p, self.blocks, self.plan = problem, blocks, plan
        self.device, self.dtype = u0.device, u0.dtype
        held_dev = getattr(blocks, "device", None)
        if held_dev is not None and held_dev.type != self.device.type:
            raise ValueError(f"blocks on {held_dev}, problem on "
                             f"{self.device}")
        n_dev = self.n_dev = blocks.n_dev
        nb = plan.nb
        self.n_blocks = -(-plan.n // nb)
        self.Lb = -(-self.n_blocks // n_dev)
        self.blocks_pad = self.Lb * n_dev
        L = self.L = self.Lb * nb
        H = self.H = plan.window_halo
        if n_dev > 1 and L < H:
            raise ValueError(
                f"window halo {H} rows exceeds a device's {L} rows — use "
                "fewer devices or a larger mesh")
        self.E = L + 2 * H
        self.n = plan.n
        self._held = list(blocks.ranks)
        self.bp = blocked.BlockedPlan(
            n=len(self._held) * self.E, B=plan.B,
            mesh=block_arrays(plan.mesh, self._held, L, H), nd=plan.nd,
            nb=nb, halo=plan.halo)
        # global row of each own row (-1: a pad row) and of each extended
        # row (-1: beyond the mesh)
        held = torch.as_tensor(self._held, device=self.device)[:, None]
        g_own = held * L + torch.arange(L, device=self.device)
        self._own_rows = torch.where(g_own < plan.n, g_own, -1)
        g_ext = held * L - H + torch.arange(self.E, device=self.device)
        self._ext_rows = torch.where((g_ext >= 0) & (g_ext < plan.n),
                                     g_ext, -1).reshape(-1)
        valid = self._own_rows >= 0
        if plan.row_valid is not None:
            valid = valid & self.own(plan.row_valid, False)
        self.valid = valid
        self.valid_ext = self.extend(valid.to(self.dtype)) > 0
        self.n_real = float(plan.n if plan.row_valid is None
                            else int(plan.row_valid.sum()))
        self.bc = self.own(plan.mesh.boundary_mask, True)
        self.pin = self.bc | ~self.valid
        self.u0 = torch.where(self.valid, self.own(u0), 0.0)
        # the Dirichlet rows: every real boundary row (the phantom slots of
        # a tile-slot mesh too, which are boundary rows there)
        self._frame = torch.nonzero(
            (self.bc & (self._own_rows >= 0)).reshape(-1))[:, 0]
        self._g = torch.zeros(self.valid.shape, dtype=self.dtype,
                              device=self.device)

    def own(self, x, fill=0.0):
        """(n, ...) global rows -> the held blocks' own rows (blocks held,
        L, ...), ``fill`` on the pad rows."""
        r = self._own_rows
        out = x[r.clamp_min(0)]
        mask = (r >= 0).reshape(r.shape + (1,) * (x.dim() - 1))
        return torch.where(mask, out, fill)

    def ext_rows(self, x):
        """(n, ...) global rows -> the stacked plan's extended rows (blocks
        held * E, ...), 0 beyond the mesh: an operator's or a field's rows
        as the block kernels read them."""
        r = self._ext_rows
        mask = (r >= 0).reshape(r.shape + (1,) * (x.dim() - 1))
        return torch.where(mask, x[r.clamp_min(0)], 0)

    def extend(self, x):
        """(blocks held, L) own rows -> the (blocks held * E,) extended
        rows: each block's with the H rows of its neighbours, 0 beyond the
        first and last block."""
        nh = x.shape[0]
        return self.blocks.extend(x.reshape(nh, 1, self.L, 1),
                                  self.H).reshape(-1)

    def cut(self, y):
        """(blocks held * E, ...) extended rows -> the own rows (blocks
        held, L, ...)."""
        y = y.reshape((-1, self.E) + tuple(y.shape[1:]))
        return y[:, self.H:self.H + self.L]

    def gather(self, x):
        """The held blocks' own rows -> the flat global vector."""
        return self.blocks.gather(x).reshape(-1)[:self.n]

    # -- block-ordered reductions ---------------------------------------------

    def _pdot(self, precise=False):
        if precise:
            return pdot_acc64(self.blocks)
        return lambda a, b: self.blocks.sum(
            (a * b).sum(dim=1)).reshape(())

    def _abs_term(self, u, precise=False):
        """max |u - mean u| over the real rows, a 0-dim tensor; the mean
        f64-accumulated under ``precise``."""
        uv = torch.where(self.valid, u, 0.0)
        if precise:
            # each block's sum_acc64, then psum_acc64 (the JAX order)
            parts = uv.double().sum(dim=1).to(uv.dtype)
            s = psum_acc64(parts, self.blocks)
        else:
            s = self.blocks.sum(uv.sum(dim=1))
        mean = s / self.n_real
        dev = torch.where(self.valid, (u - mean).abs(), 0.0)
        return self.blocks.max(dev.amax(dim=1)).reshape(())

    # -- block operations (own rows in and out) -------------------------------

    def spmv(self, D, x=None, xe=None):
        """D (extended rows) times x (own rows; xe: its extension when the
        caller has it), kernel A."""
        xe = self.extend(x) if xe is None else xe
        return self.cut(blocked.spmv(self.bp, D, xe))

    def constrained(self, D):
        """x -> D x with the pinned rows and columns the identity (kernel A,
        constrained mode: the stacked plan's boundary_mask is the pin)."""
        return lambda x: self.cut(
            blocked.constrained_matvec(self.bp, D, self.extend(x)))

    def diag(self, D):
        return self.cut(ell_diag(self.bp.mesh, D))

    # -- Dirichlet data -------------------------------------------------------

    def _dirichlet_frames(self, times, points):
        """(len(times), boundary rows held): the Dirichlet data at each
        time on the held real boundary rows, from one bc_value call."""
        t = torch.tensor(times, dtype=self.dtype, device=self.device)
        rows = self._own_rows.reshape(-1)[self._frame]
        g = self.p.bc_value(points[rows], t[:, None])
        return torch.broadcast_to(g, (len(times), self._frame.numel()))

    def _dirichlet(self, frame_values):
        self._g.view(-1).index_copy_(0, self._frame, frame_values)
        return self._g

    # -- the problem ----------------------------------------------------------

    def __init__(self, problem, blocks):
        p = problem
        if p.cfg.ell_matvec_backend not in ("blocked", "blocked2d"):
            raise ValueError("DistributedBlocked needs a problem on the "
                             "blocked or blocked2d backend")
        p._force_lazy_operators()
        self._setup_layout(p, blocks, p.plan, p.u0)
        stabz = p.cfg.stabilization
        self.M = self.ext_rows(p.M)
        self.Kbc = self.ext_rows(p.K_bc) if stabz == "si" else None
        self.h_ext = (self.ext_rows(p.h_cg) if stabz in ("rv", "si")
                      else None)
        self.h = self.cut(self.h_ext) if self.h_ext is not None else None

    def _newton_parts(self, ee):
        """(NK, jac_locals): NK(ve) the own rows of N(v) + K_eps v (kernels
        C and B), jac_locals(ve) the CN Jacobian's cell locals (kernel C),
        from v's and eps's extended rows."""
        bp, flux, dt = self.bp, self.p.flux, self.p.dt
        return ((lambda ve: self.cut(blocked.conv_plus_locals_rhs_components(
                    bp, ve, flux, ee))),
                (lambda ve: blocked.newton_locals(bp, ve, ee, 0.5 * dt,
                                                  flux)))

    def _nonlinear_rhs(self, ue):
        return self.cut(blocked.conv_rhs_components(self.bp, ue,
                                                    self.p.flux))

    def _rv_eps(self, u, ue, RH, precise):
        """Kernel D on the block rows, given the global term."""
        cfg = self.p.cfg
        eps = ek.ell_rv_epsilon(
            self.bp.mesh, cfg.Cvel, cfg.CRV, ue, self.extend(RH), ue,
            self.h_ext, self._abs_term(u, precise), self.p.flux,
            self.valid_ext)
        return self.cut(eps)

    def _epsilon(self, u, ue, RH, precise):
        cfg = self.p.cfg
        if cfg.stabilization == "rv":
            eps = self._rv_eps(u, ue, RH, precise and self.PRECISE_MEAN)
        elif cfg.stabilization == "si":
            alpha = self.cut(blocked.si_alpha(self.bp, self.Kbc, ue,
                                              eps_floor=cfg.si_eps))
            beta = self.p.flux.fprime_norm(u)
            eps = stab.sigmoid_activation(alpha) * cfg.Cm * self.h * beta
        else:
            eps = torch.zeros_like(u)
        return torch.where(self.valid, eps, 0.0)

    def _newton_assembled(self, u, ue, ee, g, pdot):
        """F(v) = M (v - u) + dt/2 (NK(v) + NK(u)); the Jacobian assembled
        (kernel B) from the summed locals and applied by kernel A."""
        dt, pin = self.p.dt, self.pin
        NK, jac_locals = self._newton_parts(ee)
        NK_un = NK(ue)

        def residual(v):
            ve = self.extend(v)
            F = self.spmv(self.M, xe=ve - ue) + 0.5 * dt * (NK(ve) + NK_un)
            return torch.where(pin, v - g, F)

        def jacobian(v):
            J = blocked.assemble_matrix(self.bp, jac_locals(self.extend(v)))
            return (self.constrained(J),
                    jacobi_preconditioner(torch.where(pin, 1.0,
                                                      self.diag(J))))

        return self.p._newton_dispatch(residual, jacobian,
                                       torch.where(pin, g, u), dot=pdot)

    def _newton_matrix_free(self, u, ue, ee, g, pdot):
        """The same solve with K_eps and the Jacobian kept as cell locals
        (ops/blocked.local_apply on the block rows)."""
        dt, pin, bp, flux = self.p.dt, self.pin, self.bp, self.p.flux
        L_keps = blocked.eps_locals_components(bp, ee)
        L_cn = blocked.mass_locals_components(bp) + 0.5 * dt * L_keps
        N_un = self._nonlinear_rhs(ue)
        K_mv = lambda ve: self.cut(blocked.local_apply(bp, L_keps, ve))
        Keps_un = K_mv(ue)

        def residual(v):
            ve = self.extend(v)
            F = (self.spmv(self.M, xe=ve - ue)
                 + 0.5 * dt * (self._nonlinear_rhs(ve) + N_un)
                 + 0.5 * dt * (K_mv(ve) + Keps_un))
            return torch.where(pin, v - g, F)

        def jacobian(v):
            L_J = L_cn + 0.5 * dt * blocked.flux_jacobian_locals_components(
                bp, self.extend(v), flux)
            J_mv = lambda x: self.cut(blocked.local_apply(bp, L_J,
                                                          self.extend(x)))
            matvec = lambda x: torch.where(pin, x,
                                           J_mv(torch.where(pin, 0.0, x)))
            diag = torch.where(pin, 1.0,
                               self.cut(blocked.local_diag(bp, L_J)))
            return matvec, jacobi_preconditioner(diag)

        return self.p._newton_dispatch(residual, jacobian,
                                       torch.where(pin, g, u), dot=pdot)

    def _precise(self):
        return bool(self.p.cfg.precise_reductions)

    def make_step(self):
        """step(u, uo, uoo, g) -> (u_new, u, uo) on the held blocks' own
        rows, each (blocks held, L); g: the step's Dirichlet data (zero
        off the boundary rows)."""
        p = self.p
        cfg, dt = p.cfg, p.dt
        valid, pin = self.valid, self.pin
        precise = self._precise()
        pdot = self._pdot(precise)
        matrix_free = self.MATRIX_FREE and cfg.blocked_matrix_free

        def step(u, uo, uoo, g):
            u, uo, uoo = (torch.where(valid, x, 0.0) for x in (u, uo, uoo))
            ue = self.extend(u)
            RH = None
            if cfg.stabilization == "rv":
                if cfg.residual_scheme == "bdf1":
                    du = (u - uo) / dt
                else:
                    du = (3.0 * u - 4.0 * uo + uoo) / (2.0 * dt)
                rhs = torch.where(pin, 0.0, self.spmv(self.M, du)
                                  + self._nonlinear_rhs(ue))
                pre = jacobi_preconditioner(torch.where(pin, 1.0,
                                                        self.diag(self.M)))
                RH = mass_solve(cfg, self.constrained(self.M), rhs, pre,
                                dot=pdot)
            eps = self._epsilon(u, ue, RH, precise)
            ee = self.extend(eps)
            solve = (self._newton_matrix_free if matrix_free
                     else self._newton_assembled)
            uh = solve(u, ue, ee, g, pdot).u
            if cfg.smooth_l > 0:
                uh = self.cut(blocked.smooth_vector(
                    self.bp, self.extend(uh), cfg.smooth_l))
                uh = torch.where(valid, uh, 0.0)
            return uh, u, uo

        return step

    def solve(self, num_steps=None):
        """Run the time loop from u0 (its first num_steps steps; None: all
        of them); the flat global solution."""
        step = self.make_step()
        times = self.p.step_times(0)[:num_steps]
        frames = self._dirichlet_frames(times, self.p.points)
        carry = (self.u0,) * 3
        for k in range(len(times)):
            carry = step(*carry, self._dirichlet(frames[k]))
        return self.gather(carry[0])
