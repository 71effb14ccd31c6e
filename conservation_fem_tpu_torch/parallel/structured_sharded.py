"""Row-sharded stencil solver with a one-row halo exchange per product,
ported from conservation_fem_tpu/parallel/structured_sharded.py — the
counterpart of the reference's MPI mesh partitioning (DOLFINx ghost nodes
and ``ghostUpdate(ADD, REVERSE)``).

The (n1x, n1y) node grid of the stencil backend (ops/structured.py) is
split into ``n_dev`` blocks of L = ceil(n1x / n_dev) rows; the rows past
the grid (the last block's, when n_dev does not divide n1x) are pinned
Dirichlet rows with valid = 0, so nothing they hold reaches an owned row.
Per step, as in the JAX class:

  * every stencil product and every cell kernel reads its neighbours one
    row away: each block is extended by one row of each neighbour
    (``blocks.extend``, the ghost update) and then does shifted-slice
    multiply-adds on its own rows;
  * the cells of a block's last node row add into the next block's first
    row: those sums are shipped to the next block (``blocks.from_previous``)
    and added there, the ADD/REVERSE ghost pattern;
  * every inner product of the Krylov solves is a sum of per-block dots
    taken in block order (``blocks.sum``), and the RV normalisation takes
    the mean by ``blocks.sum`` and max|u - mean u| by ``blocks.max``;
  * the step is the JAX class's: the BDF residual projection by the
    adaptive ``cg``, RV epsilon, and the CN Newton solve by
    ``newton_solve`` with BiCGStab inner solves, assembled stencil
    Jacobians and the flux's explicit second derivatives
    (``Flux.fprime2_xy``) where the JAX class calls ``jax.jvp``.

Where the JAX class shards over a device mesh inside ``shard_map``, this
one takes the blocks' owner (parallel/comm.py): ``LocalBlocks`` holds all
blocks on one device as the leading axis of every tensor, and
``ProcessGroupBlocks`` one block per rank. The adaptive solvers read one
scalar a Krylov iteration on the host, as the single-device ones do.

The sharded carry checkpoint keeps the JAX class's behaviour, not its
orbax format (orbax imports JAX): ``save_carry`` gathers the global rows
and writes them with the step and t as utils/checkpoint.save_checkpoint's
.npz (the layout ``HyperbolicProblem.solve(resume=True)`` reads), and
``restore_carry`` takes each held block's rows from it and re-pads them,
so a snapshot saved at one block count resumes at another, bit-equal.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from conservation_fem_tpu_torch.ops.krylov import cg, jacobi_preconditioner
from conservation_fem_tpu_torch.ops.newton import newton_solve
from conservation_fem_tpu_torch.ops.structured import (_PLANE, CORNERS,
                                                       OFFSETS, tiny_of)
from conservation_fem_tpu_torch.utils.checkpoint import (checkpoint_file,
                                                         load_checkpoint,
                                                         save_checkpoint)


class RowBlocks:
    """The row decomposition of a structured grid over a blocks owner
    (parallel/comm.py), and what every row-sharded solver does with it:
    the blocks' layout, each step's Dirichlet data, the carry, the time
    loop and the sharded carry checkpoint. A subclass builds its operators
    and ``make_step()``; step(*carry, *data) -> carry, where data is what
    ``_step_data`` yields for the step (here its Dirichlet data g)."""

    # the carry's fields, by their names in a checkpoint
    _carry_names = ("u_n", "u_old", "u_old_old")

    def _layout(self, sd, field):
        """n_dev blocks of L rows (the last pad_rows of them past the
        grid), the masks of the held blocks, and the blocks' device, which
        must be the problem's (``field``: a tensor of it)."""
        self.device, self.dtype = field.device, field.dtype
        dev = getattr(self.blocks, "device", self.device)
        if dev.type != self.device.type:
            raise ValueError(f"blocks on {dev}, problem on {self.device}")
        self.nx, self.ny = sd.nx, sd.ny
        self.n1x, self.n1y = self.nx + 1, self.ny + 1
        self.n_dev = self.blocks.n_dev
        self.L = -(-self.n1x // self.n_dev)
        self.pad_rows = self.L * self.n_dev - self.n1x
        L = self.L
        start = torch.tensor(self.blocks.ranks, device=self.device)[:, None]
        rows = start * L + torch.arange(L, device=self.device)
        self.valid = (rows < self.n1x)[..., None].expand(
            -1, -1, self.n1y).to(self.dtype)
        # quad rows that exist (global row < nx), and the rows of a block
        # extended by one row each side that lie on the grid
        self._qm = (rows < self.nx)[..., None]
        ext = start * L - 1 + torch.arange(L + 2, device=self.device)
        self._valid_ext = ((ext >= 0) & (ext < self.n1x))[..., None]
        self.n_valid = float(self.n1x * self.n1y)
        self._carry = None
        self._start_step = 0
        self._step_fn = None

    def _frames(self):
        """The frame nodes of the blocks held here: which of the problem's
        frame values (dirichlet_frames) each takes, and where it goes in
        the flat (blocks, L, n1y) g, which is zero elsewhere (on the pinned
        rows past the grid too)."""
        p, L, n1y = self.p, self.L, self.n1y
        r, c = p._frame // n1y, p._frame % n1y
        d = r // L
        held = torch.full((self.n_dev,), -1, dtype=torch.long,
                          device=self.device)
        held[list(self.blocks.ranks)] = torch.arange(len(self.blocks.ranks),
                                                     device=self.device)
        k = held[d]
        self._frame_sel = torch.nonzero(k >= 0)[:, 0]
        self._frame_dst = ((k * L + r - d * L) * n1y + c)[self._frame_sel]
        self._g = torch.zeros(self.valid.shape, dtype=self.dtype,
                              device=self.device)

    def _blocks_of(self, x, fill=0.0):
        """(n1x, ...) global rows -> (held blocks, L, ...), the rows past
        the grid filled with ``fill``."""
        pad = x.new_full((self.pad_rows,) + tuple(x.shape[1:]), fill)
        full = torch.cat([x, pad])
        L = self.L
        return torch.stack([full[d * L:(d + 1) * L]
                            for d in self.blocks.ranks])

    def _coef_blocks(self, coef):
        """(7, n1x, n1y) stencil planes -> (held blocks, 7, L, n1y)."""
        return torch.stack([self._blocks_of(c) for c in coef], dim=1)

    def _from_global(self, v):
        """A flat global vector (numpy array or tensor) in the blocks'
        layout."""
        v = torch.as_tensor(v if isinstance(v, torch.Tensor) else np.array(v),
                            dtype=self.dtype, device=self.device)
        return self._blocks_of(v.reshape(self.n1x, self.n1y))

    def _to_global(self, x):
        """The blocks' layout -> the flat global vector (all blocks)."""
        rows = self.blocks.gather(x).reshape(-1, self.n1y)
        return rows[:self.n1x].reshape(-1)

    def _dirichlet(self, g_frame):
        """One step's frame values (a row of dirichlet_frames, the held
        blocks' columns) in the blocks' layout: scattered into the one g
        buffer, zero elsewhere."""
        self._g.view(-1).index_copy_(0, self._frame_dst, g_frame)
        return self._g

    # -- carry, checkpoint and resume -----------------------------------------

    def init_carry(self):
        """The carry at step 0 in the blocks' layout."""
        u0 = self._from_global(self.p.u0)
        return (u0, u0, u0)

    def set_carry(self, *fields, start_step=0):
        """Start ``solve`` from the given carry (for KPP and Burgers u_n,
        u_old, u_old_old), global vectors as the single-device problem
        holds them (numpy arrays or tensors) — e.g. a JAX state from the
        middle of a trajectory — instead of ``init_carry()``. start_step:
        the steps that state has already taken; ``solve`` runs the
        remaining ones at their own times."""
        if len(fields) != len(self._carry_names):
            raise ValueError(f"a carry has {len(self._carry_names)} fields "
                             f"{self._carry_names}, not {len(fields)}")
        if not 0 <= start_step <= self.p.num_steps:
            raise ValueError(f"start_step {start_step} outside [0, "
                             f"{self.p.num_steps}]")
        self._carry = tuple(self._from_global(v) for v in fields)
        self._start_step = int(start_step)

    def _initial(self):
        """(step, carry) a solve starts from."""
        return self._start_step, self._carry or self.init_carry()

    def run_chunk(self, carry, start_step: int, n: int):
        """Advance the carry n steps from step index start_step, at the
        times (k + 1) dt (formed in the problem's dtype as the single-device
        time loop forms them) and their Dirichlet data."""
        if not 0 <= start_step <= start_step + n <= self.p.num_steps:
            raise ValueError(f"steps {start_step} .. {start_step + n} "
                             f"outside [0, {self.p.num_steps}]")
        if self._step_fn is None:
            self._step_fn = self.make_step()
        for data in self._step_data(start_step, n):
            carry = self._step_fn(*carry, *data)
        return carry

    def _step_data(self, start_step, n):
        """What each of the n steps from start_step takes besides the
        carry: its Dirichlet data g, formed for all of them in one
        bc_value call."""
        times = self.p.step_times(start_step)[:n]
        for g_frame in self.p.dirichlet_frames(times)[:, self._frame_sel]:
            yield (self._dirichlet(g_frame),)

    def save_carry(self, path: str, step: int, carry):
        """Write the carry's global rows (gathered from all blocks), the
        step and t to the .npz of ``path``; the owner of block 0 writes.
        Returns the file."""
        arrays = {name: self._to_global(x)
                  for name, x in zip(self._carry_names, carry)}
        if 0 not in self.blocks.ranks:
            return checkpoint_file(path)
        return save_checkpoint(path, step=step, t=step * self.p.dt,
                               **arrays)

    def restore_carry(self, path: str):
        """(step, carry) from a ``save_carry`` snapshot, whatever block
        count saved it: each held block takes its own rows, re-padded for
        this decomposition."""
        ck = load_checkpoint(path)
        return ck.step, tuple(self._from_global(ck.arrays[name])
                              for name in self._carry_names)

    def solve_checkpointed(self, path: str, every: int, resume: bool = False):
        """The time loop in chunks of ``every`` steps with a snapshot after
        each; resume=True restarts from the stored snapshot when it exists
        (saved at any block count). Returns the flat global solution."""
        if every < 1:
            raise ValueError(f"every must be positive, not {every}")
        if resume and os.path.exists(checkpoint_file(path)):
            s, carry = self.restore_carry(path)
        else:
            s, carry = self._initial()
        while s < self.p.num_steps:
            n = min(every, self.p.num_steps - s)
            carry = self.run_chunk(carry, s, n)
            s += n
            self.save_carry(path, s, carry)
        return self._to_global(carry[0])

    def solve(self):
        """Run the time loop; returns the flat global solution."""
        s, carry = self._initial()
        carry = self.run_chunk(carry, s, self.p.num_steps - s)
        return self._to_global(carry[0])


class ShardedStructuredKPP(RowBlocks):
    """Row-sharded RV solver for a StructuredHyperbolicProblem (KPP,
    Burgers: the problem's flux and its Dirichlet data at each step's t).
    ``solve()`` returns the flat global vector, as the single-device
    ``solve().u`` does.

    The step is the JAX class's one algorithm: it reads krylov_rtol,
    newton_rtol, newton_atol, newton_max_it, newton_linear_rtol,
    modified_newton, residual_scheme, Cvel and CRV, and, like the JAX
    class, ignores stabilization (always rv), cg_iters, newton_iters,
    newton_linear_iters, inner_solver, the Chebyshev bounds,
    newton_final_residual, smooth_l, precise_reductions, use_kernels,
    fused_substeps and record_metrics.

    blocks: LocalBlocks or ProcessGroupBlocks (parallel/comm.py), on the
    problem's device.
    """

    def __init__(self, problem, blocks):
        p = problem
        if getattr(p, "sd", None) is None:
            raise ValueError("the sharded stencil solver needs a problem "
                             "on the stencil backend")
        self.p, self.blocks = p, blocks
        self._layout(p.sd, p.u0)
        self.bc2 = self._blocks_of(p.sd.bc2, True)
        self.Mc = self._coef_blocks(p.sd.M_coef)
        self.h2 = self._blocks_of(p.sd.h_cg2)
        self._frames()

    # -- halo primitives ------------------------------------------------------

    def _halo(self, x, fill=0.0):
        """(blocks, L, n1y) -> (blocks, L + 2, n1y) with a row of each
        neighbour; ``fill`` beyond the grid's first and last block."""
        return self.blocks.extend(x[:, None], 1, fill)[:, 0]

    def _apply(self, coef, xe):
        """coef (blocks, 7, L, n1y) times x given by its halo'd xe
        (blocks, [fields,] L + 2, n1y): the fields share the operator."""
        L, n1y = self.L, self.n1y
        xp = F.pad(xe, (1, 1))
        c = (lambda k: coef[:, k, None]) if xe.dim() == 4 else (
            lambda k: coef[:, k])
        out = c(0) * xe[..., 1:1 + L, :]
        for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
            out = out + c(k) * xp[..., 1 + di:1 + di + L, 1 + dj:1 + dj + n1y]
        return out

    def _matvec(self, coef, x, xe=None):
        """coef (blocks, 7, L, n1y), x (blocks, L, n1y) -> (blocks, L,
        n1y); xe: x's halo when the caller has it."""
        return self._apply(coef, self._halo(x) if xe is None else xe)

    def _quad_row_mask(self):
        """(blocks, L, 1): True where the local quad row exists globally
        (< nx)."""
        return self._qm

    def _cell_planes(self, x, xe=None):
        """x (blocks, L, n1y) -> per-corner (blocks, L, ny) planes,
        planes[t][a]."""
        xe = self._halo(x) if xe is None else xe
        L, ny = self.L, self.ny
        return [[xe[:, 1 + di:1 + di + L, dj:dj + ny]
                 for (di, dj) in CORNERS[t]] for t in range(2)]

    def _ship(self, out):
        """(blocks, ..., L + 1, n1y) sums, the last row the next block's
        first -> (blocks, ..., L, n1y) with the previous block's last row
        added into the first."""
        ship = self.blocks.from_previous(out[..., -1:, :])
        out = out[..., :self.L, :]
        out[..., :1, :] += ship
        return out

    def _node_scatter_planes(self, vals):
        """per-corner planes vals[t][a] (blocks, L, ny) -> (blocks, L, n1y)
        nodal sums with boundary-row shipping."""
        L, ny = self.L, self.ny
        qm = self._quad_row_mask()
        out = torch.zeros((len(self.blocks.ranks), L + 1, self.n1y),
                          dtype=vals[0][0].dtype, device=self.device)
        for t in range(2):
            for a, (di, dj) in enumerate(CORNERS[t]):
                out[:, di:di + L, dj:dj + ny] += torch.where(qm, vals[t][a],
                                                             0.0)
        return self._ship(out)

    def _local_to_stencil_planes(self, loc):
        """local-matrix planes loc[t][a][b] (blocks, L, ny) -> (blocks, 7,
        L, n1y) stencil planes with row shipping."""
        L, ny = self.L, self.ny
        qm = self._quad_row_mask()
        coef = torch.zeros((len(self.blocks.ranks), len(OFFSETS), L + 1,
                            self.n1y), dtype=loc[0][0][0].dtype,
                           device=self.device)
        for t in range(2):
            cs = CORNERS[t]
            for a in range(3):
                dai, daj = cs[a]
                for b in range(3):
                    pidx = _PLANE[(cs[b][0] - dai, cs[b][1] - daj)]
                    coef[:, pidx, dai:dai + L, daj:daj + ny] += torch.where(
                        qm, loc[t][a][b], 0.0)
        return self._ship(coef)

    # -- FEM pieces -----------------------------------------------------------

    def _pdot(self, a, b):
        """The inner product over all blocks: per-block sums, added in
        block order."""
        return self.blocks.sum((a * b).sum(dim=(1, 2))).reshape(())

    def _nonlinear_rhs(self, x, xe=None):
        """N(x), componentwise plane-form quadrature (ops/structured
        nonlinear_rhs)."""
        sd = self.p.sd
        fx, fy = self.p.flux.fprime_xy
        c = self._cell_planes(x, xe)
        two_area = 2.0 * sd.area
        vals = [[None] * 3 for _ in range(2)]
        for t in range(2):
            gux = sum(sd.grads[t, a, 0] * c[t][a] for a in range(3))
            guy = sum(sd.grads[t, a, 1] * c[t][a] for a in range(3))
            for q in range(sd.qw.shape[0]):
                uq = sum(sd.phi[q, a] * c[t][a] for a in range(3))
                conv = fx(uq) * gux + fy(uq) * guy
                for a in range(3):
                    w = two_area * sd.qw[q] * sd.phi[q, a]
                    vals[t][a] = (conv * w if vals[t][a] is None
                                  else vals[t][a] + conv * w)
        return self._node_scatter_planes(vals)

    def _keps(self, eps):
        """The eps-weighted stiffness planes (eps P1: the exact mean
        rule)."""
        sd = self.p.sd
        c = self._cell_planes(eps)
        loc = [[[None] * 3 for _ in range(3)] for _ in range(2)]
        for t in range(2):
            ae = sd.area / 3.0 * (c[t][0] + c[t][1] + c[t][2])
            for a in range(3):
                for b in range(3):
                    gg = (sd.grads[t, a, 0] * sd.grads[t, b, 0]
                          + sd.grads[t, a, 1] * sd.grads[t, b, 1])
                    loc[t][a][b] = gg * ae
        return self._local_to_stencil_planes(loc)

    def _flux_jac(self, x):
        """The planes of dN/du at x, with f' and f'' from the flux's
        explicit derivatives."""
        sd = self.p.sd
        fx, fy = self.p.flux.fprime_xy
        dfx, dfy = self.p.flux.fprime2_xy
        c = self._cell_planes(x)
        two_area = 2.0 * sd.area
        loc = [[[None] * 3 for _ in range(3)] for _ in range(2)]
        for t in range(2):
            gux = sum(sd.grads[t, a, 0] * c[t][a] for a in range(3))
            guy = sum(sd.grads[t, a, 1] * c[t][a] for a in range(3))
            for q in range(sd.qw.shape[0]):
                uq = sum(sd.phi[q, a] * c[t][a] for a in range(3))
                fpx, fpy = fx(uq), fy(uq)
                t1 = dfx(uq) * gux + dfy(uq) * guy
                gb = [fpx * sd.grads[t, b, 0] + fpy * sd.grads[t, b, 1]
                      for b in range(3)]
                for a in range(3):
                    wqa = sd.qw[q] * sd.phi[q, a]
                    for b in range(3):
                        contrib = (two_area * wqa) * (t1 * sd.phi[q, b]
                                                      + gb[b])
                        loc[t][a][b] = (contrib if loc[t][a][b] is None
                                        else loc[t][a][b] + contrib)
        return self._local_to_stencil_planes(loc)

    def _patch_reduce(self, x, reducer, pad_val, valid, xe=None):
        """Reduce over each node's 7-neighbour patch, the nodes off the
        grid (valid = 0, and the fill beyond it) taking ``pad_val``; xe:
        x's halo when the caller has it (its fill is replaced here)."""
        L, n1y = self.L, self.n1y
        xe = self._halo(x) if xe is None else xe
        xe = F.pad(torch.where(self._valid_ext, xe, pad_val), (1, 1),
                   value=pad_val)
        acc = torch.where(valid > 0, x, pad_val)
        for (di, dj) in OFFSETS[1:]:
            acc = reducer(acc, xe[:, 1 + di:1 + di + L, 1 + dj:1 + dj + n1y])
        return acc

    def _rv_normalisation(self, x):
        """max|x - mean x| over the grid as a (1,) tensor: the mean by
        blocks.sum, the maximum by blocks.max."""
        valid = self.valid
        mean = self.blocks.sum((x * valid).sum(dim=(1, 2))) / self.n_valid
        dev = torch.where(valid > 0, (x - mean).abs(), 0.0)
        return self.blocks.max(dev.amax(dim=(1, 2)))

    def _rv_eps(self, x, xe, Rh, beta_e):
        """RV epsilon from the normalisation field x (its halo xe), the
        residual Rh and the halo'd wavespeed beta_e; 0 off the grid."""
        cfg, valid, h2 = self.p.cfg, self.valid, self.h2
        abs_term = self._rv_normalisation(x)
        x_max = self._patch_reduce(x, torch.maximum, -np.inf, valid, xe)
        x_min = self._patch_reduce(x, torch.minimum, np.inf, valid, xe)
        n_i = ((x_max - x_min) - abs_term).abs()
        Rh_i = self._patch_reduce(Rh.abs(), torch.maximum, -np.inf, valid)
        beta = self._patch_reduce(beta_e[:, 1:-1], torch.maximum, -np.inf,
                                  valid, beta_e)
        eps = torch.minimum(
            cfg.Cvel * h2 * beta,
            cfg.CRV * h2 ** 2 * (Rh_i / n_i.clamp_min(tiny_of(x.dtype))).abs())
        return torch.where(valid > 0, eps, 0.0)

    # -- step -----------------------------------------------------------------

    def _constrained(self, coef):
        """x -> the product with the Dirichlet rows and columns replaced by
        the identity."""
        bc2 = self.bc2

        def mv(x):
            return torch.where(bc2, x,
                               self._matvec(coef, torch.where(bc2, 0.0, x)))
        return mv

    def make_step(self):
        """step(u, uo, uoo, g) -> (u_new, u, uo) on the blocks held here,
        each (blocks, L, n1y); g: the step's Dirichlet data in that layout
        (``_dirichlet``)."""
        p, cfg = self.p, self.p.cfg
        dt, bc2, Mc = p.dt, self.bc2, self.Mc
        pdot = self._pdot

        def step(u, uo, uoo, g):
            ue = self._halo(u)
            # residual projection
            if cfg.residual_scheme == "bdf1":
                du = (u - uo) / dt
            else:
                du = (3.0 * u - 4.0 * uo + uoo) / (2.0 * dt)
            N_un = self._nonlinear_rhs(u, ue)
            rhs = torch.where(bc2, 0.0, self._matvec(Mc, du) + N_un)
            diagM = torch.where(bc2, 1.0, Mc[:, 0])
            RH = cg(self._constrained(Mc), rhs,
                    precond=jacobi_preconditioner(diagM),
                    rtol=cfg.krylov_rtol, dot=pdot).x
            eps = self._rv_eps(u, ue, RH, p.flux.fprime_norm(ue))
            # Newton CN
            Kc = self._keps(eps)
            Kc_un = self._matvec(Kc, u, ue)
            base = Mc + 0.5 * dt * Kc

            def residual(v):
                ve = self._halo(v)
                F_ = (self._matvec(Mc, v - u, ve - ue)
                      + 0.5 * dt * (self._nonlinear_rhs(v, ve) + N_un)
                      + 0.5 * dt * (self._matvec(Kc, v, ve) + Kc_un))
                return torch.where(bc2, v - g, F_)

            def jacobian(v):
                J = base + 0.5 * dt * self._flux_jac(v)
                pre = jacobi_preconditioner(torch.where(bc2, 1.0, J[:, 0]))
                return self._constrained(J), pre

            res = newton_solve(
                residual, torch.where(bc2, g, u), rtol=cfg.newton_rtol,
                atol=cfg.newton_atol, max_it=cfg.newton_max_it,
                linear_rtol=cfg.newton_linear_rtol or cfg.krylov_rtol,
                jacobian_fn=jacobian, freeze_jacobian=cfg.modified_newton,
                dot=pdot)
            return res.u, u, uo

        return step


def shard_structured(problem, blocks):
    return ShardedStructuredKPP(problem, blocks)
