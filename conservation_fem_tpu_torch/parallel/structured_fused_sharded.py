"""Row-sharded structured grid x the whole-step block kernels: the
communication-avoiding decomposition of the structured step (KPP,
Burgers: the problem's flux and its Dirichlet data at each step's t),
ported from
conservation_fem_tpu/parallel/structured_fused_sharded.py.

The grid's rows are split into ``n_dev`` blocks of L rows. Per step:

  * the step's one global reduction, abs_term = max|u - mean u|, is taken
    over all blocks before the launch (skipped for gfem, which never reads
    it) and handed to the kernel as a device tensor;
  * everything else in the step reads neighbours one row away, so each
    block is extended ONCE by D = required_halo() rows of each neighbour
    (u, u_old, u_old_old and g together) and runs the whole step alone, in
    one launch of ops/fused_step.fused_rv_block_step or, for blocks of any
    size, of ops/tiled_step.tiled_rv_step in block mode; what is wrong at
    the halo's outer edge moves in one row per pass, so the owned rows come
    out equal to the whole-grid step's;
  * the owned rows are cut out of the result.

This trades redundant work (2 D halo rows per block) for one exchange per
step instead of one per matvec. It needs the Chebyshev inner solver, which
takes no dot products. Where the JAX class shards over a device mesh, this
one takes the blocks' owner (parallel/comm.py): ``LocalBlocks`` holds all
blocks on one device, ``ProcessGroupBlocks`` one per rank. Nothing in a
step reads a value on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from conservation_fem_tpu_torch.ops.fused_step import (fused_rv_block_step,
                                                       required_halo)
from conservation_fem_tpu_torch.ops.tiled_step import tiled_rv_step

BLOCK_KERNEL_BYTES = 270 * 2**10   # per field; the JAX class's VMEM gate


class ShardedFusedStructured:
    """Row-sharded whole-step solver for a StructuredHyperbolicProblem.

    Needs the fixed-iteration configuration with the Chebyshev inner solver
    (cfg.cg_iters and newton_iters set, inner_solver="cheby", stabilization
    rv or gfem, no smoothing). ``solve()`` returns the flat global vector.

    blocks: LocalBlocks or ProcessGroupBlocks (parallel/comm.py).
    kernel: "block" (fused_rv_block_step), "tiled" (tiled_rv_step in block
    mode) or "auto": the JAX class's rule, "block" while a field of the
    extended block is at most 270 KiB, kept so that both packages launch
    counterpart kernels. tile_rows: the tiled kernel's rows per tile (None:
    its default).
    """

    def __init__(self, problem, blocks, kernel: str = "auto",
                 tile_rows=None):
        p, cfg = problem, problem.cfg
        if (cfg.inner_solver != "cheby" or cfg.cg_iters is None
                or cfg.newton_iters is None
                or cfg.stabilization not in ("rv", "gfem")
                or cfg.smooth_l != 0):
            raise NotImplementedError(
                "ShardedFusedStructured needs the fixed-iteration "
                "configuration (cg_iters, newton_iters) with inner_solver="
                "'cheby' (no dot products: the property that lets a block "
                "run the whole step alone), stabilization rv or gfem, no "
                "smoothing")
        if cfg.precise_reductions:
            raise NotImplementedError(
                "not ported yet: precise_reductions on the sharded path "
                "(f64-accumulated dots across blocks, ROADMAP queue 1 item "
                "15)")
        dev = getattr(blocks, "device", p.device)
        if dev.type != p.device.type:
            raise ValueError(f"blocks on {dev}, problem on {p.device}")
        self.p, self.blocks, self.tile_rows = p, blocks, tile_rows
        self._geometry(kernel)
        n1x, n1y, L, D = self.n1x, self.n1y, self.L, self.D
        rows = L * self.n_dev

        # static per-block data: the operator never moves at run time
        Mc_pad = torch.zeros((7, rows + 2 * D, n1y), dtype=p.dtype,
                             device=p.device)
        Mc_pad[:, D:D + n1x] = p.sd.M_coef
        self.Mc_ext = torch.stack([Mc_pad[:, d * L:d * L + self.B]
                                   for d in blocks.ranks])
        valid = torch.zeros((rows, n1y), dtype=torch.bool, device=p.device)
        valid[:n1x] = True
        self._valid = self._local(valid)
        # the frame nodes of the blocks held here: which of the problem's
        # frame values (dirichlet_frames) each takes, and where it goes in
        # the flat (blocks, L, n1y) g, which is zero elsewhere
        r, c = p._frame // n1y, p._frame % n1y
        d = r // L
        held = torch.full((self.n_dev,), -1, dtype=torch.long,
                          device=p.device)
        held[list(blocks.ranks)] = torch.arange(len(blocks.ranks),
                                                device=p.device)
        k = held[d]
        self._frame_sel = torch.nonzero(k >= 0)[:, 0]
        self._frame_dst = ((k * L + r - d * L) * n1y + c)[self._frame_sel]
        self._g = torch.zeros(self._valid.shape, dtype=p.dtype,
                              device=p.device)
        self._carry = None
        self._start_step = 0

    def _geometry(self, kernel):
        """The decomposition's numbers from the problem and the blocks:
        n_dev blocks of L rows (the last pad_rows of them beyond the grid),
        D halo rows, B = L + 2 D rows per extended block, and the kernel."""
        p, cfg = self.p, self.p.cfg
        self.nx, self.ny = p.sd.nx, p.sd.ny
        self.n1x, self.n1y = self.nx + 1, self.ny + 1
        self.n_dev = self.blocks.n_dev
        self.L = -(-self.n1x // self.n_dev)
        self.pad_rows = self.L * self.n_dev - self.n1x
        self.dtype = p.dtype
        self.D = required_halo(cfg.cg_iters, cfg.newton_iters,
                               cfg.newton_linear_iters)
        self.B = self.L + 2 * self.D
        if kernel == "auto":
            kernel = ("block" if self.B * self.n1y * p.u0.element_size()
                      <= BLOCK_KERNEL_BYTES else "tiled")
        if kernel not in ("block", "tiled"):
            raise ValueError(f"kernel {kernel!r}")
        self.kernel = kernel

    def _local(self, x):
        """(rows, ...) global rows -> (blocks held here, L, ...)."""
        L = self.L
        return torch.stack([x[d * L:(d + 1) * L] for d in self.blocks.ranks])

    def _abs_term(self, u):
        """max|u - mean u| over the grid as a (1,) device tensor: block
        partials, reduced over all blocks."""
        mean = self.blocks.sum(u.sum(dim=(1, 2))) / (self.n1x * self.n1y)
        dev = torch.where(self._valid, (u - mean).abs(), 0.0)
        return self.blocks.max(dev.amax(dim=(1, 2)))

    def make_step(self):
        """step(u, uo, uoo, g_frame) -> (u_new, u, uo) on the blocks held
        here, each (blocks, L, n1y); g_frame: the step's row of
        dirichlet_frames(), the frame values of the blocks held here."""
        p, cfg = self.p, self.p.cfg
        L, D, n1x, n1y = self.L, self.D, self.n1x, self.n1y
        kw = p.fused_step_kwargs()   # nx, ny: the kernels take the block's

        def step(u, uo, uoo, g_frame):
            abs_term = (self._abs_term(u) if cfg.stabilization == "rv"
                        else None)
            g = self._g
            g.view(-1).index_copy_(0, self._frame_dst, g_frame)
            ext = self.blocks.extend(torch.stack([u, uo, uoo, g], dim=1), D)
            owned = []
            for k, d in enumerate(self.blocks.ranks):
                row0 = d * L - D
                if self.kernel == "block":
                    uh = fused_rv_block_step(
                        *ext[k], self.Mc_ext[k], row0, abs_term,
                        n_rows=n1x, n_cols=n1y, **kw)
                else:
                    uh = tiled_rv_step(
                        *ext[k], self.Mc_ext[k], row0_base=row0, n_rows=n1x,
                        abs_term=abs_term, tile_rows=self.tile_rows, **kw)
                # both kernels return zeros on the rows outside the grid, so
                # the padding rows of the last block stay zero and the next
                # step's mean needs no mask
                owned.append(uh[D:D + L])
            return torch.stack(owned), u, uo

        return step

    def set_carry(self, u_n, u_old, u_old_old, start_step=0):
        """Start ``solve`` from the history (u_n, u_old, u_old_old), flat
        global vectors in node order (numpy arrays or tensors) — e.g. a JAX
        state from the middle of a trajectory — instead of (u0, u0, u0).
        start_step: the steps that state has already taken, as in
        HyperbolicProblem.set_carry: ``solve`` runs the remaining ones at
        their own times."""
        if not 0 <= start_step <= self.p.num_steps:
            raise ValueError(f"start_step {start_step} outside [0, "
                             f"{self.p.num_steps}]")
        self._carry = tuple(self._from_global(v)
                            for v in (u_n, u_old, u_old_old))
        self._start_step = int(start_step)

    def _from_global(self, v):
        v = torch.as_tensor(v if isinstance(v, torch.Tensor) else np.array(v),
                            dtype=self.dtype, device=self.p.device)
        full = torch.zeros((self.L * self.n_dev, self.n1y), dtype=self.dtype,
                           device=self.p.device)
        full[:self.n1x] = v.reshape(self.n1x, self.n1y)
        return self._local(full)

    def solve(self):
        """Run the time loop; returns the flat global solution vector."""
        p = self.p
        step = self.make_step()
        carry = self._carry or (self._from_global(p.u0),) * 3
        frames = p.dirichlet_frames(p.step_times(self._start_step))
        for g_frame in frames[:, self._frame_sel]:
            carry = step(*carry, g_frame)
        u = self.blocks.gather(carry[0]).reshape(-1, self.n1y)
        return u[:self.n1x].reshape(-1)


def shard_structured_fused(problem, blocks):
    return ShardedFusedStructured(problem, blocks)
