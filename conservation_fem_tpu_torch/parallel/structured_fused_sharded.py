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

import torch

from conservation_fem_tpu_torch.ops.fused_step import (fused_rv_block_step,
                                                       required_halo)
from conservation_fem_tpu_torch.ops.tiled_step import (bf16_planes_of,
                                                       tiled_rv_step)
from conservation_fem_tpu_torch.parallel.structured_sharded import RowBlocks

BLOCK_KERNEL_BYTES = 270 * 2**10   # per field; the JAX class's VMEM gate


class ShardedFusedStructured(RowBlocks):
    """Row-sharded whole-step solver for a StructuredHyperbolicProblem.

    Needs the fixed-iteration configuration with the Chebyshev inner solver
    (cfg.cg_iters and newton_iters set, inner_solver="cheby", stabilization
    rv or gfem, no smoothing). ``solve()`` returns the flat global vector.

    blocks: LocalBlocks or ProcessGroupBlocks (parallel/comm.py).
    kernel: "block" (fused_rv_block_step), "tiled" (tiled_rv_step in block
    mode) or "auto": the JAX class's rule, "block" while a field of the
    extended block is at most 270 KiB, kept so that both packages launch
    counterpart kernels. tile_rows: the tiled kernel's rows per tile (None:
    its default). cfg.tiled_bf16_planes reaches the tiled kernel (its bf16
    solver planes at f32), as in JAX; the block kernel ignores it.
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
        # precise_reductions is read nowhere, as in the JAX class: the
        # step takes no dot product, and its mean is blocks.sum's
        self.p, self.blocks, self.tile_rows = p, blocks, tile_rows
        self._geometry(kernel)
        n1x, n1y, L, D = self.n1x, self.n1y, self.L, self.D

        # static per-block data: the operator never moves at run time
        Mc_pad = torch.zeros((7, L * self.n_dev + 2 * D, n1y),
                             dtype=p.dtype, device=p.device)
        Mc_pad[:, D:D + n1x] = p.sd.M_coef
        self.Mc_ext = torch.stack([Mc_pad[:, d * L:d * L + self.B]
                                   for d in blocks.ranks])
        self._frames()

    def _geometry(self, kernel):
        """The decomposition's numbers from the problem and the blocks:
        RowBlocks' layout (n_dev blocks of L rows, the last pad_rows of
        them beyond the grid), D halo rows, B = L + 2 D rows per extended
        block, and the kernel."""
        p, cfg = self.p, self.p.cfg
        self._layout(p.sd, p.u0)
        self.D = required_halo(cfg.cg_iters, cfg.newton_iters,
                               cfg.newton_linear_iters)
        self.B = self.L + 2 * self.D
        if kernel == "auto":
            kernel = ("block" if self.B * self.n1y * p.u0.element_size()
                      <= BLOCK_KERNEL_BYTES else "tiled")
        if kernel not in ("block", "tiled"):
            raise ValueError(f"kernel {kernel!r}")
        self.kernel = kernel

    def _abs_term(self, u):
        """max|u - mean u| over the grid as a (1,) device tensor: block
        partials, reduced over all blocks."""
        mean = self.blocks.sum(u.sum(dim=(1, 2))) / (self.n1x * self.n1y)
        dev = torch.where(self.valid > 0, (u - mean).abs(), 0.0)
        return self.blocks.max(dev.amax(dim=(1, 2)))

    def make_step(self):
        """step(u, uo, uoo, g) -> (u_new, u, uo) on the blocks held here,
        each (blocks, L, n1y); g: the step's Dirichlet data in that layout
        (RowBlocks._dirichlet)."""
        p, cfg = self.p, self.p.cfg
        L, D, n1x, n1y = self.L, self.D, self.n1x, self.n1y
        kw = p.fused_step_kwargs()   # nx, ny: the kernels take the block's
        # the bf16 instance's mass planes, made once per block
        mc16 = [None] * len(self.blocks.ranks)
        if (self.kernel == "tiled" and cfg.tiled_bf16_planes
                and self.Mc_ext.is_cuda
                and self.Mc_ext.dtype == torch.float32):
            mc16 = [bf16_planes_of(m.contiguous()) for m in self.Mc_ext]

        def step(u, uo, uoo, g):
            abs_term = (self._abs_term(u) if cfg.stabilization == "rv"
                        else None)
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
                        abs_term=abs_term, tile_rows=self.tile_rows,
                        bf16_planes=cfg.tiled_bf16_planes, mc16=mc16[k],
                        **kw)
                # both kernels return zeros on the rows outside the grid, so
                # the padding rows of the last block stay zero and the next
                # step's mean needs no mask
                owned.append(uh[D:D + L])
            return torch.stack(owned), u, uo

        return step


def shard_structured_fused(problem, blocks):
    return ShardedFusedStructured(problem, blocks)
