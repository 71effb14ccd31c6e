"""Owner-cell decomposition of the ELL step, ported from
conservation_fem_tpu/parallel/sharded.py (the JAX package's v1 multi-chip
path: the counterpart of the reference's MPI decomposition with
``ghostUpdate(ADD, REVERSE)``, ref linear_advection.py:40-42,165).

  * Nodal vectors, ELL operators and the solvers stay whole on every
    owner (replicated nodes);
  * the two cell-heavy kernels of the step, the nonlinear flux residual
    and the eps-weighted stiffness assembly, run over contiguous cell
    blocks: each block assembles its cells' partial, a full nodal vector
    or (N, K) ELL matrix, in the deterministic sorted order of
    ops/assembly.py restricted to its cells, and the partials are added by
    ``blocks.sum`` in block order (the JAX package's ``psum``).

The cells are padded with zero-area cells (node 0) to a multiple of the
block count; they add exact zeros. ``shard_problem`` turns a built
HyperbolicProblem on the ELL backend into a ShardedHyperbolicProblem in
place (its ``__class__``, as the JAX function does), so that
``problem.step`` and ``problem.solve()`` run the sharded kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.models.scalar_hyperbolic import (
    HyperbolicProblem)
from conservation_fem_tpu_torch.parallel.unstructured_sharded import (
    segment_order)


def _pad_cell_arrays(host_mesh, n_dev: int):
    """(cells, area, grads, cell_slots) padded with zero-area cells at
    node 0 so that the cell count divides n_dev (host numpy)."""
    cells = host_mesh.cells.astype(np.int64)
    area, grads = host_mesh.area, host_mesh.grads
    slots = host_mesh.cell_slots
    pad = (-cells.shape[0]) % n_dev
    if pad:
        cells = np.concatenate([cells, np.zeros((pad, 3), cells.dtype)])
        area = np.concatenate([area, np.zeros(pad, area.dtype)])
        grads = np.concatenate([grads, np.zeros((pad, 3, 2), grads.dtype)])
        slots = np.concatenate([slots, np.zeros((pad, 3, 3), slots.dtype)])
    return cells, area, grads, slots


def _check_device(problem, blocks):
    dev = getattr(blocks, "device", problem.device)
    if dev.type != problem.device.type:
        raise ValueError(f"blocks on {dev}, problem on {problem.device}")


def _block_order(targets, n_segments):
    """segment_order of the held blocks' targets (blocks, m), each block's
    n_segments segments its own."""
    nb = targets.shape[0]
    return segment_order(targets + (np.arange(nb) * n_segments)[:, None],
                         nb * n_segments)


class ShardedHyperbolicProblem(HyperbolicProblem):
    """A HyperbolicProblem whose nonlinear residual and eps-stiffness run
    cell-partitioned over the blocks of ``blocks`` (parallel/comm.py).
    Construct with ``shard_problem``."""

    def init_sharding(self, blocks):
        _check_device(self, blocks)
        self.blocks = blocks
        n_dev = blocks.n_dev
        cells, area, grads, slots = _pad_cell_arrays(self.host_mesh, n_dev)
        mb = cells.shape[0] // n_dev
        held = list(blocks.ranks)
        blk = lambda a: np.ascontiguousarray(
            a.reshape((n_dev, mb) + a.shape[1:])[held])
        n, K = self.host_mesh.n_nodes, self.host_mesh.max_patch
        self._n_K = (n, K)
        cells_b = blk(cells)
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt,
                                               device=self.device)
        self._s_cells = t(cells_b.reshape(-1, 3))
        self._s_area = t(blk(area).reshape(-1), self.dtype)
        self._s_grads = t(blk(grads).reshape(-1, 3, 2), self.dtype)
        nb = len(held)
        order, lens = _block_order(cells_b.reshape(nb, -1), n)
        self._s_vec = (t(order), t(lens))
        rows = np.repeat(cells_b, 3, axis=2).reshape(nb, mb, 3, 3)
        order, lens = _block_order(
            (rows * K + blk(slots)).reshape(nb, -1), n * K)
        self._s_mat = (t(order), t(lens))
        return self

    def _block_sum(self, cell_vals, order_lens, shape):
        """Each block's partial of the cell values (sorted segmented sums
        over its cells), added over all blocks in block order."""
        order, lens = order_lens
        parts = torch.segment_reduce(cell_vals.reshape(-1)[order], "sum",
                                     lengths=lens, unsafe=True)
        nb = len(self.blocks.ranks)
        return self.blocks.sum(parts.reshape((nb,) + shape)).reshape(shape)

    # overrides ------------------------------------------------------------

    def _nonlinear_rhs(self, u):
        r = assembly.local_convection_rhs(
            self._s_area, self._s_grads, u[self._s_cells], self.flux)
        return self._block_sum(r, self._s_vec, (self._n_K[0],))

    def _assemble_keps(self, eps):
        vals = assembly.local_eps_stiffness(self._s_area, self._s_grads,
                                            eps[self._s_cells])
        return self._block_sum(vals, self._s_mat, self._n_K)


def shard_problem(problem: HyperbolicProblem, blocks):
    """Turn a built HyperbolicProblem on the ELL backend (gather, lattice
    or banded) into a ShardedHyperbolicProblem over ``blocks``, in
    place; returns it."""
    if type(problem) is not HyperbolicProblem:
        raise ValueError(
            f"shard_problem takes a HyperbolicProblem on the ELL backend, "
            f"not a {type(problem).__name__}")
    _check_device(problem, blocks)
    problem.__class__ = ShardedHyperbolicProblem
    return problem.init_sharding(blocks)
