"""What a decomposition asks of the blocks' owner: two reductions, a
gather, the deep-halo extension and the reverse shipment. The JAX package
has these built in (``psum``, ``pmax``, ``ppermute`` / ``all_gather``
inside ``shard_map``); here they are one small interface with two
implementations.

A decomposition splits its rows into ``n_dev`` blocks of ``L`` rows, block
d holding global rows [d L, (d + 1) L) (a structured grid's rows, or an
unstructured mesh's nodes, parallel/partition.py). An implementation
holds the blocks ``ranks`` (global block indices, in order) as tensors
whose leading axis runs over them:

    sum(parts)               parts: (len(ranks), ...) per-block partials
                             of any trailing shape -> (1, ...), their sum
                             over ALL blocks, left on the device (nothing
                             here reads a value on the host): a dot's
                             per-block sums, or each block's partial
                             nodal vector or (N, K) ELL matrix
                             (parallel/sharded.py);
    max(parts)               parts: (len(ranks),) per-block maxima -> (1,)
                             tensor, the maximum over ALL blocks;
    extend(x, D, fill)       x: (len(ranks), F, L, C) owned rows of F
                             fields -> (len(ranks), F, L + 2 D, C): each
                             block with the D rows above and below it,
                             ``fill`` beyond the first and last block;
    from_previous(x, fill)   x: (len(ranks), ...) -> the same shape: each
                             block receives the previous block's x, the
                             first block ``fill`` (the JAX package's
                             ``ppermute`` to d + 1: the boundary rows a
                             block's cells add into the next block, which
                             adds them to its own first row);
    gather(x)                x: (len(ranks), ...) of any trailing shape ->
                             (n_dev, ...) on every owner: all blocks' x in
                             block order (an all-gather; the unstructured
                             halo and reverse exchanges gather each
                             block's published rows with it).

Sums add the blocks' partials in block order in both implementations, so
they agree bit for bit; a maximum does not depend on the order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from conservation_fem_tpu_torch import get_device


def _ordered_sum(parts):
    """parts[0] + parts[1] + ... in that order, as a (1, ...) tensor."""
    acc = parts[0:1]
    for k in range(1, parts.shape[0]):
        acc = acc + parts[k:k + 1]
    return acc


def _padded_blocks(rows, D, fill, block_starts, B):
    """rows: (F, R, C) all rows of the grid -> the (F, B, C) windows that
    start D rows above each of block_starts."""
    padded = F.pad(rows, (0, 0, D, D), value=fill)
    return torch.stack([padded[:, r0:r0 + B] for r0 in block_starts])


class LocalBlocks:
    """All ``n_dev`` blocks on one device: the counterpart of the JAX
    package's virtual devices, and the only form in which one card runs
    more than one block."""

    def __init__(self, n_dev: int, device=None):
        if n_dev < 1:
            raise ValueError(f"n_dev must be positive, not {n_dev}")
        self.n_dev = int(n_dev)
        self.device = get_device(device)
        self.ranks = tuple(range(self.n_dev))

    def sum(self, parts):
        return _ordered_sum(parts)

    def max(self, parts):
        return parts.max().reshape(1)

    def extend(self, x, D, fill=0.0):
        n, nf, L, C = x.shape
        rows = x.permute(1, 0, 2, 3).reshape(nf, n * L, C)
        return _padded_blocks(rows, D, fill, [d * L for d in range(n)],
                              L + 2 * D)

    def from_previous(self, x, fill=0.0):
        return torch.cat([torch.full_like(x[:1], fill), x[:-1]])

    def gather(self, x):
        return x


class ProcessGroupBlocks:
    """One block per rank of a ``torch.distributed`` process group, which
    the caller makes and passes in (``gloo`` for CPU tensors, ``nccl`` for
    CUDA tensors): no backend is chosen here. The halo comes from the two
    neighbours by ``batch_isend_irecv`` when D <= L and from an
    ``all_gather`` of the whole grid when a halo is deeper than a block."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group if group is not None else dist.group.WORLD
        self.n_dev = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ranks = (self.rank,)

    def _all_gather(self, x):
        import torch.distributed as dist

        out = [torch.empty_like(x) for _ in range(self.n_dev)]
        dist.all_gather(out, x.contiguous(), group=self.group)
        return out

    def sum(self, parts):
        # gathered and added in block order, as LocalBlocks adds them: an
        # all_reduce sums in an order of its own
        return _ordered_sum(torch.cat(self._all_gather(parts)))

    def max(self, parts):
        import torch.distributed as dist

        out = parts.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def extend(self, x, D, fill=0.0):
        _, nf, L, C = x.shape
        n, r = self.n_dev, self.rank
        if D > L:
            rows = torch.cat([b[0] for b in self._all_gather(x)], dim=1)
            return _padded_blocks(rows, D, fill, [r * L], L + 2 * D)
        up = torch.full((1, nf, D, C), fill, dtype=x.dtype, device=x.device)
        down = up.clone()
        ops = []
        if r > 0:
            ops += [self._p2p("isend", x[:, :, :D], r - 1),
                    self._p2p("irecv", up, r - 1)]
        if r < n - 1:
            ops += [self._p2p("isend", x[:, :, L - D:], r + 1),
                    self._p2p("irecv", down, r + 1)]
        self._exchange(ops)
        return torch.cat([up, x, down], dim=2)

    def from_previous(self, x, fill=0.0):
        n, r = self.n_dev, self.rank
        out = torch.full_like(x, fill)
        ops = []
        if r < n - 1:
            ops.append(self._p2p("isend", x, r + 1))
        if r > 0:
            ops.append(self._p2p("irecv", out, r - 1))
        self._exchange(ops)
        return out

    def _p2p(self, op, t, k):
        """A send (isend) or receive (irecv) of t with block k's rank."""
        import torch.distributed as dist

        t = t.contiguous() if op == "isend" else t
        return dist.P2POp(getattr(dist, op), t,
                          dist.get_global_rank(self.group, k), self.group)

    @staticmethod
    def _exchange(ops):
        import torch.distributed as dist

        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    def gather(self, x):
        return torch.cat(self._all_gather(x))
