"""ELL sparse matrix-vector products, ported from
conservation_fem_tpu/ops/spmv.py.

An ELL matrix is an (N,K) tensor of values aligned with
``MeshArrays.patch_cols`` (padding entries zero): a product is one (N,K)
gather and a row sum. On the card these are plain PyTorch gathers (the
gather backend); the banded and blocked backends take the hand-written
ELL SpMV kernel instead (ops/ell_kernels.ell_spmv), whose plain version
is ``ell_matvec``.
"""

from __future__ import annotations

import torch

from conservation_fem_tpu_torch.ops.mesh import MeshArrays


def ell_matvec(mesh: MeshArrays, A, x):
    """y = A @ x for A in (N,K) ELL layout. An f32 product on the CPU sums
    each row in slot order 0, 1, ..., K-1, as the JAX package's XLA row
    sum does (torch's f32 row sum takes another order): the host
    projections that set a time step (``get_nodal_h_ell``, dt = CFL min h)
    then give the JAX package's f32 values and step counts. Elsewhere the
    row sum is one reduction (in f64 on the CPU the same values at K = 7;
    on the card its own order)."""
    P = A * x[mesh.patch_cols]
    if P.device.type != "cpu" or P.dtype != torch.float32:
        return P.sum(dim=1)
    y = P[:, 0]
    for k in range(1, P.shape[1]):
        y = y + P[:, k]
    return y


def ell_diag(mesh: MeshArrays, A):
    """The diagonal of an ELL matrix."""
    return A.gather(1, mesh.diag_slot[:, None])[:, 0]


def ell_transpose_matvec(mesh: MeshArrays, A, x):
    """y = A.T @ x by a scatter-add over the same structure (index_add_:
    sequential on the CPU, atomic on the card)."""
    out = torch.zeros_like(x)
    return out.index_add_(0, mesh.patch_cols.reshape(-1),
                          (A * x[:, None]).reshape(-1))


def ell_add(*ops):
    """Sum of ELL matrices sharing one structure."""
    out = ops[0]
    for a in ops[1:]:
        out = out + a
    return out
