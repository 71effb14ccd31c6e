"""Stencil SpMV and fused adaptive PCG: Hopper kernels (csrc/stencil.cu)
with their plain PyTorch versions.

Port of conservation_fem_tpu/ops/pallas_stencil.py. Each wrapper runs
the plain version for CPU tensors and launches the CUDA kernel for CUDA
tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops.structured import OFFSETS, _shifted


def stencil_matvec_plain(coef, x):
    """y = A x for a (7, n1x, n1y) stencil operator, zero outside the grid."""
    n1x, n1y = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    acc = torch.zeros_like(x)
    for k, (di, dj) in enumerate(OFFSETS):
        acc = acc + coef[k] * _shifted(xp, di, dj, n1x, n1y)
    return acc


def stencil_matvec(coef, x):
    """y = A x; replaces pallas_stencil.stencil_matvec."""
    if _build.on_cpu("stencil_matvec", coef, x):
        return stencil_matvec_plain(coef, x)
    n1x, n1y = x.shape
    dtype = _build.check_cuda_args("stencil_matvec", coef, x,
                                   shapes=[(7, n1x, n1y), (n1x, n1y)])
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = _build.entry("cft_stencil_matvec", dtype)(
            coef.data_ptr(), x.data_ptr(), y.data_ptr(), n1x, n1y,
            _build.stream_ptr(x))
    _build.launches["stencil_matvec"] += 1
    _build.check(code, "stencil_matvec")
    return y


def cg_solve_plain(coef, b, bc_mask, diag, rtol=1e-5, maxiter=200):
    """Constrained Jacobi-PCG: solve A x = b with Dirichlet rows pinned
    (x[bc] = b[bc]); stops when sum(r^2) <= rtol^2 sum(b^2) or after
    maxiter iterations (the stopping test reads one scalar per iteration)."""
    dinv = 1.0 / torch.where(bc_mask, 1.0, diag)

    def matvec(v):
        acc = stencil_matvec_plain(coef, torch.where(bc_mask, 0.0, v))
        return torch.where(bc_mask, v, acc)

    x = torch.where(bc_mask, b, 0.0)
    r = b - matvec(x)
    z = dinv * r
    p = z
    rz = torch.sum(r * z)
    tol2 = rtol * rtol * torch.sum(b * b)
    k = 0
    while bool(torch.sum(r * r) > tol2) and k < maxiter:
        Ap = matvec(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_n = torch.sum(r * z)
        p = z + (rz_n / rz) * p
        rz = rz_n
        k += 1
    return x


def cg_solve(coef, b, bc_mask, diag, rtol=1e-5, maxiter=200):
    """Fused constrained CG; replaces pallas_stencil.cg_solve. On the card
    the whole solve, its convergence test included, is one launch."""
    if _build.on_cpu("cg_solve", coef, b, bc_mask, diag):
        return cg_solve_plain(coef, b, bc_mask, diag, rtol, maxiter)
    n1x, n1y = b.shape
    if bc_mask.dtype != torch.bool:
        raise TypeError("cg_solve: bc_mask must be bool")
    dtype = _build.check_cuda_args(
        "cg_solve", coef, b, bc_mask, diag,
        shapes=[(7, n1x, n1y), (n1x, n1y), (n1x, n1y), (n1x, n1y)])
    x = torch.empty_like(b)
    work = torch.empty((3, n1x, n1y), dtype=dtype, device=b.device)
    part = torch.empty(_build.PART_SIZE, dtype=dtype, device=b.device)
    with torch.cuda.device(b.device):
        code = _build.entry("cft_cg_solve", dtype)(
            coef.data_ptr(), b.data_ptr(), bc_mask.data_ptr(),
            diag.data_ptr(), x.data_ptr(), work.data_ptr(), part.data_ptr(),
            n1x, n1y, float(rtol), int(maxiter), _build.stream_ptr(b))
    _build.launches["cg_solve"] += 1
    _build.check(code, "cg_solve")
    return x
