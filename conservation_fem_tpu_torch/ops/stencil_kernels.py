"""Stencil SpMV and fused adaptive PCG: Hopper kernels (csrc/stencil.cu)
with their plain PyTorch versions.

Port of conservation_fem_tpu/ops/pallas_stencil.py. Each wrapper runs
the plain version for CPU tensors and launches the CUDA kernel for CUDA
tensors; there is no fallback from one to the other. ``cg_plan`` is the
plan of the ``cg_solve`` kernel (csrc/stencil.cu mirrors its shared-memory
layout): which instance, how many CTAs, their bands and their shared
memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops.fused_step import SMEM_OPTIN, band_start
from conservation_fem_tpu_torch.ops.structured import OFFSETS, _shifted

# CTAs of the largest cluster (csrc/stencil.cu kMaxCluster)
CG_MAX_CLUSTER = 16
CG_STATIC_SMEM = 1024  # kept for cg_solve's static shared memory (BandShared)
# nodes a band of cg_solve holds at least where the grid has that many: a
# small grid runs fewer CTAs
CG_MIN_NODES = 128
CG_INSTANCES = ("cluster", "grid")
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


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


def cg_smem(cap, n1y, itemsize, resident, cluster):
    """Dynamic shared memory in bytes of a CTA of cg_solve whose band holds
    at most ``cap`` nodes (csrc/stencil.cu CgLayout): resident, 12 arrays
    of the band (7 planes, dinv, x, Ap, two p buffers) and, in the cluster
    instance, r, and the matvec's operand at the band and its halo (n1y + 1
    nodes on either side); the halo's dinv; in the cluster instance two
    buffers of every CTA's reduction partials (CG_MAX_CLUSTER x MAX_RED);
    then the band's mask (resident) and the halo's, a byte a node."""
    h = n1y + 1
    own = (13 if cluster else 12) * cap + cap + 2 * h if resident else 0
    values = own + 2 * h + (2 * CG_MAX_CLUSTER * _build.MAX_RED if cluster
                            else 0)
    return values * itemsize + (cap if resident else 0) + 2 * h


def cg_plan(n1x, n1y, itemsize, sms, smem_cap=SMEM_OPTIN - CG_STATIC_SMEM,
            cluster_max=CG_MAX_CLUSTER, *, instance=None, ctas=None,
            resident=None):
    """The plan of cg_solve on an (n1x, n1y) grid of ``itemsize``-byte
    values, on a card of ``sms`` SMs whose blocks may take ``smem_cap``
    bytes of dynamic shared memory and whose clusters hold at most
    ``cluster_max`` CTAs.

    One band of nodes per CTA (band_start: nearly equal contiguous ranges),
    none shorter than n1y + 1 nodes unless there is one, so that a band's
    halo (the n1y + 1 nodes on either side) lies in the bands b - 1 and
    b + 1; no more bands than give each CG_MIN_NODES nodes. The instance is "cluster" where one cluster of at most
    cluster_max CTAs holds the whole state in shared memory (the fewest
    CTAs that hold it, or more, up to that many bands), else "grid": one
    CTA per SM at most, its band's arrays in shared memory where they fit
    (resident), else in device memory and two CTAs per SM at most (256 in
    all: a reduction reads a partial per thread). ``instance``, ``ctas`` and
    ``resident`` force a plan (the tests); a forced plan that breaks the
    band rule or does not fit raises ValueError, as does a grid whose
    halo alone does not fit ``smem_cap``.

    Returns a dict: instance, ctas, starts (ctas + 1 node indices), cap
    (the largest band), halo (n1y + 1), resident, smem (bytes), n1x, n1y.
    The kernel takes the instance, ctas and resident; it works out the
    bands and their shared memory itself, so cap and smem only inform the
    choice.
    """
    n = n1x * n1y
    halo = n1y + 1
    most = max(1, n // halo)   # the most bands of at least n1y + 1 nodes
    want = max(1, min(most, -(-n // CG_MIN_NODES)))

    def make(kind, count, res):
        if not 1 <= count <= most:
            raise ValueError(
                f"cg plan: {count} bands of a {n1x} x {n1y} grid; at most "
                f"{most} hold n1y + 1 = {halo} nodes each")
        cap = -(-n // count)
        return dict(instance=kind, ctas=count,
                    starts=[band_start(0, n, count, b)
                            for b in range(count + 1)],
                    cap=cap, halo=halo, resident=res,
                    smem=cg_smem(cap, n1y, itemsize, res, kind == "cluster"),
                    n1x=n1x, n1y=n1y)

    def checked(plan):
        if plan["smem"] > smem_cap:
            raise ValueError(
                f"cg plan: a {plan['instance']} CTA of a {n1x} x {n1y} grid "
                f"of {itemsize}-byte values needs {plan['smem']} B of "
                f"shared memory ({plan['ctas']} bands, resident "
                f"{plan['resident']}); a block may take {smem_cap}")
        return plan

    if instance not in (None,) + CG_INSTANCES:
        raise ValueError(f"cg plan: instance {instance!r} is not one of "
                         f"{CG_INSTANCES}")
    top = min(cluster_max, most)
    if instance == "cluster":
        if ctas is not None and ctas > cluster_max:
            raise ValueError(f"cg plan: a cluster holds at most "
                             f"{cluster_max} CTAs, not {ctas}")
        return checked(make("cluster", ctas or min(want, top), True))
    if instance is None:
        for count in range(1, top + 1):
            if make("cluster", count, True)["smem"] <= smem_cap:
                return make("cluster", max(count, min(want, top)), True)
    if resident is None:
        resident = make("grid", ctas or min(sms, want),
                        True)["smem"] <= smem_cap
    # a band in device memory: two CTAs an SM, for more loads in flight
    top = min((1 if resident else 2) * sms, _build.MAX_GRID_CTAS)
    count = ctas or min(top, want)
    if count > top:
        raise ValueError(f"cg plan: {count} CTAs, at most {top} on {sms} "
                         f"SMs ({'one' if resident else 'two'} per SM)")
    return checked(make("grid", count, bool(resident)))


def card_cg_plan(device, n1x, n1y, dtype):
    """``cg_plan`` on the card of ``device``, worked out once per shape and
    dtype."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _card_cg_plan(index, n1x, n1y, _ITEMSIZE[dtype])


@functools.lru_cache(maxsize=64)
def _card_cg_plan(index, n1x, n1y, itemsize):
    props = torch.cuda.get_device_properties(index)
    return cg_plan(n1x, n1y, itemsize, props.multi_processor_count)


@functools.lru_cache(maxsize=64)
def cluster_occupancy(index, dtype, n1x, n1y, ctas):
    """Clusters of the cluster instance of ``ctas`` bands of an (n1x,
    n1y) grid that the card ``index`` can place at once (CUDA's occupancy
    calculator, on the kernel's own shared-memory layout); raises
    RuntimeError where it can place none."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        code = _build.entry("cft_cg_cluster_occupancy", dtype)(
            n1x, n1y, ctas, ctypes.byref(out))
    _build.check(code, "cg_solve")
    if out.value < 1:
        raise RuntimeError(
            f"cg_solve: the card cannot place a cluster of {ctas} CTAs on "
            f"a {n1x} x {n1y} grid")
    return out.value


def cg_solve(coef, b, bc_mask, diag, rtol=1e-5, maxiter=200, *, plan=None):
    """Fused constrained CG; replaces pallas_stencil.cg_solve. On the card
    the whole solve, its convergence test included, is one launch of the
    instance the plan names (``card_cg_plan``, or ``plan``, a ``cg_plan``
    of this shape)."""
    if _build.on_cpu("cg_solve", coef, b, bc_mask, diag):
        return cg_solve_plain(coef, b, bc_mask, diag, rtol, maxiter)
    n1x, n1y = b.shape
    if bc_mask.dtype != torch.bool:
        raise TypeError("cg_solve: bc_mask must be bool")
    dtype = _build.check_cuda_args(
        "cg_solve", coef, b, bc_mask, diag,
        shapes=[(7, n1x, n1y), (n1x, n1y), (n1x, n1y), (n1x, n1y)])
    dev = b.device
    if plan is None:
        plan = card_cg_plan(dev, n1x, n1y, dtype)
    elif (plan["n1x"], plan["n1y"]) != (n1x, n1y):
        raise ValueError(f"cg_solve: a plan of a {plan['n1x']} x "
                         f"{plan['n1y']} grid for a {n1x} x {n1y} one")
    cluster = plan["instance"] == "cluster"
    ctas = plan["ctas"]
    x = torch.empty_like(b)
    work = part = None
    if cluster:
        cluster_occupancy(dev.index if dev.index is not None
                          else torch.cuda.current_device(), dtype, n1x, n1y,
                          ctas)
    else:
        # r, p_0, p_1 and, not resident, dinv, Ap and each CTA's operand
        # at its band (at most ceil(n / ctas) nodes) and halo
        n = n1x * n1y
        work = torch.empty(3 * n if plan["resident"] else 5 * n
                           + ctas * (-(-n // ctas) + 2 * (n1y + 1)),
                           dtype=dtype, device=dev)
        part = torch.empty(2 * ctas * _build.MAX_RED, dtype=dtype,
                           device=dev)
    with torch.cuda.device(dev):
        code = _build.entry("cft_cg_solve", dtype)(
            coef.data_ptr(), b.data_ptr(), bc_mask.data_ptr(),
            diag.data_ptr(), x.data_ptr(),
            None if work is None else work.data_ptr(),
            None if part is None else part.data_ptr(),
            n1x, n1y, float(rtol), int(maxiter), int(cluster), ctas,
            int(plan["resident"]), _build.stream_ptr(b))
    _build.launches["cg_solve"] += 1
    _build.check(code, "cg_solve")
    return x
