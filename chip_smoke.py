"""Drive the PyTorch + CUDA port (conservation_fem_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --ablate   # the step ablation and idle share

Phases of the smoke run, in order; any failure raises and the process
exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), TF32 flags;
     no CUDA device -> error;
  2. build: compile csrc/*.cu with nvcc, one process per source (seconds
     and registers per thread of each kernel printed);
  3. each hand-written kernel against its plain PyTorch version on the card,
     numpy-seeded inputs or a mid-trajectory state (32 steps of the plain
     f64 bench path): stencil_matvec (257^2, 1025^2; f32, f64; timed on a
     CUDA graph beside the same operator as a torch CSR matrix), cg_solve
     (mesh-64 mass stencil), fused_rv_step (mesh 16, 64, 256), the split
     setup and Newton kernels against their plain stages and the whole split
     step against the single kernel (mesh 16, 64 f64; mesh 128 f32), the
     tiled kernel against its plain version and the single kernel (mesh 16
     with 8-row tiles: cheby and bicgstab, frozen and fresh Jacobian, odd
     Newton counts, gfem; mesh 256 f64; mesh 256 and 512 f32, timed beside
     the single kernel on the same state). f64 is gated at 1e-11 (1e-10 for
     the tiled kernel: the JAX package's bound for its tiled BiCGStab
     kernel), f32 at 1e-4;
  4. the main paths through kpp.build(..., use_kernels=True).solve(), f32
     bench config (bench.py:_config), each gated at L2rel <= 1e-2 against
     its committed f64 anchor and u in [0.5, 12], with the launch counts
     zeroed just before the kernel-path solve and read just after it: mesh
     64 (100 steps, single kernel), mesh 128 (200 steps, split), mesh 256
     (400 steps, tiled), mesh 512 to T = 0.1 (80 steps, tiled); beside each,
     the plain-torch composed path (gated, timed) and the unprofiled device
     idle share; then, as a run of its own, 5 steps of the adaptive f64
     config with kernels on (cg_solve mass solve), checked against the
     same steps without kernels;
  5. the sharded fused structured path (parallel/): both block-mode
     kernels, fused_rv_block_step and tiled_rv_step with row0_base, against
     their plain version on the card on every row of a first, an interior
     and a last deep-halo block (rows above the grid; none; padding rows
     below it) and, on the owned rows, against the single kernel on the
     whole grid — f64 at mesh 16 (2 blocks, trimmed counts, 8-row tiles),
     64 and 256 (4 blocks), rv and gfem, frozen and fresh Jacobian; f32 at
     mesh 64 and 256; timed on an interior block of 4 at mesh 64, 128, 256
     and 512. Then the path itself through kpp.build(cfg) and
     ShardedFusedStructured(p, LocalBlocks(n, "cuda")).solve(), f32, the
     Chebyshev configuration (SHARDED below), launch counts zeroed just
     before each solve and read just after: SHARDED_PATHS, each beside the
     single-device kernel path of the same configuration and gated against
     it (L2rel against the anchor within 1e-3 of each other — this
     configuration alone misses the 1e-2 anchor gate from mesh 64 up on
     any path, so that gate is printed, not applied; u in [0.5, 12], or
     where the single-device run itself leaves that range, min and max
     within 1e-2 of its); the same in f64
     for 5 steps at mesh 64 and 256, through either kernel, against the
     single kernel (1e-11); and one
     ProcessGroupBlocks run on a one-rank NCCL group against LocalBlocks(1),
     bit for bit.
The second-to-last line is the per-kernel JSON summary (all eight ported
kernels, each with its bound); the last line is {"ok": true, "device":
{...}}.

The ablation (--ablate) times one fused_rv_step launch, f32 bench config,
from the mid-trajectory state at mesh 64 and 256, with one keyword
argument of the wrapper changed per variant (ABLATIONS; the kernel source
is the same for all); times the tiled kernel at mesh 256 and 512 with
8, 16, 32 and 64 rows per tile beside the single kernel; and reads the
device's idle share over a 20-step solve of each main path (mesh 64, 128,
256, 512), with and without torch.profiler.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
F64_TOL = 1e-11          # kernel vs plain, f64
TILED_F64_TOL = 1e-10    # tiled kernel vs plain / single kernel, f64
F32_TOL = 1e-4           # kernel vs plain, f32
ACCURACY_GATE = 1e-2     # L2rel vs the committed f64 anchor (bench.py)
SANITY_RANGE = (0.5, 12.0)   # u of a sane KPP run (bench.py)
ADAPTIVE_TOL = 1e-9      # adaptive f64 solves to 1e-12 in two reduction orders
ADAPTIVE_STEPS = 5
# (mesh, T, expected whole-step kernel, anchor); T None: the bench's 1.0
MAIN_PATHS = ((64, None, "single", "kpp_rv_anchor_mesh64.npy"),
              (128, None, "split", "kpp_rv_anchor_mesh128.npy"),
              (256, None, "tiled", "kpp_rv_anchor_mesh256.npy"),
              (512, 0.1, "tiled", "kpp_rv_anchor_mesh512_T0.1.npy"))
# The sharded path's configuration: the JAX package's own on-chip probe of
# it (scripts/probe_sharded_onchip.py), dt = 0.01 min(1, 64 / mesh); the
# halo is required_halo(10, 2, 16) = 62 rows.
SHARDED = dict(inner_solver="cheby", cg_iters=10, newton_iters=2,
               newton_linear_iters=16, modified_newton=True)
# (mesh, T, blocks, kernel asked for, kernel expected, (L, B), anchor). The
# auto rule picks the block kernel while a field of the extended block is at
# most 270 KiB: mesh 64 x 4 (189 x 257 x 4 B = 194,292 B); the tiled kernel's
# block mode beyond: mesh 128 x 4 (253 x 513 x 4 B = 519,156 B), 256 x 4 and
# 512 x 4. Mesh 64 x 1 is the one-block form of the JAX probe, which asks
# for the block kernel (381 x 257 x 4 B: auto would pick tiled). The kernels
# line takes each kernel's launch count from the first run that launches it:
# mesh 64 x 4 and mesh 256 x 4, the blocks its times are taken on.
SHARDED_PATHS = (
    (64, None, 4, "auto", "block", (65, 189), "kpp_rv_anchor_mesh64.npy"),
    (256, None, 4, "auto", "tiled", (257, 381), "kpp_rv_anchor_mesh256.npy"),
    (128, None, 4, "auto", "tiled", (129, 253), "kpp_rv_anchor_mesh128.npy"),
    (512, 0.1, 4, "auto", "tiled", (513, 637),
     "kpp_rv_anchor_mesh512_T0.1.npy"),
    (64, None, 1, "block", "block", (257, 381), "kpp_rv_anchor_mesh64.npy"),
)
SHARDED_VS_SINGLE = 1e-3   # |L2rel sharded - L2rel single device|, f32
# Where the single-device path of this configuration itself leaves
# SANITY_RANGE (mesh 512, T = 0.1: min u 0.493 on every path, the anchor's
# is 0.588), the sharded run's min and max are held to the single-device
# run's within this much instead.
SHARDED_RANGE_SLACK = 1e-2
SHARDED_F64_STEPS = 5

# The least time of a kernel's work: max(bytes / HBM rate, operations /
# peak rate), H100 SXM data sheet (700 W): 3.35 TB/s; 67 TFLOP/s f32 and
# 34 TFLOP/s f64 outside the tensor cores (the kernels use none).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32": 67e12, "f64": 34e12}
# Operations per node of the step's parts, counted from csrc/fused_step.cuh
# (an add, multiply, divide, min, max or abs is one operation; a sin or a
# cos is one), as often as the algorithm needs them (the JAX _make_lib):
# what depends on a triangle alone once per triangle, 2 per node, and what
# depends on one of its corners once per corner, 6 per node. The kernels
# recompute a triangle's part at each of its 3 corners; that is their cost,
# not the work's.
OPS_STENCIL = 13                        # stencil_apply: 7 mul + 6 add
OPS_NL = 2 * (10 + 6 * 10) + 6 * (6 * 2 + 2)   # nl_rhs_node: per triangle
#   the gradient (10) and per quadrature point its value (5), sin, cos
#   and f'(u_q) . grad u (3); per corner 6 weighted sums (2 each) + 2
OPS_CONV = 2 * (10 + 6 * (10 + 3 * 5)) + 6 * 3 * (6 * 2 + 2)   # conv_planes
#   _node: per triangle and quadrature point as OPS_NL plus the 3 terms
#   fg phi_b + fx G_b0 + fy G_b1 (5 each); per corner 3 weighted sums
OPS_PROJ_RHS = 5 + OPS_STENCIL + OPS_NL + 6   # du, M du, N(u), rhs, z, dots
OPS_CG_ITER = OPS_STENCIL + 13          # M p, 2 dots, x, r, z, p
OPS_CHEBY_ITER = OPS_STENCIL + 6        # A d, x, r, d
OPS_RV = 3 + 6 * 5 + 8                  # max|u - mean|, patch max/min/|RH|,
#   eps
OPS_PLANES = 2 * 3 + 6 * 3 * 2 + OPS_STENCIL   # cell-mean eps per triangle,
#   7 planes per corner, K u
OPS_F = 7 + 2 * OPS_STENCIL + OPS_NL + 5   # F(uk): M (uk - u), N(uk), K uk
OPS_LIN = OPS_CONV + 22                 # J = M + dt/2 (K + C), 1 / J_00
OPS_BICG_ITER = 2 * OPS_STENCIL + 22    # J phat, J shat, 4 dots, s, shat,
#   x, r, p, phat

# (name, fused_rv_step keyword arguments changed from the bench config)
ABLATIONS = (
    ("full", {}),
    ("cg_iters=0", dict(cg_iters=0)),
    ("lin_iters=0", dict(lin_iters=0)),
    ("newton_iters=0", dict(newton_iters=0)),
    ("cg_iters=0,newton_iters=0", dict(cg_iters=0, newton_iters=0)),
    ("stabilization=gfem", dict(stabilization="gfem")),
    ("freeze_jacobian=False", dict(freeze_jacobian=False)),
    ("cheby 2x16, mass cg 10", dict(inner_solver="cheby", lin_iters=16,
                                    cg_iters=10)),
)
TILE_ROWS = (8, 16, 32, 64)   # tiled-kernel tile sizes timed by --ablate


def log(msg):
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    import conservation_fem_tpu_torch as cft

    cft.assert_no_tf32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{torch.cuda.get_device_name(0)}; tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32} precision="
        f"{torch.get_float32_matmul_precision()}")
    return card


def phase_build():
    """Build the kernels; print the seconds and, from ptxas -v, each
    kernel's registers per thread and spill stores."""
    import re

    from conservation_fem_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    regs, name = {}, None
    for line in _build.build_log.splitlines():
        m = re.search(r"entry function '_ZN3cft\d+(\w+?)_kernelI([fd])", line)
        if m:
            name = f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'f64'}"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            regs.setdefault(name, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs.setdefault(name, {})["registers"] = int(m.group(1))
            name = None
    log(json.dumps({"registers_per_thread": regs}))


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn over reps calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def step_ops(s, part="step"):
    """Operations per node of one whole step (part "step"), of the split
    setup ("setup") or of one split Newton launch ("newton"); s: the step's
    keyword arguments."""
    cheby = s["inner_solver"] == "cheby"
    head = (OPS_PROJ_RHS
            + s["cg_iters"] * (OPS_CHEBY_ITER if cheby else OPS_CG_ITER)
            + (OPS_RV if s["stabilization"] == "rv" else 0) + OPS_PLANES)
    newton = s["lin_iters"] * (OPS_CHEBY_ITER if cheby else OPS_BICG_ITER) + 1
    if part == "setup":
        return head + OPS_F
    if part == "newton":
        return OPS_LIN + newton + OPS_F
    n_lin = 1 if s["freeze_jacobian"] else s["newton_iters"]
    return head + s["newton_iters"] * (OPS_F + newton) + n_lin * OPS_LIN


def bound(n_bytes, ops, dn):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of the dtype."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dn] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def graph_ms(fn, reps=100, replays=5):
    """Mean milliseconds per call of fn, from replays of a CUDA graph of
    reps calls (device time, without the host's per-call cost)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _gated(name, e, dtype_name, errs, f64_tol=F64_TOL):
    """Record e under its dtype and raise if it exceeds that dtype's bound."""
    tol = f64_tol if dtype_name == "f64" else F32_TOL
    errs[dtype_name] = max(errs.get(dtype_name, 0.0), e)
    if not e <= tol:
        raise AssertionError(f"{name} {dtype_name} error {e} > {tol}")


def _csr_of(coef):
    """The 7-plane stencil operator as a torch CSR matrix (zero outside
    the grid), the library yardstick of stencil_matvec."""
    import torch

    n1x, n1y = coef.shape[1:]
    ii, jj = torch.meshgrid(torch.arange(n1x, device=coef.device),
                            torch.arange(n1y, device=coef.device),
                            indexing="ij")
    rows, cols, vals = [], [], []
    for k, (di, dj) in enumerate(((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
                                  (1, 1), (-1, -1))):
        inside = ((ii + di >= 0) & (ii + di < n1x) & (jj + dj >= 0)
                  & (jj + dj < n1y))
        rows.append((ii * n1y + jj)[inside])
        cols.append(((ii + di) * n1y + jj + dj)[inside])
        vals.append(coef[k][inside])
    n = n1x * n1y
    return torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n, n)).coalesce().to_sparse_csr()


def check_stencil_matvec(summary):
    import torch

    from conservation_fem_tpu_torch.ops import stencil_kernels as sk

    errs, times = {}, {}
    for n1 in (257, 1025):
        for dtype, dn in ((torch.float32, "f32"), (torch.float64, "f64")):
            rng = np.random.default_rng(n1)
            coef = torch.tensor(rng.normal(size=(7, n1, n1)), dtype=dtype,
                                device="cuda")
            x = torch.tensor(rng.normal(size=(n1, n1)), dtype=dtype,
                             device="cuda")
            y = sk.stencil_matvec(coef, x)
            y0 = sk.stencil_matvec_plain(coef, x)
            torch.cuda.synchronize()
            e = max_err(y, y0)
            log(f"stencil_matvec {n1}^2 {dn}: max|kernel-plain| = {e:.3e}")
            _gated("stencil_matvec", e, dn, errs)
            if dn == "f32":
                A, xv = _csr_of(coef), x.reshape(-1)
                e_lib = max_err((A @ xv).reshape(n1, n1), y)
                if not e_lib <= F32_TOL:
                    raise AssertionError(f"CSR yardstick differs by {e_lib}")
                lib_ms = graph_ms(lambda: A @ xv)
                times[n1] = dict(
                    ms=graph_ms(lambda: sk.stencil_matvec(coef, x)),
                    host_ms=cuda_ms(lambda: sk.stencil_matvec(coef, x), 200),
                    plain_ms=cuda_ms(lambda: sk.stencil_matvec_plain(coef, x),
                                     200),
                    library_ms=lib_ms,
                    bound=bound(9 * n1 * n1 * 4, OPS_STENCIL * n1 * n1,
                                "f32"))
                log(f"stencil_matvec {n1}^2 f32: kernel {times[n1]['ms']:.5f}"
                    f" ms on a CUDA graph ({times[n1]['host_ms']:.5f} ms per "
                    f"wrapper call back to back), plain "
                    f"{times[n1]['plain_ms']:.5f} ms, torch CSR SpMV "
                    f"{lib_ms:.5f} ms on a CUDA graph, bound "
                    f"{times[n1]['bound'][0]:.5f} ms")
    t = times[257]
    summary["stencil_matvec"] = dict(
        max_abs_err=errs["f64"], err_case="f64, 257x257 and 1025x1025",
        max_abs_err_f32=errs["f32"], f32_case="f32, 257x257 and 1025x1025",
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
        bound_by=t["bound"][1], library_ms=t["library_ms"],
        timed_case="257x257 f32 (the mesh-64 grid); kernel and library "
                   "(torch CSR SpMV) each on a CUDA graph of 100 calls",
        host_ms_per_call=t["host_ms"], ms_1025=times[1025]["ms"],
        library_ms_1025=times[1025]["library_ms"],
        bound_ms_1025=times[1025]["bound"][0])


def check_cg_solve(summary):
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.ops import stencil_kernels as sk

    errs = {}
    for dtype, dn, rtol in (("float64", "f64", 1e-10),
                            ("float32", "f32", 1e-5)):
        p = kpp.build(kpp.KPPConfig(mesh_size=64, dtype=dtype, T=0.0),
                      device="cuda")
        sd = p.sd
        # b = M x_true with x_true ~ N(0, 1), so the solution is O(1) and
        # the absolute bound is a relative one
        rng = np.random.default_rng(64)
        x_true = torch.tensor(rng.normal(size=sd.bc2.shape), dtype=p.dtype,
                              device="cuda")
        x_true = torch.where(sd.bc2, 0.0, x_true)
        b = torch.where(sd.bc2, 0.0,
                        sk.stencil_matvec_plain(sd.M_coef, x_true))
        args = (sd.M_coef, b, sd.bc2, sd.diagM2)
        x = sk.cg_solve(*args, rtol=rtol)
        x0 = sk.cg_solve_plain(*args, rtol=rtol)
        torch.cuda.synchronize()
        e = max_err(x, x0)
        res = float(torch.where(sd.bc2, 0.0, b - sk.stencil_matvec_plain(
            sd.M_coef, torch.where(sd.bc2, 0.0, x))).norm() / b.norm())
        log(f"cg_solve mesh 64 {dn} rtol {rtol}: max|kernel-plain| = "
            f"{e:.3e}, kernel relative residual {res:.2e}")
        _gated("cg_solve", e, dn, errs)
        if not res <= 10 * rtol:
            raise AssertionError(f"cg_solve {dn} residual {res}")
        if dn == "f64":
            times = (cuda_ms(lambda: sk.cg_solve(*args, rtol=rtol), 20),
                     cuda_ms(lambda: sk.cg_solve_plain(*args, rtol=rtol), 3))
            # this solve's iterations: the plain solve's matvec calls - 1
            calls, mv = [], sk.stencil_matvec_plain
            sk.stencil_matvec_plain = lambda *a: calls.append(1) or mv(*a)
            try:
                sk.cg_solve_plain(*args, rtol=rtol)
            finally:
                sk.stencil_matvec_plain = mv
            iters, n = len(calls) - 1, b.numel()
            # coef, b, diag, x in f64 and the bool mask; per iteration the
            # pinned matvec and 2 dots, x, r, z, p (as OPS_CG_ITER)
            cg_bound = bound(n * (10 * 8 + 1), n * iters * OPS_CG_ITER, "f64")
            log(f"cg_solve mesh 64 f64: {iters} iterations, kernel "
                f"{times[0]:.5f} ms, plain {times[1]:.5f} ms, bound "
                f"{cg_bound[0]:.6f} ms ({cg_bound[1]})")
    summary["cg_solve"] = dict(
        max_abs_err=errs["f64"], err_case="mesh-64 mass solve f64 rtol 1e-10",
        max_abs_err_f32=errs["f32"],
        f32_case="mesh-64 mass solve f32 rtol 1e-5",
        ms=times[0], plain_ms=times[1], bound_ms=cg_bound[0],
        bound_by=cg_bound[1], library_ms=None, iterations=iters,
        timed_case="mesh-64 mass solve f64 rtol 1e-10")


def _bench_cfg(kpp, mesh_size, dtype, **kw):
    """bench.py:_config: CFL-matched dt, modified Newton 2 x BiCGStab(4),
    6 mass-CG iterations, no final residual."""
    return kpp.KPPConfig(
        mesh_size=mesh_size, dtype=dtype,
        dt=0.01 * min(1.0, 64.0 / mesh_size), modified_newton=True,
        cg_iters=6, newton_iters=2, newton_linear_iters=4,
        newton_final_residual=False, inner_solver="bicgstab", **kw)


def mid_trajectory_state(mesh):
    """(problem, u, u_old, u_old_old, g) as (n1x, n1y) f64 grids after 32
    steps of the plain composed bench path (the shock has formed)."""
    from conservation_fem_tpu_torch.models import kpp

    dt = 0.01 * min(1.0, 64.0 / mesh)
    p = kpp.build(_bench_cfg(kpp, mesh, "float64", T=30 * dt), device="cuda")
    res = p.solve()
    u_hist = [res.u]
    carry = (res.u, res.u, res.u)
    for _ in range(2):
        carry, _ = p.step(carry, p.dt)
        u_hist.append(carry[0])
    sh = p._shape2
    u2, uo2, uoo2 = (v.reshape(sh) for v in u_hist[::-1])
    g2 = p.bc_value(p.points, p.dt).reshape(sh)
    return p, u2, uo2, uoo2, g2


def check_fused_step(summary, states):
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs

    errs = {}
    for mesh in (16, 64, 256):
        p, u2, uo2, uoo2, g2 = states[mesh]
        cases = ([("bicgstab", True)] if mesh == 256 else
                 [(s, f) for s in ("bicgstab", "cheby")
                  for f in (True, False)])
        for solver, frozen in cases:
            lin = 4 if solver == "bicgstab" else 16
            kw = dict(p.fused_step_kwargs(), inner_solver=solver,
                      lin_iters=lin, freeze_jacobian=frozen,
                      cg_iters=6 if solver == "bicgstab" else 10)
            out = fs.fused_rv_step(u2, uo2, uoo2, g2, p.sd.M_coef, **kw)
            ref = fs.fused_rv_step_plain(u2, uo2, uoo2, g2, p.sd.M_coef,
                                         **kw)
            torch.cuda.synchronize()
            e = max(max_err(a, b) for a, b in zip(out, ref))
            step_size = max_err(ref[0], u2)
            log(f"fused_rv_step mesh {mesh} f64 {solver} frozen={frozen}:"
                f" max|kernel-plain| = {e:.3e} (step change "
                f"{step_size:.3e})")
            _gated("fused_rv_step", e, "f64", errs)
    # f32, bench config, at both main-path sizes; timed there
    times = {}
    for mesh in (64, 256):
        p, *fields = states[mesh]
        f32 = [v.float() for v in fields] + [p.sd.M_coef.float()]
        kw = p.fused_step_kwargs()
        out = fs.fused_rv_step(*f32, **kw)
        ref = fs.fused_rv_step_plain(*f32, **kw)
        torch.cuda.synchronize()
        e = max(max_err(a, b) for a, b in zip(out, ref))
        _gated("fused_rv_step", e, "f32", errs)
        n = f32[0].numel()
        times[mesh] = (cuda_ms(lambda: fs.fused_rv_step(*f32, **kw), 20),
                       cuda_ms(lambda: fs.fused_rv_step_plain(*f32, **kw), 3),
                       bound(14 * n * 4, n * step_ops(fs.step_args("", kw)),
                             "f32"))
        log(f"fused_rv_step mesh {mesh} f32 bench config: max|kernel-plain| "
            f"= {e:.3e}; one step {times[mesh][0]:.4f} ms, plain "
            f"{times[mesh][1]:.4f} ms, bound {times[mesh][2][0]:.5f} ms "
            f"({times[mesh][2][1]})")
    summary["fused_rv_step"] = dict(
        max_abs_err=errs["f64"],
        err_case="f64 one step: mesh 16 and 64 bicgstab/cheby x frozen/"
                 "fresh Jacobian, mesh 256 bench config",
        max_abs_err_f32=errs["f32"],
        f32_case="f32 one step, bench config, mesh 64 and 256",
        ms=times[64][0], plain_ms=times[64][1], bound_ms=times[64][2][0],
        bound_by=times[64][2][1], library_ms=None,
        timed_case="mesh-64 one step f32 bench config",
        ms_mesh256=times[256][0], plain_ms_mesh256=times[256][1],
        bound_ms_mesh256=times[256][2][0])
    return states


def _bench_f32(state):
    """(problem, f32 fields + mass planes, bench step kwargs) of a state."""
    p, *fields = state
    return (p, [v.float() for v in fields] + [p.sd.M_coef.float()],
            p.fused_step_kwargs())


def check_split(summary, states):
    """Each split kernel against its plain stage, and the whole split step
    against the single kernel: f64 at mesh 16 and 64, f32 at mesh 128 (the
    split main path), timed there."""
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs

    errs = {}

    def compare(p, fields, kw, dn):
        u2, uo2, uoo2, g2, Mc = fields
        s = fs.step_args("split", kw)
        sd, body = fs._plain_data(u2, Mc, s), fs._body_kw(s)
        setup = fs.split_setup(*fields, **kw)
        ref = fs._split_setup_plain(sd, u2, uo2, uoo2, g2, **body)
        e_setup = max(max_err(a, b) for a, b in zip(setup, ref))
        Kc, aux, uk, F = setup
        newton = fs.split_newton(uk, F, u2, g2, Mc, Kc, aux, uk, **kw)
        ref = fs._split_newton_plain(sd, uk, F, u2, g2, Kc, aux, uk, **body)
        e_newton = max(max_err(a, b) for a, b in zip(newton, ref))
        e_step = max_err(fs.fused_rv_step_split(*fields, **kw),
                         fs.fused_rv_step(*fields, **kw)[0])
        torch.cuda.synchronize()
        log(f"split {tuple(u2.shape)} {dn} {kw['inner_solver']} frozen="
            f"{kw['freeze_jacobian']}: setup {e_setup:.3e}, newton "
            f"{e_newton:.3e} vs plain stage; split step vs single kernel "
            f"{e_step:.3e}")
        for name, e in (("split_setup", e_setup), ("split_newton", e_newton),
                        ("split step", e_step)):
            _gated(name, e, dn, errs.setdefault(name, {}))

    for mesh in (16, 64):
        p, *fields = states[mesh]
        fields = list(fields) + [p.sd.M_coef]
        for solver, frozen in (("bicgstab", True), ("cheby", False)):
            kw = dict(p.fused_step_kwargs(), inner_solver=solver,
                      freeze_jacobian=frozen, newton_iters=3,
                      cg_iters=6 if solver == "bicgstab" else 10,
                      lin_iters=4 if solver == "bicgstab" else 16)
            compare(p, fields, kw, "f64")
    p, f32, kw = _bench_f32(states[128])
    compare(p, f32, kw, "f32")
    u2, uo2, uoo2, g2, Mc = f32
    s = fs.step_args("split", kw)
    sd, body = fs._plain_data(u2, Mc, s), fs._body_kw(s)
    Kc, aux, uk, F = fs.split_setup(*f32, **kw)
    n = u2.numel()
    times = dict(
        split_setup=(cuda_ms(lambda: fs.split_setup(*f32, **kw), 20),
                     cuda_ms(lambda: fs._split_setup_plain(
                         sd, u2, uo2, uoo2, g2, **body), 3),
                     bound(22 * n * 4, n * step_ops(s, "setup"), "f32")),
        split_newton=(cuda_ms(lambda: fs.split_newton(
                          uk, F, u2, g2, Mc, Kc, aux, uk, **kw), 20),
                      cuda_ms(lambda: fs._split_newton_plain(
                          sd, uk, F, u2, g2, Kc, aux, uk, **body), 3),
                      bound(23 * n * 4, n * step_ops(s, "newton"), "f32")))
    step_ms = cuda_ms(lambda: fs.fused_rv_step_split(*f32, **kw), 20)
    single_ms = cuda_ms(lambda: fs.fused_rv_step(*f32, **kw), 20)
    for name, (ms, plain_ms, (b_ms, b_by)) in times.items():
        log(f"{name} mesh 128 f32 bench config: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        summary[name] = dict(
            max_abs_err=errs[name]["f64"],
            err_case="f64 mesh 16 and 64, mid-trajectory: bicgstab frozen, "
                     "cheby fresh, 3 Newton iterations, against the plain "
                     "stage on the same inputs",
            max_abs_err_f32=errs[name]["f32"],
            f32_case="f32 mesh 128 bench config, against the plain stage",
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, timed_case="mesh-128 f32 bench config, one "
                                        "launch",
            split_step_vs_single_f64=errs["split step"]["f64"],
            split_step_vs_single_f32=errs["split step"]["f32"])
    log(f"split step mesh 128 f32 (1 + 2 launches): {step_ms:.4f} ms; single "
        f"kernel on the same state {single_ms:.4f} ms")
    summary["split_setup"].update(step_ms_mesh128=step_ms,
                                  single_ms_mesh128=single_ms)


def check_tiled(summary, states):
    """The tiled kernel against its plain version and the single kernel:
    f64 at mesh 16 with 8-row tiles (multi-tile, ragged last tile) over the
    inner solvers, Jacobian modes, odd Newton counts and gfem, and at mesh
    256 (bench config, default tiles); f32 at mesh 256 and 512 (the tiled
    main paths), timed there beside the single kernel."""
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    errs, vs_single = {}, {}

    def compare(fields, kw, dn, tile_rows=None, label=""):
        out = ts.tiled_rv_step(*fields, tile_rows=tile_rows, **kw)
        e = max_err(out, ts.tiled_rv_step_plain(*fields, **kw))
        e_single = max_err(out, fs.fused_rv_step(*fields, **kw)[0])
        torch.cuda.synchronize()
        log(f"tiled_rv_step {label} {dn}: max|kernel-plain| = {e:.3e}, "
            f"vs single kernel {e_single:.3e}")
        _gated("tiled_rv_step", e, dn, errs, TILED_F64_TOL)
        _gated("tiled vs single", e_single, dn, vs_single, TILED_F64_TOL)

    p, *fields = states[16]
    fields = list(fields) + [p.sd.M_coef]
    for solver, frozen, newton, stab in (
            ("bicgstab", True, 2, "rv"), ("bicgstab", False, 3, "rv"),
            ("cheby", True, 3, "rv"), ("cheby", False, 2, "rv"),
            ("bicgstab", True, 3, "gfem")):
        kw = dict(p.fused_step_kwargs(), inner_solver=solver,
                  freeze_jacobian=frozen, newton_iters=newton,
                  stabilization=stab,
                  cg_iters=6 if solver == "bicgstab" else 10,
                  lin_iters=4 if solver == "bicgstab" else 16)
        compare(fields, kw, "f64", 8,
                f"mesh 16, 8-row tiles, {solver} frozen={frozen} "
                f"newton={newton} {stab}")
    p, *fields = states[256]
    compare(list(fields) + [p.sd.M_coef], p.fused_step_kwargs(), "f64",
            label="mesh 256 bench config")
    times = {}
    for mesh in (256, 512):
        p, f32, kw = _bench_f32(states[mesh])
        compare(f32, kw, "f32", label=f"mesh {mesh} bench config")
        n = f32[0].numel()
        times[mesh] = dict(
            ms=cuda_ms(lambda: ts.tiled_rv_step(*f32, **kw), 10),
            single_ms=cuda_ms(lambda: fs.fused_rv_step(*f32, **kw), 10),
            plain_ms=cuda_ms(lambda: ts.tiled_rv_step_plain(*f32, **kw), 2),
            bound=bound(12 * n * 4, n * step_ops(fs.step_args("", kw)),
                        "f32"),
            tile_rows=ts.default_tile_rows(
                *f32[0].shape, 4,
                torch.cuda.get_device_properties(0).multi_processor_count))
        t = times[mesh]
        log(f"tiled_rv_step mesh {mesh} f32 bench config ({t['tile_rows']}-"
            f"row tiles): {t['ms']:.4f} ms; single kernel on the same state "
            f"{t['single_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; bound "
            f"{t['bound'][0]:.5f} ms ({t['bound'][1]})")
    t = times[256]
    summary["tiled_rv_step"] = dict(
        max_abs_err=errs["f64"],
        err_case="f64 one step: mesh 16 with 8-row tiles (bicgstab/cheby, "
                 "frozen/fresh, 2 and 3 Newton iterations, gfem), mesh 256 "
                 "bench config",
        max_abs_err_f32=errs["f32"], f32_case="f32 mesh 256 and 512 bench "
                                              "config",
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
        bound_by=t["bound"][1], library_ms=None,
        timed_case="mesh-256 f32 bench config, one step",
        single_ms_mesh256=t["single_ms"], vs_single_f64=vs_single["f64"],
        vs_single_f32=vs_single["f32"], ms_mesh512=times[512]["ms"],
        single_ms_mesh512=times[512]["single_ms"],
        plain_ms_mesh512=times[512]["plain_ms"],
        bound_ms_mesh512=times[512]["bound"][0])


def _field_stats(u, mesh_size, anchor):
    """(L2rel against the anchor, min, max) of a finite solution."""
    ref = np.load(os.path.join(REPO, "golden", anchor))
    u = u.double().cpu().numpy()
    if not np.isfinite(u).all():
        raise AssertionError(f"mesh {mesh_size}: solution not finite")
    rel = float(np.linalg.norm(u - ref) / np.linalg.norm(ref))
    return rel, float(u.min()), float(u.max())


def _in_range(lo, hi):
    return lo >= SANITY_RANGE[0] and hi <= SANITY_RANGE[1]


def _gate(u, mesh_size, anchor):
    rel, lo, hi = _field_stats(u, mesh_size, anchor)
    if not _in_range(lo, hi):
        raise AssertionError(
            f"mesh {mesh_size}: solution outside the sanity range [0.5, 12]")
    if not rel <= ACCURACY_GATE:
        raise AssertionError(f"mesh {mesh_size}: L2rel {rel:.3e} > "
                             f"{ACCURACY_GATE}")
    return rel


def _timed(fn, steps):
    """(result, microseconds per step) of fn() on CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) * 1e3 / steps


def _timed_solve(p):
    """(solution, microseconds per step) of one p.solve() after a warm-up
    solve, CUDA events around the timed one."""
    import torch

    p.solve()
    torch.cuda.synchronize()
    return _timed(lambda: p.solve().u, p.num_steps)


def _counted_solve(p):
    """(solution, launch counts) of one p.solve(): the counts are zeroed
    just before it and read just after it."""
    import torch

    from conservation_fem_tpu_torch.ops import _build

    _build.launches.clear()
    u = p.solve().u
    torch.cuda.synchronize()
    return u, dict(_build.launches)


def _single_kernel_solve(p):
    """(solution, microseconds per step) of p's trajectory with one
    fused_rv_step launch per step whatever p's mode, CUDA events."""
    g2 = p.bc_value(p.points, p.dt).reshape(p._shape2)

    def run():
        carry = p._initial_carry()
        for _ in range(p.num_steps):
            carry = p._fused_call(carry, g2, 1)
        return carry[0]

    return _timed(run, p.num_steps)


def _expected_launches(mode, steps, newton_iters):
    return {"single": {"fused_rv_step": steps},
            "split": {"split_setup": steps,
                      "split_newton": newton_iters * steps},
            "tiled": {"tiled_rv_step": steps}}[mode]


def run_main_path(mesh_size, T, mode, anchor, card):
    """Kernel path of the bench config (gated, launch counts of its own
    run, timed), its unprofiled idle share, and its plain-torch composed
    twin (gated, timed)."""
    import torch

    from conservation_fem_tpu_torch.models import kpp

    extra = {} if T is None else dict(T=T)
    p = kpp.build(_bench_cfg(kpp, mesh_size, "float32", use_kernels=True,
                             **extra), device="cuda")
    if p._fused_mode() != mode:
        raise AssertionError(f"mesh {mesh_size}: mode {p._fused_mode()}, "
                             f"expected {mode}")
    n = int(p.u0.numel())
    u, counts = _counted_solve(p)
    log(f"main path mesh {mesh_size} ({mode}), f32 bench config, "
        f"{p.num_steps} steps: launches {counts}")
    want = _expected_launches(mode, p.num_steps, p.cfg.newton_iters)
    if counts != want:
        raise AssertionError(f"mesh {mesh_size}: launched {counts}, "
                             f"expected {want}")
    rel = _gate(u, mesh_size, anchor)
    u_again, us_kernel = _timed_solve(p)
    if not torch.equal(u_again, u):
        raise AssertionError(f"mesh {mesh_size}: repeated solves differ")
    log(f"mesh {mesh_size}: repeated kernel-path solves identical bit for "
        f"bit")
    # unprofiled idle share: 1 - steps x back-to-back step time / solve time
    carry = (u, u, u)
    step_ms = cuda_ms(lambda: p._step_fused(carry, p.dt), 20)
    idle = 1.0 - step_ms * 1e3 / us_kernel
    if mode != "single":
        # the same trajectory through the single kernel, for the dispatch
        # rule's trade at this size
        u_single, us_single = _single_kernel_solve(p)
        log(f"mesh {mesh_size} f32 single-kernel path (not dispatched): "
            f"{us_single:.1f} us/step, {n / us_single * 1e6:.4g} DOF-steps/s, "
            f"L2rel vs anchor {_gate(u_single, mesh_size, anchor):.4e}, "
            f"max|{mode} - single| {max_err(u, u_single):.3e}")
    q = kpp.build(_bench_cfg(kpp, mesh_size, "float32", **extra),
                  device="cuda")
    uq, us_plain = _timed_solve(q)
    rel_plain = _gate(uq, mesh_size, anchor)
    d_plain = max_err(u, uq)
    for name, us in (("kernel", us_kernel), ("plain-torch", us_plain)):
        log(f"mesh {mesh_size} f32 {name} path: {us:.1f} us/step, "
            f"{n / us * 1e6:.4g} DOF-steps/s ({card})")
    log(f"mesh {mesh_size}: L2rel vs anchor kernel {rel:.4e}, plain "
        f"{rel_plain:.4e}; max|kernel - plain| {d_plain:.3e}; back-to-back "
        f"step {step_ms * 1e3:.1f} us, unprofiled idle share {idle:.4%}")
    return counts


def run_adaptive_path(mesh_size):
    """ADAPTIVE_STEPS steps of the adaptive f64 config with kernels on (the
    mass solve is cg_solve), against the same steps without kernels."""
    from conservation_fem_tpu_torch.models import kpp

    dt = 0.01 * min(1.0, 64 / mesh_size)
    acfg = kpp.KPPConfig(mesh_size=mesh_size, dtype="float64",
                         T=ADAPTIVE_STEPS * dt, dt=dt, use_kernels=True)
    ua, counts = _counted_solve(kpp.build(acfg, device="cuda"))
    log(f"adaptive f64 mesh {mesh_size}, {ADAPTIVE_STEPS} steps: launches "
        f"{counts}")
    if counts.get("cg_solve", 0) != ADAPTIVE_STEPS:
        raise AssertionError(f"cg_solve launched {counts.get('cg_solve')}"
                             f" times for {ADAPTIVE_STEPS} steps")
    ub = kpp.build(dataclasses.replace(acfg, use_kernels=False),
                   device="cuda").solve().u
    da = max_err(ua, ub)
    log(f"adaptive f64 mesh {mesh_size}, {ADAPTIVE_STEPS} steps: "
        f"max|kernels - plain| = {da:.3e} (gate {ADAPTIVE_TOL})")
    if not da <= ADAPTIVE_TOL:
        raise AssertionError(f"adaptive path differs by {da}")
    return counts


def _sharded_cfg(kpp, mesh_size, dtype, **kw):
    return kpp.KPPConfig(mesh_size=mesh_size, dtype=dtype,
                         dt=0.01 * min(1.0, 64.0 / mesh_size), **SHARDED,
                         **kw)


def _deep_halo_blocks(fields, Mc, n_blocks, D):
    """[(row0, [u, uo, uoo, g, Mc] extended)] of a split of the grid's rows
    into n_blocks, with L and the grid's row count."""
    import torch

    n1x = fields[0].shape[0]
    L = -(-n1x // n_blocks)
    pad = (0, 0, D, L * n_blocks - n1x + D)
    ext = [torch.nn.functional.pad(a, pad) for a in list(fields) + [Mc]]
    return [(d * L - D, [a[..., d * L:d * L + L + 2 * D, :].contiguous()
                         for a in ext]) for d in range(n_blocks)], L


def check_block_kernels(summary, states):
    """fused_rv_block_step and block-mode tiled_rv_step against the plain
    version (every row) and the single kernel on the whole grid (owned
    rows), then timed on an interior block of 4."""
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    errs = {"fused_rv_block_step": {}, "tiled_rv_step_block": {}}
    vs_single = {"fused_rv_block_step": {}, "tiled_rv_step_block": {}}

    def kernels(ext, row0, abs_term, n1x, bkw, tile_rows):
        n1y = ext[0].shape[1]
        return {
            "fused_rv_block_step": lambda: fs.fused_rv_block_step(
                *ext, row0, abs_term, n_rows=n1x, n_cols=n1y, **bkw),
            "tiled_rv_step_block": lambda: ts.tiled_rv_step(
                *ext, row0_base=row0, n_rows=n1x, abs_term=abs_term,
                tile_rows=tile_rows, **bkw)}

    def compare(mesh, fields, Mc, kw, dn, n_blocks, which, tile_rows=None,
                single=True):
        u2 = fields[0]
        n1x = u2.shape[0]
        D = fs.required_halo(kw["cg_iters"], kw["newton_iters"],
                             kw["lin_iters"])
        blocks, L = _deep_halo_blocks(fields, Mc, n_blocks, D)
        abs_term = (u2 - u2.mean()).abs().max().reshape(1)
        whole = (fs.fused_rv_step(*fields, Mc, **kw)[0] if single else None)
        bkw = {k: v for k, v in kw.items() if k not in ("nx", "ny")}
        worst = {}
        for d in which:
            row0, ext = blocks[d]
            ref = fs.fused_rv_block_step_plain(
                *ext, row0, abs_term, n_rows=n1x, n_cols=u2.shape[1], **bkw)
            lo, hi = fs.block_rows(L + 2 * D, row0, n1x)
            own = slice(D, D + min(L, n1x - d * L))
            for name, fn in kernels(ext, row0, abs_term, n1x, bkw,
                                    tile_rows).items():
                out = fn()
                torch.cuda.synchronize()
                e = max_err(out, ref)
                if bool(out[:lo].any()) or bool(out[hi:].any()):
                    raise AssertionError(f"{name}: rows outside the grid "
                                         f"are not zero (block {d})")
                _gated(name, e, dn, errs[name])
                worst[name] = max(worst.get(name, 0.0), e)
                if single:
                    e1 = max_err(out[own], whole[d * L:d * L + own.stop - D])
                    _gated(f"{name} vs single kernel", e1, dn,
                           vs_single[name])
                    worst[name + " vs single"] = max(
                        worst.get(name + " vs single", 0.0), e1)
        log(f"block kernels mesh {mesh} {dn} {n_blocks} blocks (L {L}, D {D}),"
            f" blocks {list(which)}, {kw['stabilization']} frozen="
            f"{kw['freeze_jacobian']}: " + ", ".join(
                f"{k} {v:.3e}" for k, v in worst.items()))

    def cheby_kw(p, trimmed, **over):
        return dict(p.fused_step_kwargs(), inner_solver="cheby",
                    cg_iters=4 if trimmed else 10,
                    lin_iters=4 if trimmed else 16, newton_iters=2, **over)

    for mesh, n_blocks, which, tile_rows in ((16, 2, (0, 1), 8),
                                             (64, 4, (0, 1, 3), None)):
        p, *fields = states[mesh]
        for stab, frozen in (("rv", True), ("rv", False), ("gfem", True),
                             ("gfem", False)):
            compare(mesh, fields, p.sd.M_coef,
                    cheby_kw(p, mesh == 16, stabilization=stab,
                             freeze_jacobian=frozen),
                    "f64", n_blocks, which, tile_rows)
    p, *fields = states[256]
    compare(256, fields, p.sd.M_coef, cheby_kw(p, False), "f64", 4,
            (0, 1, 3))
    for mesh in (64, 256):
        p, f32, _ = _bench_f32(states[mesh])
        compare(mesh, f32[:4], f32[4], cheby_kw(p, False), "f32", 4,
                (0, 1, 3), single=False)

    # timed: interior block 1 of 4, f32, the sharded path's counts
    times = {}
    for mesh in (64, 128, 256, 512):
        p, f32, _ = _bench_f32(states[mesh])
        kw = cheby_kw(p, False)
        u2 = f32[0]
        n1x, n1y = u2.shape
        blocks, L = _deep_halo_blocks(f32[:4], f32[4], 4, 62)
        row0, ext = blocks[1]
        B = L + 124
        abs_term = (u2 - u2.mean()).abs().max().reshape(1)
        bkw = {k: v for k, v in kw.items() if k not in ("nx", "ny")}
        fns = kernels(ext, row0, abs_term, n1x, bkw, None)
        ops = step_ops(fs.step_args("", kw))
        t = dict(
            L=L, B=B, n1y=n1y,
            plain_ms=cuda_ms(lambda: fs.fused_rv_block_step_plain(
                *ext, row0, abs_term, n_rows=n1x, n_cols=n1y, **bkw), 2),
            single_whole_grid_ms=cuda_ms(
                lambda: fs.fused_rv_step(*f32, **kw), 10),
            bound=bound(12 * B * n1y * 4, B * n1y * ops, "f32"),
            bound_owned=bound(12 * L * n1y * 4, L * n1y * ops, "f32"))
        for name, fn in fns.items():
            t[name] = cuda_ms(fn, 20)
        times[mesh] = t
        log(f"block kernels mesh {mesh} f32, interior block of 4 (L {L}, B "
            f"{B}, {B * n1y * 4} B per field): fused_rv_block_step "
            f"{t['fused_rv_block_step']:.4f} ms, tiled_rv_step block mode "
            f"{t['tiled_rv_step_block']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms; bound over the {B} rows swept {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]}), over the {L} owned rows "
            f"{t['bound_owned'][0]:.5f} ms (B/L = {B / L:.3f}); the single "
            f"kernel on the whole grid, same configuration "
            f"{t['single_whole_grid_ms']:.4f} ms")
    for name, mesh, case in (
            ("fused_rv_block_step", 64, "block kernel by the auto rule"),
            ("tiled_rv_step_block", 256, "tiled block mode by the auto rule")):
        t = times[mesh]
        summary[name] = dict(
            max_abs_err=errs[name]["f64"],
            err_case="f64 one step against the plain version on every row: "
                     "mesh 16 (2 blocks, trimmed counts, 8-row tiles) and "
                     "64 (4 blocks) rv/gfem x frozen/fresh, mesh 256 (4 "
                     "blocks); first, interior and last block",
            max_abs_err_f32=errs[name]["f32"],
            f32_case="f32 mesh 64 and 256, 4 blocks, first/interior/last",
            vs_single_kernel_owned_rows_f64=vs_single[name]["f64"],
            ms=t[name], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=None,
            bound_ms_owned_rows=t["bound_owned"][0],
            rows_swept_over_owned=t["B"] / t["L"],
            timed_case=f"mesh-{mesh} f32 Chebyshev 10/2x16, interior block "
                       f"of 4, {t['B']} x {t['n1y']} ({case})",
            ms_by_mesh={str(m): times[m][name] for m in times},
            bound_ms_by_mesh={str(m): times[m]["bound"][0] for m in times},
            single_whole_grid_ms_by_mesh={
                str(m): times[m]["single_whole_grid_ms"] for m in times})


def run_sharded_path(mesh, T, n_blocks, kernel, expect, geometry, anchor,
                     card):
    """ShardedFusedStructured over LocalBlocks at full width, f32: the
    kernel chosen, exact launch counts of its own run, the range gate, and
    the single-device kernel path of the same configuration beside it."""
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.ops import _build
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedFusedStructured)

    extra = {} if T is None else dict(T=T)
    p = kpp.build(_sharded_cfg(kpp, mesh, "float32", **extra))
    sh = ShardedFusedStructured(p, LocalBlocks(n_blocks, "cuda"),
                                kernel=kernel)
    if (sh.kernel, (sh.L, sh.B), sh.D) != (expect, geometry, 62):
        raise AssertionError(
            f"sharded mesh {mesh} x {n_blocks}: kernel {sh.kernel}, L "
            f"{sh.L}, B {sh.B}, D {sh.D}; expected {expect}, {geometry}, 62")
    steps, n = p.num_steps, int(p.u0.numel())
    _build.launches.clear()
    u = sh.solve()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    name = ("fused_rv_block_step" if expect == "block"
            else "tiled_rv_step_block")
    if counts != {name: steps * n_blocks}:
        raise AssertionError(f"sharded mesh {mesh} x {n_blocks}: launched "
                             f"{counts}, expected {name}: {steps * n_blocks}")
    rel, lo, hi = _field_stats(u, mesh, anchor)
    u_again, us = _timed(sh.solve, steps)
    if not torch.equal(u_again, u):
        raise AssertionError(f"sharded mesh {mesh}: repeated solves differ")
    q = kpp.build(_sharded_cfg(kpp, mesh, "float32", use_kernels=True,
                               **extra))
    u_single, us_single = _timed_solve(q)
    rel_single, lo_single, hi_single = _field_stats(u_single, mesh, anchor)
    log(f"sharded path mesh {mesh} x {n_blocks} blocks ({sh.kernel} kernel, "
        f"L {sh.L}, B {sh.B}, {sh.B * sh.n1y * 4} B per field), f32 "
        f"Chebyshev 10/2x16, {steps} steps: launches {counts}; "
        f"{us:.1f} us/step, {n / us * 1e6:.4g} DOF-steps/s; single-device "
        f"{q._fused_mode()} kernel path {us_single:.1f} us/step "
        f"(ratio {us / us_single:.3f}; rows swept / rows owned "
        f"{sh.B / sh.L:.3f}); L2rel vs anchor sharded {rel:.4e}, single "
        f"device {rel_single:.4e}; max|sharded - single| "
        f"{max_err(u, u_single):.3e}; u in [{lo:.4f}, {hi:.4f}], single "
        f"device [{lo_single:.4f}, {hi_single:.4f}]; repeated solves "
        f"identical ({card})")
    if _in_range(lo_single, hi_single):
        if not _in_range(lo, hi):
            raise AssertionError(f"sharded mesh {mesh}: solution outside "
                                 f"the sanity range {SANITY_RANGE}")
    else:
        log(f"sharded path mesh {mesh}: this configuration leaves the "
            f"sanity range {SANITY_RANGE} on the single-device path too; "
            f"the sharded run's range is held to the single-device run's "
            f"within {SHARDED_RANGE_SLACK}")
        if not max(abs(lo - lo_single),
                   abs(hi - hi_single)) <= SHARDED_RANGE_SLACK:
            raise AssertionError(f"sharded mesh {mesh}: range [{lo}, {hi}] "
                                 f"against [{lo_single}, {hi_single}]")
    if not abs(rel - rel_single) <= SHARDED_VS_SINGLE:
        raise AssertionError(
            f"sharded mesh {mesh}: L2rel {rel:.4e} against the single "
            f"device's {rel_single:.4e}: further apart than "
            f"{SHARDED_VS_SINGLE}")
    return counts


def run_sharded_f64(mesh, n_blocks, kernel):
    """SHARDED_F64_STEPS steps in f64 through ``kernel`` against the single
    kernel, one fused_rv_step launch per step on the whole grid: the
    full-width correctness gate of the sharded path."""
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedFusedStructured)

    dt = 0.01 * min(1.0, 64.0 / mesh)
    cfg = _sharded_cfg(kpp, mesh, "float64", T=SHARDED_F64_STEPS * dt)
    p = kpp.build(cfg)
    if p.num_steps != SHARDED_F64_STEPS:
        raise AssertionError(f"{p.num_steps} steps")
    sh = ShardedFusedStructured(p, LocalBlocks(n_blocks, "cuda"),
                                kernel=kernel)
    u = sh.solve()
    u_single, _ = _single_kernel_solve(kpp.build(cfg))
    torch.cuda.synchronize()
    e = max_err(u, u_single)
    log(f"sharded path mesh {mesh} x {n_blocks} blocks ({sh.kernel} kernel) "
        f"f64, {SHARDED_F64_STEPS} steps: max|sharded - single kernel| = "
        f"{e:.3e} (gate {F64_TOL})")
    if not e <= F64_TOL:
        raise AssertionError(f"sharded f64 mesh {mesh} differs by {e}")


def run_process_group_path():
    """ProcessGroupBlocks on a one-rank NCCL group (file-store rendezvous in
    a temporary directory) against LocalBlocks(1), mesh 64, 5 steps, bit for
    bit. One card cannot host two NCCL ranks, so the exchange between ranks
    is held to LocalBlocks on the CPU (gloo) by the test suite, not here."""
    import datetime

    import torch
    import torch.distributed as dist

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.ops import _build
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ProcessGroupBlocks,
                                                     ShardedFusedStructured)

    cfg = _sharded_cfg(kpp, 64, "float32", T=0.05)
    local = ShardedFusedStructured(kpp.build(cfg), LocalBlocks(1, "cuda"))
    u_local = local.solve()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
            world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
        try:
            sh = ShardedFusedStructured(kpp.build(cfg),
                                        ProcessGroupBlocks(dist.group.WORLD))
            _build.launches.clear()
            u = sh.solve()
            torch.cuda.synchronize()
            counts = dict(_build.launches)
        finally:
            dist.destroy_process_group()
    same = torch.equal(u, u_local)
    log(f"ProcessGroupBlocks, one NCCL rank, mesh 64 f32, {local.p.num_steps}"
        f" steps ({sh.kernel} kernel): launches {counts}; equal to "
        f"LocalBlocks(1) bit for bit: {same}")
    if not same:
        raise AssertionError("ProcessGroupBlocks differs from LocalBlocks(1)")


def sharded_paths(card, counts, runs):
    """The sharded path's runs; each kernel's launch count, and the run it
    comes from, go into counts and runs."""
    for mesh, T, n_blocks, kernel, expect, geometry, anchor in SHARDED_PATHS:
        c = run_sharded_path(mesh, T, n_blocks, kernel, expect, geometry,
                             anchor, card)
        run = (f"sharded path mesh {mesh} x {n_blocks} blocks, f32 Chebyshev"
               + ("" if T is None else f", T = {T}"))
        for name, k in c.items():
            counts.setdefault(name, k)
            runs.setdefault(name, run)
    for mesh in (64, 256):
        for kernel in ("block", "tiled"):
            run_sharded_f64(mesh, 4, kernel)
    run_process_group_path()


def _busy_us(events):
    """Microseconds covered by the union of the events' time ranges."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_share(mesh):
    """Device idle share of a 20-step kernel-path solve: under
    torch.profiler (union of the kernels' spans over the host's wall
    time) and without it (1 - steps x back-to-back step time / solve time
    on CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conservation_fem_tpu_torch.models import kpp

    dt = 0.01 * min(1.0, 64.0 / mesh)
    p = kpp.build(_bench_cfg(kpp, mesh, "float32", use_kernels=True,
                             T=20 * dt), device="cuda")
    u = p.solve().u
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.solve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels)
    _, us_step = _timed_solve(p)
    step_ms = cuda_ms(lambda: p._step_fused((u, u, u), p.dt), 20)
    return dict(mode=p._fused_mode(), profiled_wall_us=wall_us,
                profiled_device_busy_us=busy,
                profiled_idle=1.0 - busy / wall_us,
                device_kernels=len(kernels), solve_us_per_step=us_step,
                step_ms_back_to_back=step_ms,
                unprofiled_idle=1.0 - step_ms * 1e3 / us_step)


def ablate(card):
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = dict(card=card, clocks=clocks)
    for mesh in (64, 128, 256, 512):
        state = mid_trajectory_state(mesh)
        p, f32, base = _bench_f32(state)
        rows = {}
        if mesh in (64, 256):
            for name, change in ABLATIONS:
                kw = dict(base, **change)
                rows[name] = cuda_ms(lambda: fs.fused_rv_step(*f32, **kw), 50)
            rows["n_substeps=10, per step"] = cuda_ms(
                lambda: fs.fused_rv_step(*f32, n_substeps=10, **base), 10) / 10
        else:
            rows["full"] = cuda_ms(lambda: fs.fused_rv_step(*f32, **base), 20)
        if mesh >= 256:
            # the tiled kernel by rows per tile, beside the single kernel
            for tr in TILE_ROWS:
                rows[f"tiled, {tr}-row tiles"] = cuda_ms(
                    lambda: ts.tiled_rv_step(*f32, tile_rows=tr, **base), 10)
        torch.cuda.synchronize()
        for name, ms in rows.items():
            log(f"ablate mesh {mesh} {name}: {ms:.5f} ms "
                f"({ms / rows['full']:.1%} of the full single step)")
        idle = idle_share(mesh)
        log(f"idle mesh {mesh}: {idle}")
        out[str(mesh)] = dict(step_ms=rows, idle=idle)
    return out


def main(argv):
    card = phase_device()
    import torch

    phase_build()
    if argv[1:] == ["--ablate"]:
        log(card)
        log(json.dumps({"ablation": ablate(card)}))
    elif argv[1:]:
        raise SystemExit(f"usage: {argv[0]} [--ablate]")
    else:
        smoke(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def smoke(card):
    summary, states = {}, {}
    check_stencil_matvec(summary)
    check_cg_solve(summary)
    for mesh in (16, 64, 128, 256, 512):
        states[mesh] = mid_trajectory_state(mesh)
    check_fused_step(summary, states)
    check_split(summary, states)
    check_tiled(summary, states)
    check_block_kernels(summary, states)
    states.clear()
    counts, runs = {}, {}
    for mesh, T, mode, anchor in MAIN_PATHS:
        c = run_main_path(mesh, T, mode, anchor, card)
        run = (f"mesh-{mesh} f32 bench config"
               + ("" if T is None else f", T = {T}") + f" ({mode})")
        for name, k in c.items():
            counts.setdefault(name, k)
            runs.setdefault(name, run)
    adaptive_counts = run_adaptive_path(64)
    counts["cg_solve"] = adaptive_counts.get("cg_solve", 0)
    runs["cg_solve"] = f"mesh-64 adaptive f64 config, {ADAPTIVE_STEPS} steps"
    runs["stencil_matvec"] = "none: no main path launches it"
    sharded_paths(card, counts, runs)
    # name: (source, TPU kernel it replaces)
    sources = {
        "stencil_matvec": ("stencil.cu", "ops/pallas_stencil.py:40"),
        "cg_solve": ("stencil.cu", "ops/pallas_stencil.py:64"),
        "fused_rv_step": ("fused_step.cu", "ops/pallas_fused.py:416"),
        "split_setup": ("split_step.cu", "ops/pallas_fused.py:585"),
        "split_newton": ("split_step.cu", "ops/pallas_fused.py:634"),
        "tiled_rv_step": ("tiled_step.cu", "ops/pallas_tiled.py:120"),
        "tiled_rv_step_block": ("tiled_step.cu", "ops/pallas_tiled.py:135"),
        "fused_rv_block_step": ("block_step.cu", "ops/pallas_fused.py:491"),
    }
    rows = []
    for name, (src, tpu) in sources.items():
        rows.append(dict(
            name=name, route="cuda",
            source=f"conservation_fem_tpu_torch/csrc/{src}",
            replaces=f"conservation_fem_tpu/{tpu}",
            launches=counts.get(name, 0), launches_run=runs[name],
            **summary[name]))
    log(f"smoke run: {time.perf_counter() - T_START:.0f} s in all")
    log(card)
    log(json.dumps({"kernels": rows}))


if __name__ == "__main__":
    sys.exit(main(sys.argv))
