"""Drive the PyTorch + CUDA port (conservation_fem_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --ablate   # the step ablation and idle share
    python3 chip_smoke.py --against DIR   # the single and block kernels
                                          # against another tree's, in turns

Phases of the smoke run, in order; any failure raises and the process
exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), TF32 flags;
     no CUDA device -> error;
  2. build: compile csrc/*.cu with nvcc, one process per source (seconds,
     and registers per thread, spill stores and static shared memory of
     each kernel instance printed);
  3. each hand-written kernel against its plain PyTorch version on the card,
     numpy-seeded inputs or a mid-trajectory state (32 steps of the plain
     f64 bench path): stencil_matvec (257^2, 1025^2; f32, f64; timed on a
     CUDA graph beside the same operator as a torch CSR matrix, from a cold
     L2 at 1025^2 and 2049^2, and beside an empty kernel's launch),
     cg_solve in both instances (the mass stencils of Burgers mesh 50 and
     100 and KPP mesh 64 and 256, f64 and f32: the wrapper's plan, and the
     grid instance forced where the plan is a cluster; timed with its
     iterations, plan and bound, beside forced cluster sizes),
     fused_rv_step (mesh 16, 64, 256), the
     tiled kernel against its plain version and the single kernel (mesh 16
     with 8-row tiles: cheby and bicgstab, frozen and fresh Jacobian, odd
     Newton counts, gfem; mesh 256 f64; mesh 256 and 512 f32, timed in
     turns with the single kernel on the same state, with the tile plan,
     registers, spills, shared memory and resident blocks, the sweeps per
     step and the bytes they must move), the split setup and Newton
     kernels (the Newton kernel with both values of relinearize and
     residual) against their plain stages and the whole split step
     against the tiled kernel on the same plan and the single kernel (f64
     mesh 16 with 8-row tiles in four solver cases, mesh 64 default plan;
     f32 mesh 128), timed at mesh 128 f32 in turns with the tiled and
     single kernels (each split kernel's plan, registers, spills, shared
     memory and sweep floor), and the tiled kernel at mesh 64 in turns
     with the single kernel. f64 is gated at 1e-11 (1e-10 for the tile
     pipeline's kernels, tiled and split: the JAX package's bound for its
     tiled BiCGStab kernel), f32 at 1e-4;
  4. the main paths through kpp.build(..., use_kernels=True).solve(), f32
     bench config (bench.py:_config), each gated at L2rel <= 1e-2 against
     its committed f64 anchor and u in [0.5, 12], with the launch counts
     zeroed just before the kernel-path solve and read just after it: mesh
     64 (100 steps, single kernel), mesh 128 (200 steps, split), mesh 256
     (400 steps, tiled), mesh 512 to T = 0.1 (80 steps, tiled); beside each,
     the single-kernel path (and at mesh 128 the tiled-kernel path) of the
     same trajectory, the plain-torch composed path (gated, timed) and the
     unprofiled device
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
     and 512 (both in turns, their ratio, the tiled kernel's plan and sweep
     floor). Then the path itself through kpp.build(cfg) and
     ShardedFusedStructured(p, LocalBlocks(n, "cuda")).solve(), f32, the
     Chebyshev configuration (SHARDED below), launch counts zeroed just
     before each solve and read just after: SHARDED_PATHS, each beside the
     single-device kernel path of the same configuration and gated against
     it (L2rel against the anchor within 1e-3 of each other — this
     configuration alone misses the 1e-2 anchor gate from mesh 64 up on
     any path, so that gate is printed, not applied; u in [0.5, 12], or,
     where the sharded and the single-device run both leave that range,
     min and max within 1e-2 of its); the same in f64
     for 5 steps at mesh 64 and 256, through either kernel, against the
     single kernel (1e-11); and one
     ProcessGroupBlocks run on a one-rank NCCL group against LocalBlocks(1),
     bit for bit;
  6. Burgers (models/burgers.py) through the step kernels' Burgers
     instances (csrc/*_burgers.cu): (a) each instance against its plain
     version with the Burgers flux from a state 30 steps in (single kernel
     at mesh 64, split at 128, tiled at 256, the block kernel and tiled
     block mode on 64 x 4 blocks; f64 two solver cases, f32), then timed
     at its main path's shape (f32 single 200, split 400, tiled 800, an
     interior block of 64 x 4); (c) the f64 reference config with
     use_kernels (cg_solve): mesh 50 against the reference's last frame
     (1e-9), mesh 100's L1 and L2 errors against the JAX package's (1e-3
     relative: BURGERS_ERR_RTOL); (d) the fixed-iteration config through
     burgers.build(...).solve() at mesh 200, 400, 800 in f32 (single,
     split, tiled) and f64 (split, tiled, tiled), launch counts of each run
     against the JAX package's step counts, errors against the exact
     solution, µs/step, the idle share at mesh 200 f32, f32 within 1e-2 of
     f64 and the f64 L1 error falling with the mesh; (e) one sharded f64
     run at mesh 64 x 4 per block-mode kernel against the single-device
     kernel path (1e-11).
The second-to-last line is the per-kernel JSON summary (all eight ported
kernels, each with its bound; a step kernel's row also holds its Burgers
instance's numbers under "burgers"; cg_solve's row the plan, iterations
and times of each shape it was checked at, both instances' registers and
spills, and the launches of the Burgers reference runs); the last line is
{"ok": true, "device": {...}}.

The ablation (--ablate) first times the single kernel at mesh 64 and
256, f32 bench config, in turns with its instances that leave out one
element of its band design (csrc/band_sweep.cuh BandDesign: staged
planes, shuffle reductions, quadrature per triangle) or all three
(ops/fused_step.BAND_ABLATIONS; built into a library of their own,
ops/_build.ablate_lib), and the block kernel on the interior blocks of 64
x 4 and 512 x 4 (Chebyshev 10 / 2 x 16) in turns with its instances
(BLOCK_ABLATIONS); then times one fused_rv_step
launch, f32 bench config, from the mid-trajectory state at mesh 64 and
256, with one keyword
argument of the wrapper changed per variant (ABLATIONS; the kernel source
is the same for all), and the split step at mesh 128 with each variant;
times the tiled kernel at mesh 128, 256 and 512, and the split step at
mesh 128, with 8, 16, 32 and 64 rows per tile beside the single kernel
(each with its columns, tiles, rounds and resident blocks), the tiled
kernel at mesh 256 and 512 with each variant of ABLATIONS; and reads the
device's idle share over a 20-step solve of each main path (mesh 64, 128,
256, 512), with and without torch.profiler.

--against DIR times the single and block kernels and cg_solve of the
tree in DIR (an unpacked earlier commit) and of this one in turns, DIR,
this, this, DIR, twice, one process each (scripts/torch_kernel_times.py:
fused_rv_step at KPP mesh 64 and Burgers mesh 200 in f32,
fused_rv_block_step on the interior blocks of KPP and Burgers mesh 64 x 4;
off the main paths, fused_rv_step at KPP mesh 256 and fused_rv_block_step
on the interior block of KPP 512 x 4; cg_solve on the f64 mass solves of
the Burgers reference config at mesh 50 and 100 and of the KPP adaptive
config at mesh 64 and 256, and that of mesh 256 in f32), and prints each
case's times and the ratio this / DIR.
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
# cg_solve's shapes: (label, model, mesh, f64 rtol): the mass solves of the
# Burgers f64 reference config (rtol 1e-12) at mesh 50 and 100 and of the
# KPP adaptive f64 config at mesh 64 (timed at 1e-10, as before), and at
# mesh 256, whose bands do not fit shared memory (the grid instance not
# resident); the cluster sizes timed at each Burgers shape where they hold
# its state
CG_CASES = (("burgers 51x51", "burgers", 50, 1e-12),
            ("burgers 101x101", "burgers", 100, 1e-12),
            ("kpp 257x257", "kpp", 64, 1e-10),
            ("kpp 1025x1025", "kpp", 256, 1e-10))
CG_CLUSTER_SIZES = (2, 4, 8, 16)
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
# A sharded run must stay in SANITY_RANGE. Where it leaves it and the
# single-device path of this configuration leaves it too (mesh 512, T =
# 0.1: min u 0.493 on every path, the anchor's is 0.588), its min and max
# are held to the single-device run's within this much instead. (In f32
# the two runs reduce in different orders, and the shock problem grows
# that into differences of ~0.6 per node: at mesh 256 the single-device
# tiled path has dipped to 0.496 while the sharded run stayed at 0.561.)
SHARDED_RANGE_SLACK = 1e-2
SHARDED_F64_STEPS = 5
# Burgers (models/burgers.py). The fixed-iteration config of the JAX
# package's fused Burgers test (tests/test_pallas_fused.py:152-155; RV,
# bicgstab, T 0.5 from BurgersConfig), and the sharded Chebyshev config of
# SHARDED with Burgers' P1 Chebyshev bounds (the config's defaults).
BURGERS_FIXED = dict(stabilization="rv", cg_iters=10, newton_iters=2,
                     newton_linear_iters=8, modified_newton=True)
BURGERS_SHARDED = dict(inner_solver="cheby", newton_linear_iters=16)
# steps of the sharded f64 gate (dt = 1/128 at mesh 64): as SHARDED_F64_STEPS
# for KPP, a few steps, since the two paths sum in other orders and the
# shocks grow that (the plain versions on the CPU: 1.7e-11 apart after the
# 64 steps to T = 0.5)
BURGERS_SHARDED_STEPS = 10
BURGERS_STATE_STEPS = 30   # steps before the kernels' mid-trajectory state
BURGERS_GOLDEN_TOL = 1e-9  # tests/test_golden_parity.py:184-191, mesh 50
# The JAX package's errors of the f64 reference config at mesh 100 (101
# steps) against the exact solution at t = 0.5, f64 on the CPU:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu');
#   jax.config.update('jax_enable_x64', True);
#   from conservation_fem_tpu.models import burgers as b;
#   p = b.build(b.BurgersConfig(mesh_size=100)); r = p.solve();
#   print(r.num_steps, repr(float(b.l1_error_vs_exact(p, r.u, 0.5))),
#   repr(float(b.l2_error_vs_exact(p, r.u, 0.5))))"
BURGERS_JAX_MESH100 = dict(num_steps=101, l1=0.019605069883847758,
                           l2=0.0946557754120581)
# This config amplifies roundoff ~1e13-fold over mesh 100's 101 steps (the
# RV n_i switch on the shocks): the JAX package's own scan solve and its
# step jitted and chained end 9.3e-3 apart, their L1 errors 3.1e-4
# relative apart (scripts/burgers_roundoff_growth.py, CPU f64). No other
# summation order can hold these errors to 1e-9; the gate is 1e-3 relative,
# about 3x the JAX package's own spread. Mesh 50 grows too little to show:
# its gate is the golden frame's 1e-9.
BURGERS_ERR_RTOL = 1e-3
BURGERS_F32_VS_F64 = 1e-2  # L2rel of an f32 run against f64, same mesh
# (mesh, dtype, the kernel _fused_mode must pick): 201 x 201 f32 is 161,604
# B per field (single), 401 x 401 643,204 B (split), 801 x 801 beyond
BURGERS_PATHS = ((200, "float32", "single"), (400, "float32", "split"),
                 (800, "float32", "tiled"), (200, "float64", "split"),
                 (400, "float64", "tiled"), (800, "float64", "tiled"))

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
# not the work's. The flux's own operations per quadrature point: KPP a sin
# and a cos; Burgers none (f' = (u, u), f'' = (1, 1) are free).
FLUX_POINT_OPS = {"kpp": 2, "burgers": 0}
OPS_STENCIL = 13                        # stencil_apply: 7 mul + 6 add
OPS_CG_ITER = OPS_STENCIL + 13          # M p, 2 dots, x, r, z, p
OPS_CHEBY_ITER = OPS_STENCIL + 6        # A d, x, r, d
OPS_PLANES = 2 * 3 + 6 * 3 * 2 + OPS_STENCIL   # cell-mean eps per triangle,
#   7 planes per corner, K u
OPS_BICG_ITER = 2 * OPS_STENCIL + 22    # J phat, J shat, 4 dots, s, shat,
#   x, r, p, phat


def flux_ops(flux):
    """{part: operations per node} of the parts that depend on the flux
    (a key of FLUX_POINT_OPS)."""
    c = FLUX_POINT_OPS[flux]
    # nl_rhs_node: per triangle the gradient (10) and per quadrature point
    # its value (5), the flux's own operations and f'(u_q) . grad u (3);
    # per corner 6 weighted sums (2 each) + 2
    nl = 2 * (10 + 6 * (8 + c)) + 6 * (6 * 2 + 2)
    # conv_planes_node: per triangle and quadrature point as nl plus the 3
    # terms fg phi_b + fx G_b0 + fy G_b1 (5 each); per corner 3 weighted sums
    conv = 2 * (10 + 6 * (8 + c + 3 * 5)) + 6 * 3 * (6 * 2 + 2)
    return dict(
        proj_rhs=5 + OPS_STENCIL + nl + 6,   # du, M du, N(u), rhs, z, dots
        # max|u - mean|, patch max/min/|RH|, eps; Burgers' patch max |u|
        # (7 abs, 6 max) and its speed sqrt(2) max|u| Cvel h (2)
        rv=3 + 6 * 5 + 8 + (15 if flux == "burgers" else 0),
        f=7 + 2 * OPS_STENCIL + nl + 5,      # F(uk): M (uk - u), N(uk), K uk
        lin=conv + 22)                       # J = M + dt/2 (K + C), 1 / J_00


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
# what tiled_facts reports of the tiled kernel's plan and occupancy
TILED_FACT_KEYS = ("tile_rows", "tile_cols", "tiles", "blocks", "rounds",
                   "resident_blocks", "blocks_per_sm", "smem_per_block",
                   "registers", "spill_stores", "local_bytes")


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
    kernel's registers per thread, spill stores and static shared memory
    (a step kernel's Burgers instance as "<kernel> burgers <dtype>")."""
    import re

    from conservation_fem_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)
    if "registers" not in _build.build_log:   # built without ptxas -v
        _build.build(verbose=True, force=True)
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    regs, name = {}, None
    for line in _build.build_log.splitlines():
        m = re.search(r"entry function '_ZN3cft\d+(\w+?)_kernelI([fd])"
                      r"(?:NS_\d+(Kpp|Burgers)E)?(?:Li(\d+)E)?", line)
        if m:
            flux = " burgers" if m.group(3) == "Burgers" else ""
            design = ("" if m.group(4) in (None, "7")
                      else f" design {m.group(4)}")
            name = (f"{m.group(1)}{flux} "
                    f"{'f32' if m.group(2) == 'f' else 'f64'}{design}")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            regs.setdefault(name, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs.setdefault(name, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            regs[name]["static_smem"] = int(m.group(1)) if m else 0
            name = None
    log(json.dumps({"registers_per_thread": regs}))
    return regs


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


def step_ops(s, part="step", relinearize=True, residual=True):
    """Operations per node of one whole step (part "step"), of the split
    setup ("setup") or of one split Newton launch ("newton", with its two
    keywords); s: the step's keyword arguments (the flux among them)."""
    fo = flux_ops(s["flux"].name)
    cheby = s["inner_solver"] == "cheby"
    head = (fo["proj_rhs"]
            + s["cg_iters"] * (OPS_CHEBY_ITER if cheby else OPS_CG_ITER)
            + (fo["rv"] if s["stabilization"] == "rv" else 0) + OPS_PLANES)
    newton = s["lin_iters"] * (OPS_CHEBY_ITER if cheby else OPS_BICG_ITER) + 1
    if part == "setup":
        return head + fo["f"]
    if part == "newton":
        return (fo["lin"] if relinearize else 0) + newton + (
            fo["f"] if residual else 0)
    n_lin = 1 if s["freeze_jacobian"] else s["newton_iters"]
    return head + s["newton_iters"] * (fo["f"] + newton) + n_lin * fo["lin"]


def head_sweeps(s, residual):
    """[(values read, values written) per node] of the sweeps of a step up
    to uk0 (and F(uk0) if residual): the split setup launch."""
    cheby = s["inner_solver"] == "cheby"
    sweeps = [((3 if s["residual_scheme"] == "bdf2" else 2) + 7, 4)]
    for it in range(s["cg_iters"]):
        if cheby:                  # d | x, r | M -> x, r, d'
            sweeps.append((1 + 2 + 7, 3))
        else:                      # p (r, M_00 after the first) | M -> p, q
            sweeps.append((1 + 7, 1) if it == 0 else (3 + 7, 2))
    if s["stabilization"] == "rv":
        sweeps.append((2, 1))      # u, RH -> eps
    # eps, u, g (N(u), M for F0) -> Kc, K u, uk0 (F0)
    sweeps.append((3 + 8, 10) if residual else (3, 9))
    return sweeps


def newton_sweeps(s, relinearize, residual):
    """The sweeps of one Newton iteration (one split Newton launch): the
    linearisation if relinearize, the inner solve, the update with its
    residual if residual (otherwise a pointwise pass, not a sweep)."""
    cheby = s["inner_solver"] == "cheby"
    sweeps = []
    if relinearize:                # w | F | M, Kc -> J, dJinv, x, r, d (rhat)
        sweeps.append((2 + 14, 11 if cheby else 12))
    for li in range(s["lin_iters"]):
        if cheby:                  # d | x, r, dJinv | J -> x, r, d'
            sweeps.append((1 + 3 + 7, 3))
        else:                      # dJinv, p (r, v) | rhat | J -> (p), v
            sweeps.append((2 + 1 + 7, 1) if li == 0 else (4 + 1 + 7, 2))
            sweeps.append((3 + 7, 2))   # dJinv, r, v | J -> s, t
    if residual:                   # uk, dx, u | N(u), K u, g | M, Kc
        sweeps.append((3 + 3 + 14, 2))
    return sweeps


def sweep_count(sweeps):
    """(sweeps, values per node they must move)."""
    return len(sweeps), sum(r + w for r, w in sweeps)


def tiled_sweeps(s):
    """(sweeps, values per node) of one step of the tiled kernel: the
    sweeps csrc/fused_step.cuh StepPhases runs for the step's keyword
    arguments s, and the values per node they must move — what each one's
    Reads declares (fields at neighbours and at the node, 7 per operator)
    and the fields it writes (7 per operator), each once per sweep; the
    per-sweep floor is those bytes over the HBM rate. The split step runs
    the same sweeps, cut at its launches (head_sweeps, newton_sweeps)."""
    newton = s["newton_iters"]
    sweeps = head_sweeps(s, newton > 0)
    for it in range(newton):
        sweeps += newton_sweeps(s, it == 0 or not s["freeze_jacobian"],
                                it + 1 < newton)
    return sweep_count(sweeps)


# the ptxas name of each kernel that runs the tile pipeline
PTXAS_NAMES = {"tiled": "tiled_rv_step", "split_setup": "split_setup",
               "split_newton": "split_newton"}


def plan_facts(n1x, n1y, dtype, regs, kernel="tiled", tile_rows=None,
               flux="kpp"):
    """A tile-pipeline kernel's plan on the card (card_plan over n1x x n1y)
    and what the card gives it, its instance for flux: registers, spills,
    shared memory, resident blocks."""
    import torch

    from conservation_fem_tpu_torch.ops import _build
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = ts.card_plan(n1x, n1y, dtype, tile_rows, kernel=kernel, flux=flux)
    info = ts.occupancy(dtype, plan["smem"],
                        kernel=_build.launch_key(kernel, flux))
    if info["max_dynamic_smem"] < ts.smem_budget(itemsize):
        raise AssertionError(f"the card gives a block of {kernel} "
                             f"{info['max_dynamic_smem']} bytes of dynamic "
                             f"shared memory, the plan assumes "
                             f"{ts.smem_budget(itemsize)}")
    dn = "f32" if itemsize == 4 else "f64"
    return dict(
        tile_rows=plan["rows"], tile_cols=plan["cols"], tiles=plan["tiles"],
        blocks=plan["blocks"], rounds=plan["rounds"],
        smem_per_block=plan["smem"] + info["static_smem"],
        blocks_per_sm=info["blocks_per_sm"],
        resident_blocks=plan["resident"], registers=info["registers"],
        local_bytes=info["local_bytes"],
        spill_stores=regs.get(
            f"{PTXAS_NAMES[kernel]}{'' if flux == 'kpp' else ' ' + flux} "
            f"{dn}", {}).get("spill_stores", 0))


def floor_facts(sweeps, n, itemsize):
    """(sweeps, values per node) as the bytes they must move over n nodes
    and that over the HBM rate."""
    count, values = sweeps
    return dict(sweeps=count, sweep_bytes=values * n * itemsize,
                sweep_floor_ms=values * n * itemsize / HBM_BYTES_PER_S * 1e3)


def tiled_facts(kw, n1x, n1y, n, dtype, regs):
    """The tiled kernel's plan on the card (card_plan over n1x x n1y, n
    nodes swept), what the card gives it (registers, spills, shared
    memory, resident blocks) and its sweeps with their byte floor."""
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs

    itemsize = torch.empty((), dtype=dtype).element_size()
    floor = floor_facts(tiled_sweeps(fs.step_args("", kw)), n, itemsize)
    return dict(plan_facts(n1x, n1y, dtype, regs),
                sweeps_per_step=floor["sweeps"],
                sweep_bytes=floor["sweep_bytes"],
                sweep_floor_ms=floor["sweep_floor_ms"])


# the band kernels' timed shapes: name -> (KPP shape, Burgers shape), f32,
# every row of each buffer in the grid (interior blocks)
BAND_SHAPES = {"fused_rv_step": ((257, 257), (201, 201)),
               "fused_rv_block_step": ((189, 257), (141, 65))}


def band_facts(name, regs):
    """The band plan of a band kernel (ops/fused_step.band_plan) at its
    timed shapes, KPP and Burgers, f32, and what ptxas gave each instance:
    registers, spill stores, static shared memory."""
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for flux, shape in zip(("kpp", "burgers"), BAND_SHAPES[name]):
        plan = fs.band_plan(*shape, 4, sms)
        tag = "" if flux == "kpp" else " burgers"
        out[flux] = dict(
            shape=list(shape), **{k: plan[k] for k in (
                "ctas", "cap", "staged", "chunk", "quad_cells", "smem")},
            ptxas={dn: regs.get(f"{name}{tag} {dn}") for dn in ("f32",
                                                                  "f64")})
        for dn, info in out[flux]["ptxas"].items():
            _no_spill(f"{name}{tag} {dn}", info)
    return out


def _no_spill(kernel, info):
    """Raise unless ptxas reported kernel (info: its registers line) and it
    spills nothing."""
    if info is None or info.get("spill_stores", 0):
        raise AssertionError(f"{kernel}: ptxas reports {info} (a band "
                             "kernel or cg_solve instance must not spill)")


def cg_facts(regs):
    """What ptxas gave each cg_solve instance, f32 and f64 (registers,
    spill stores, static shared memory); raises where one spills."""
    out = {}
    for inst in ("cluster", "grid"):
        for dn in ("f32", "f64"):
            info = regs.get(f"cg_{inst} {dn}")
            _no_spill(f"cg_solve {inst} {dn}", info)
            out[f"{inst} {dn}"] = info
    return out


def _alternated(fns, reps):
    """{name: mean ms} of each of fns timed twice, in the order a, b, ...,
    b, a (CUDA events), so drift hits every one alike."""
    order = list(fns) + list(fns)[::-1]
    got = {}
    for name in order:
        got.setdefault(name, []).append(cuda_ms(fns[name], reps))
    return {name: sum(v) / len(v) for name, v in got.items()}


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
    cold = stencil_matvec_cold(errs)
    t = times[257]
    summary["stencil_matvec"] = dict(
        max_abs_err=errs["f64"], err_case="f64, 257x257 and 1025x1025",
        max_abs_err_f32=errs["f32"], f32_case="f32, 257x257 and 1025x1025",
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
        bound_by=t["bound"][1], library_ms=t["library_ms"],
        timed_case="257x257 f32 (the mesh-64 grid); kernel and library "
                   "(torch CSR SpMV) each on a CUDA graph of 100 calls",
        host_ms_per_call=t["host_ms"], ms_1025=times[1025]["ms"],
        library_ms_1025=times[1025]["library_ms"], **cold)


def stencil_matvec_cold(errs):
    """stencil_matvec from a cold L2, f32: on a CUDA graph of calls that
    rotate over sets of inputs (7 planes and x, each set read once in
    turn) that together exceed the 50 MB L2 (1025^2: 3 sets of 33.6 MB;
    2049^2: 2 sets of 134 MB), beside the warm reading on one set, the
    bound and an empty kernel's launch on a CUDA graph (the launch floor
    beside the 257^2 reading). Gated against the plain version on one
    set at 2049^2."""
    import itertools

    import torch

    from conservation_fem_tpu_torch.ops import _build
    from conservation_fem_tpu_torch.ops import stencil_kernels as sk

    out = {}
    for n1, copies in ((1025, 3), (2049, 2)):
        gen = torch.Generator("cuda").manual_seed(n1)
        sets = [(torch.randn((7, n1, n1), generator=gen, device="cuda"),
                 torch.randn((n1, n1), generator=gen, device="cuda"))
                for _ in range(copies)]
        if n1 == 2049:
            e = max_err(sk.stencil_matvec(*sets[0]),
                        sk.stencil_matvec_plain(*sets[0]))
            log(f"stencil_matvec 2049^2 f32: max|kernel-plain| = {e:.3e}")
            _gated("stencil_matvec", e, "f32", errs)
        turn = itertools.cycle(sets)
        cold_ms = graph_ms(lambda: sk.stencil_matvec(*next(turn)))
        warm_ms = graph_ms(lambda: sk.stencil_matvec(*sets[0]))
        b_ms = bound(9 * n1 * n1 * 4, OPS_STENCIL * n1 * n1, "f32")[0]
        out.update({f"cold_ms_{n1}": cold_ms, f"warm_ms_{n1}": warm_ms,
                    f"bound_ms_{n1}": b_ms})
        log(f"stencil_matvec {n1}^2 f32 on a CUDA graph: L2-cold "
            f"({copies} input sets in turn) {cold_ms:.5f} ms, warm (one "
            f"set) {warm_ms:.5f} ms, bound {b_ms:.5f} ms: cold reaches "
            f"{b_ms / cold_ms:.1%} of the bound")
        del sets, turn
    lib = _build.lib()
    out["launch_floor_ms"] = graph_ms(lambda: _build.check(
        lib.cft_empty_launch(torch.cuda.current_stream().cuda_stream),
        "empty kernel"))
    log(f"an empty kernel of one warp on a CUDA graph: "
        f"{out['launch_floor_ms']:.5f} ms (the launch floor)")
    out["cold_case"] = ("f32 on a CUDA graph of 100 calls rotating over "
                        "input sets beyond the 50 MB L2")
    return out


def cg_bound(n, iters, dn):
    """(bound_ms, bound_by) of a cg_solve on n nodes: coef, b, diag and x
    once and the bool mask; per iteration the pinned matvec and 2 dots, x,
    r, z, p (OPS_CG_ITER)."""
    size = 8 if dn == "f64" else 4
    return bound(n * (10 * size + 1), n * iters * OPS_CG_ITER, dn)


def _plan_row(plan):
    return {k: plan[k] for k in ("instance", "ctas", "cap", "resident",
                                 "smem")}


def check_cg_solve(summary):
    """Both instances of cg_solve against the plain version at the shapes
    that launch it (CG_CASES; b = M x_true, x_true ~ N(0, 1) on the
    interior, so the absolute bound is a relative one): the wrapper's own
    plan, and at a cluster shape the grid instance forced too; then, in
    f64 and at the KPP shapes in f32 too, each timed with its iterations,
    plan and bound, and in f64 with the cluster sizes of CG_CLUSTER_SIZES
    that hold the state forced."""
    import torch

    from conservation_fem_tpu_torch.models import burgers, kpp
    from conservation_fem_tpu_torch.ops import stencil_kernels as sk

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_kernel_times as kernel_times

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs, shapes = {}, {}
    for label, model, mesh, rtol64 in CG_CASES:
        for dtype, dn, rtol in (("float64", "f64", rtol64),
                                ("float32", "f32", 1e-5)):
            if model == "kpp":
                p = kpp.build(kpp.KPPConfig(mesh_size=mesh, dtype=dtype,
                                            T=0.0), device="cuda")
            else:
                p = burgers.build(burgers.BurgersConfig(mesh_size=mesh,
                                                        dtype=dtype),
                                  device="cuda")
            sd = p.sd
            rng = np.random.default_rng(mesh)
            x_true = torch.tensor(rng.normal(size=sd.bc2.shape),
                                  dtype=p.dtype, device="cuda")
            x_true = torch.where(sd.bc2, 0.0, x_true)
            b = torch.where(sd.bc2, 0.0,
                            sk.stencil_matvec_plain(sd.M_coef, x_true))
            args = (sd.M_coef, b, sd.bc2, sd.diagM2)
            n1 = b.shape[0]
            plan = sk.card_cg_plan(b.device, n1, n1, p.dtype)
            plans = {plan["instance"]: plan}
            if plan["instance"] == "cluster":
                plans["grid"] = sk.cg_plan(n1, n1, b.element_size(), sms,
                                           instance="grid")
            x0 = sk.cg_solve_plain(*args, rtol=rtol)
            for inst, pl in plans.items():
                x = sk.cg_solve(*args, rtol=rtol, plan=pl)
                torch.cuda.synchronize()
                e = max_err(x, x0)
                ax = sk.stencil_matvec_plain(sd.M_coef,
                                             torch.where(sd.bc2, 0.0, x))
                res = float(torch.where(sd.bc2, 0.0, b - ax).norm()
                            / b.norm())
                log(f"cg_solve {label} {dn} rtol {rtol}, {inst} instance "
                    f"({pl['ctas']} CTAs): max|kernel-plain| = {e:.3e}, "
                    f"kernel relative residual {res:.2e}")
                _gated("cg_solve", e, dn, errs)
                if not res <= 10 * rtol:
                    raise AssertionError(f"cg_solve {label} {dn} {inst} "
                                         f"residual {res}")
            key = f"{label} {dn}"
            if dn == "f64" or model == "kpp":
                iters = kernel_times.plain_iterations(
                    sk, lambda: sk.cg_solve_plain(*args, rtol=rtol))
                times = {f"{inst} ({pl['ctas']} CTAs)": cuda_ms(
                    lambda pl=pl: sk.cg_solve(*args, rtol=rtol, plan=pl), 20)
                    for inst, pl in plans.items()}
                if dn == "f64":
                    for C in CG_CLUSTER_SIZES:
                        try:
                            pl = sk.cg_plan(n1, n1, 8, sms,
                                            instance="cluster", ctas=C)
                        except ValueError:
                            continue
                        times[f"cluster forced ({C} CTAs)"] = cuda_ms(
                            lambda pl=pl: sk.cg_solve(*args, rtol=rtol,
                                                      plan=pl), 20)
                plain_ms = cuda_ms(lambda: sk.cg_solve_plain(*args,
                                                             rtol=rtol), 3)
                cb = cg_bound(b.numel(), iters, dn)
                shapes[key] = dict(
                    rtol=rtol, iterations=iters, plan=_plan_row(plan),
                    ms=times[f"{plan['instance']} ({plan['ctas']} CTAs)"],
                    us_per_iteration=1e3 * times[
                        f"{plan['instance']} ({plan['ctas']} CTAs)"]
                    / max(iters, 1),
                    instance_ms=times, plain_ms=plain_ms, bound_ms=cb[0],
                    bound_by=cb[1])
                log(f"cg_solve {key}: {iters} iterations, "
                    + ", ".join(f"{k} {v:.5f} ms" for k, v in times.items())
                    + f"; plain {plain_ms:.5f} ms, bound {cb[0]:.6f} ms "
                    f"({cb[1]}); plan {_plan_row(plan)}")
    t = shapes["kpp 257x257 f64"]
    summary["cg_solve"] = dict(
        max_abs_err=errs["f64"],
        err_case="mass solves f64, both instances, " + ", ".join(
            f"{c[0]} rtol {c[3]}" for c in CG_CASES),
        max_abs_err_f32=errs["f32"],
        f32_case="the same in f32, rtol 1e-5",
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None,
        iterations=t["iterations"],
        timed_case="kpp mesh-64 (257x257) mass solve f64 rtol 1e-10",
        shapes=shapes)


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


# the Newton launches a split step makes: (relinearize, residual) -> name;
# the main path (frozen Jacobian, 2 iterations) makes the first and last
NEWTON_FLAGS = {(True, True): "relinearize, residual",
                (False, False): "reinit, no residual",
                (True, False): "relinearize, no residual",
                (False, True): "reinit, residual"}
MAIN_PATH_FLAGS = ((True, True), (False, False))


def split_newton_values(relinearize, residual):
    """Values per node a split Newton launch must move, each input read and
    each output written once: uk, F and, to linearise, w and the planes M,
    Kc (15), or else the Jacobian planes and their preconditioner that an
    earlier launch left (8); for the residual u, g, N(u), K u (and M, Kc
    if not read yet) and F'; uk'."""
    reads = 2 + (15 if relinearize else 8)
    if residual:
        reads += 4 + (0 if relinearize else 14)
    return reads + 1 + (1 if residual else 0)


def check_split(summary, states, regs):
    """Each split kernel against its plain stage, the Newton kernel with both
    values of each keyword, and the whole split step against the tiled
    kernel on the same plan and against the single kernel: f64 at mesh 16
    with 8-row tiles (bicgstab frozen, cheby fresh, bicgstab fresh with 2
    Newton iterations, gfem) and at mesh 64 with the default plan; f32 at
    mesh 128 (the split main path), timed there in turns with the tiled
    and single kernels; the tiled kernel timed at mesh 64 in turns with the
    single kernel."""
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    errs, same_as_tiled = {}, []

    def compare(fields, kw, dn, tile_rows=None, label=""):
        u2, uo2, uoo2, g2, Mc = fields
        s = fs.step_args("split", kw)
        sd, body = fs._plain_data(u2, Mc, s), fs._body_kw(s)
        scr = fs.new_scratch(u2.dtype, u2.device, *u2.shape)
        got = fs.split_setup(*fields, scratch=scr, tile_rows=tile_rows, **kw)
        ref = fs._split_setup_plain(sd, u2, uo2, uoo2, g2, **body)
        e = {"split_setup": max(max_err(a, b) for a, b in zip(got, ref))}
        Kc, aux, uk, F = got
        # the first launch linearises at uk0, leaving the Jacobian in scr;
        # then every pair of keywords from its result, at the same w
        args = (u2, g2, Mc, Kc, aux, uk)
        uk1, F1 = fs.split_newton(uk, F, *args, scratch=scr,
                                  tile_rows=tile_rows, **kw)
        ref = fs._split_newton_plain(sd, uk, F, *args[:2], Kc, aux, uk,
                                     **body)
        e["split_newton"] = max(max_err(uk1, ref[0]), max_err(F1, ref[1]))
        for relin, resid in NEWTON_FLAGS:
            got = fs.split_newton(uk1, F1, *args, scratch=scr,
                                  tile_rows=tile_rows, relinearize=relin,
                                  residual=resid, **kw)
            ref = fs._split_newton_plain(sd, uk1, F1, *args[:2], Kc, aux,
                                         uk, relinearize=relin,
                                         residual=resid, **body)
            if (got[1] is None) != (not resid) or (ref[1] is None) != (
                    not resid):
                raise AssertionError(f"split_newton residual={resid}: F' "
                                     f"returned {got[1] is not None}")
            e["split_newton"] = max(e["split_newton"],
                                    max_err(got[0], ref[0]),
                                    max_err(got[1], ref[1]) if resid else 0)
        split = fs.fused_rv_step_split(*fields, tile_rows=tile_rows, **kw)
        tiled = ts.tiled_rv_step(*fields, tile_rows=tile_rows, **kw)
        e["split step vs tiled"] = max_err(split, tiled)
        e["split step vs single"] = max_err(
            split, fs.fused_rv_step(*fields, **kw)[0])
        torch.cuda.synchronize()
        same_as_tiled.append(bool(torch.equal(split, tiled)))
        log(f"split {label} {dn}: vs plain stage setup "
            f"{e['split_setup']:.3e}, newton (4 keyword pairs) "
            f"{e['split_newton']:.3e}; split step vs tiled kernel on the "
            f"same plan {e['split step vs tiled']:.3e} (equal bit for bit: "
            f"{same_as_tiled[-1]}), vs single kernel "
            f"{e['split step vs single']:.3e}")
        for name, v in e.items():
            _gated(name, v, dn, errs.setdefault(name, {}), TILED_F64_TOL)
        # the same passes over the same tiles and blocks: the same bits
        if not same_as_tiled[-1]:
            raise AssertionError(f"split step {label} {dn} differs from the "
                                 "tiled kernel on the same plan")

    p, *fields = states[16]
    fields = list(fields) + [p.sd.M_coef]
    for solver, frozen, newton, stab in (
            ("bicgstab", True, 3, "rv"), ("cheby", False, 3, "rv"),
            ("bicgstab", False, 2, "rv"), ("bicgstab", True, 3, "gfem")):
        kw = dict(p.fused_step_kwargs(), inner_solver=solver,
                  freeze_jacobian=frozen, newton_iters=newton,
                  stabilization=stab,
                  cg_iters=6 if solver == "bicgstab" else 10,
                  lin_iters=4 if solver == "bicgstab" else 16)
        compare(fields, kw, "f64", 8,
                f"mesh 16, 8-row tiles, {solver} frozen={frozen} "
                f"newton={newton} {stab}")
    p, *fields = states[64]
    fields = list(fields) + [p.sd.M_coef]
    for solver, frozen in (("bicgstab", True), ("cheby", False)):
        kw = dict(p.fused_step_kwargs(), inner_solver=solver,
                  freeze_jacobian=frozen, newton_iters=3,
                  cg_iters=6 if solver == "bicgstab" else 10,
                  lin_iters=4 if solver == "bicgstab" else 16)
        compare(fields, kw, "f64", None,
                f"mesh 64, default plan, {solver} frozen={frozen}")
    p, f32, kw = _bench_f32(states[128])
    compare(f32, kw, "f32", None, "mesh 128 bench config")

    # timed at mesh 128 f32, bench config, all in turns
    u2, uo2, uoo2, g2, Mc = f32
    s = fs.step_args("split", kw)
    sd, body = fs._plain_data(u2, Mc, s), fs._body_kw(s)
    scr = fs.new_scratch(u2.dtype, u2.device, *u2.shape)
    Kc, aux, uk, F = fs.split_setup(*f32, scratch=scr, **kw)
    uk1, F1 = fs.split_newton(uk, F, u2, g2, Mc, Kc, aux, uk, scratch=scr,
                              **kw)

    def newton_fn(relin, resid):
        start = (uk, F) if relin else (uk1, F1)
        return lambda: fs.split_newton(*start, u2, g2, Mc, Kc, aux, uk,
                                       scratch=scr, relinearize=relin,
                                       residual=resid, **kw)

    fns = {"split_setup": lambda: fs.split_setup(*f32, scratch=scr, **kw)}
    for flags in MAIN_PATH_FLAGS:
        fns[NEWTON_FLAGS[flags]] = newton_fn(*flags)
    fns.update({
        "split step": lambda: fs.fused_rv_step_split(*f32, **kw),
        "tiled": lambda: ts.tiled_rv_step(*f32, **kw),
        "single": lambda: fs.fused_rv_step(*f32, **kw)})
    t = _alternated(fns, 20)
    n, n1 = u2.numel(), u2.shape[0]
    plain = dict(
        split_setup=cuda_ms(lambda: fs._split_setup_plain(
            sd, u2, uo2, uoo2, g2, **body), 3),
        split_newton=cuda_ms(lambda: fs._split_newton_plain(
            sd, uk, F, u2, g2, Kc, aux, uk, **body), 3))
    facts = {k: plan_facts(n1, n1, torch.float32, regs, k)
             for k in ("split_setup", "split_newton")}
    floors = {"split_setup": floor_facts(sweep_count(head_sweeps(s, True)),
                                         n, 4)}
    bounds = {"split_setup": bound(22 * n * 4, n * step_ops(s, "setup"),
                                   "f32")}
    for flags in NEWTON_FLAGS:
        floors[NEWTON_FLAGS[flags]] = floor_facts(
            sweep_count(newton_sweeps(s, *flags)), n, 4)
        bounds[NEWTON_FLAGS[flags]] = bound(
            split_newton_values(*flags) * n * 4,
            n * step_ops(s, "newton", *flags), "f32")
    for name in ("split_setup",) + tuple(NEWTON_FLAGS[f]
                                         for f in MAIN_PATH_FLAGS):
        kernel = "split_setup" if name == "split_setup" else "split_newton"
        log(f"{kernel} ({name}) mesh 128 f32 bench config: {t[name]:.5f} ms"
            f" in turns; bound {bounds[name][0]:.5f} ms ({bounds[name][1]});"
            f" {floors[name]['sweeps']} sweeps moving "
            f"{floors[name]['sweep_bytes']} B, floor "
            f"{floors[name]['sweep_floor_ms']:.5f} ms")
    for k, v in facts.items():
        log(f"{k} mesh 128 f32 plan " + json.dumps(v))
    log(f"mesh 128 f32 in turns: split step (1 + 2 launches) "
        f"{t['split step']:.5f} ms, tiled kernel {t['tiled']:.5f} ms, "
        f"single kernel {t['single']:.5f} ms; plain stages "
        f"{plain['split_setup']:.4f} / {plain['split_newton']:.4f} ms")
    # the tiled kernel at mesh 64, in turns with the single kernel
    p64, f64_32, kw64 = _bench_f32(states[64])
    t64 = _alternated({
        "tiled": lambda: ts.tiled_rv_step(*f64_32, **kw64),
        "single": lambda: fs.fused_rv_step(*f64_32, **kw64)}, 20)
    plan64 = plan_facts(*f64_32[0].shape, torch.float32, regs)
    log(f"tiled_rv_step mesh 64 f32 bench config: {t64['tiled']:.5f} ms; "
        f"single kernel in turns {t64['single']:.5f} ms (ratio "
        f"{t64['tiled'] / t64['single']:.4f}); plan " + json.dumps(plan64))
    common = dict(
        err_case="f64 mesh 16 with 8-row tiles (bicgstab frozen, cheby "
                 "fresh, bicgstab fresh 2 Newton iterations, gfem) and mesh "
                 "64 with the default plan, mid-trajectory; the Newton "
                 "kernel with both values of each keyword; against the "
                 "plain stage on the same inputs",
        f32_case="f32 mesh 128 bench config, against the plain stage",
        library_ms=None, split_step_ms_mesh128=t["split step"],
        tiled_ms_mesh128=t["tiled"], single_ms_mesh128=t["single"],
        split_step_vs_tiled_f64=errs["split step vs tiled"]["f64"],
        split_step_vs_tiled_f32=errs["split step vs tiled"]["f32"],
        split_step_equals_tiled_every_case=all(same_as_tiled),
        split_step_vs_single_f64=errs["split step vs single"]["f64"],
        split_step_vs_single_f32=errs["split step vs single"]["f32"])
    setup = "split_setup"
    summary[setup] = dict(
        max_abs_err=errs[setup]["f64"], max_abs_err_f32=errs[setup]["f32"],
        ms=t[setup], plain_ms=plain[setup], bound_ms=bounds[setup][0],
        bound_by=bounds[setup][1],
        timed_case="mesh-128 f32 bench config, one launch, in turns",
        **common, **floors[setup], **facts[setup])
    main, last = (NEWTON_FLAGS[f] for f in MAIN_PATH_FLAGS)
    summary["split_newton"] = dict(
        max_abs_err=errs["split_newton"]["f64"],
        max_abs_err_f32=errs["split_newton"]["f32"], ms=t[main],
        plain_ms=plain["split_newton"], bound_ms=bounds[main][0],
        bound_by=bounds[main][1],
        timed_case="mesh-128 f32 bench config, one launch with "
                   "relinearisation and residual (the first of the main "
                   "path's two), in turns",
        ms_reinit_no_residual=t[last],
        bound_ms_reinit_no_residual=bounds[last][0],
        bound_by_reinit_no_residual=bounds[last][1],
        sweep_floor_ms_by_flags={k: floors[k]["sweep_floor_ms"]
                                 for k in NEWTON_FLAGS.values()},
        sweeps_by_flags={k: floors[k]["sweeps"] for k in NEWTON_FLAGS.values()},
        **common, **facts["split_newton"])
    summary["tiled_rv_step"].update(
        ms_mesh128=t["tiled"], single_ms_mesh128=t["single"],
        ms_mesh64=t64["tiled"], single_ms_mesh64=t64["single"],
        ratio_to_single_mesh64=t64["tiled"] / t64["single"],
        plan_mesh64={k: plan64[k] for k in TILED_FACT_KEYS},
        plan_mesh128={k: plan_facts(n1, n1, torch.float32, regs)[k]
                      for k in TILED_FACT_KEYS})


def check_tiled(summary, states, regs):
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
        # tiled, single, single, tiled: the ratio within one call
        t = _alternated({
            "ms": lambda: ts.tiled_rv_step(*f32, **kw),
            "single_ms": lambda: fs.fused_rv_step(*f32, **kw)}, 10)
        t.update(
            plain_ms=cuda_ms(lambda: ts.tiled_rv_step_plain(*f32, **kw), 2),
            bound=bound(12 * n * 4, n * step_ops(fs.step_args("", kw)),
                        "f32"),
            **tiled_facts(kw, *f32[0].shape, n, torch.float32, regs))
        t["ratio_to_single"] = t["ms"] / t["single_ms"]
        times[mesh] = t
        log(f"tiled_rv_step mesh {mesh} f32 bench config: {t['ms']:.4f} ms; "
            f"single kernel on the same state {t['single_ms']:.4f} ms (ratio "
            f"{t['ratio_to_single']:.4f}); plain {t['plain_ms']:.4f} ms; "
            f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]}); "
            f"{t['sweeps_per_step']} sweeps moving {t['sweep_bytes']} B, "
            f"floor {t['sweep_floor_ms']:.5f} ms; plan " + json.dumps(
                {k: t[k] for k in TILED_FACT_KEYS}))
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
        bound_ms_mesh512=times[512]["bound"][0],
        ratio_to_single_mesh256=t["ratio_to_single"],
        ratio_to_single_mesh512=times[512]["ratio_to_single"],
        sweep_floor_ms_mesh512=times[512]["sweep_floor_ms"],
        sweep_bytes_mesh512=times[512]["sweep_bytes"],
        plan_mesh512={k: times[512][k] for k in TILED_FACT_KEYS},
        **{k: t[k] for k in ("sweeps_per_step", "sweep_bytes",
                             "sweep_floor_ms") + TILED_FACT_KEYS})


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


def _kernel_solve(p, kernel="single"):
    """(solution, microseconds per step) of p's trajectory with one launch
    per step of the single kernel (fused_rv_step) or the tiled kernel
    (tiled_rv_step, default plan), whatever p's mode, CUDA events."""
    from conservation_fem_tpu_torch.ops.tiled_step import tiled_rv_step

    g2 = p.bc_value(p.points, p.dt).reshape(p._shape2)
    kw = p.fused_step_kwargs()

    def step(carry):
        if kernel == "single":
            return p._fused_call(carry, g2, 1)
        u2 = tiled_rv_step(*(v.reshape(p._shape2) for v in carry), g2,
                           p.sd.M_coef, **kw)
        return u2.reshape(-1), carry[0], carry[1]

    def run():
        carry = p._initial_carry()
        for _ in range(p.num_steps):
            carry = step(carry)
        return carry[0]

    return _timed(run, p.num_steps)


def _expected_launches(mode, steps, newton_iters, flux="kpp"):
    from conservation_fem_tpu_torch.ops import _build

    want = {"single": {"fused_rv_step": steps},
            "split": {"split_setup": steps,
                      "split_newton": newton_iters * steps},
            "tiled": {"tiled_rv_step": steps}}[mode]
    return {_build.launch_key(k, flux): v for k, v in want.items()}


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
    carry, g2 = (u, u, u), p.dirichlet_grid(p.dirichlet_frames([p.dt])[0])
    step_ms = cuda_ms(lambda: p._step_fused(carry, g2), 20)
    idle = 1.0 - step_ms * 1e3 / us_kernel
    if mode != "single":
        # the same trajectory through the single kernel, for the dispatch
        # rule's trade at this size
        u_single, us_single = _kernel_solve(p)
        log(f"mesh {mesh_size} f32 single-kernel path (not dispatched): "
            f"{us_single:.1f} us/step, {n / us_single * 1e6:.4g} DOF-steps/s, "
            f"L2rel vs anchor {_gate(u_single, mesh_size, anchor):.4e}, "
            f"max|{mode} - single| {max_err(u, u_single):.3e}")
    if mode == "split":
        # and through the tiled kernel, whose passes the split step runs
        u_tiled, us_tiled = _kernel_solve(p, "tiled")
        log(f"mesh {mesh_size} f32 tiled-kernel path (not dispatched): "
            f"{us_tiled:.1f} us/step, {n / us_tiled * 1e6:.4g} DOF-steps/s, "
            f"L2rel vs anchor {_gate(u_tiled, mesh_size, anchor):.4e}, "
            f"max|split - tiled| {max_err(u, u_tiled):.3e}")
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


def check_block_kernels(summary, states, regs):
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
        # block, tiled, tiled, block: the ratio within one call
        t.update(_alternated(fns, 20))
        t["ratio"] = t["tiled_rv_step_block"] / t["fused_rv_block_step"]
        t["facts"] = tiled_facts(kw, B, n1y, B * n1y, torch.float32, regs)
        times[mesh] = t
        log(f"block kernels mesh {mesh} f32, interior block of 4 (L {L}, B "
            f"{B}, {B * n1y * 4} B per field): fused_rv_block_step "
            f"{t['fused_rv_block_step']:.4f} ms, tiled_rv_step block mode "
            f"{t['tiled_rv_step_block']:.4f} ms (ratio tiled / block "
            f"{t['ratio']:.4f}), plain {t['plain_ms']:.4f} "
            f"ms; bound over the {B} rows swept {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]}), over the {L} owned rows "
            f"{t['bound_owned'][0]:.5f} ms (B/L = {B / L:.3f}); the single "
            f"kernel on the whole grid, same configuration "
            f"{t['single_whole_grid_ms']:.4f} ms; tiled block mode "
            f"{t['facts']['sweeps_per_step']} sweeps moving "
            f"{t['facts']['sweep_bytes']} B, floor "
            f"{t['facts']['sweep_floor_ms']:.5f} ms; plan " + json.dumps(
                {k: t["facts"][k] for k in TILED_FACT_KEYS}))
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
                str(m): times[m]["single_whole_grid_ms"] for m in times},
            ratio_tiled_to_block_kernel_by_mesh={
                str(m): times[m]["ratio"] for m in times})
        if name == "tiled_rv_step_block":
            summary[name].update(
                sweeps_per_step=t["facts"]["sweeps_per_step"],
                sweep_floor_ms_by_mesh={
                    str(m): times[m]["facts"]["sweep_floor_ms"]
                    for m in times},
                plan_by_mesh={str(m): {k: times[m]["facts"][k]
                                       for k in TILED_FACT_KEYS}
                              for m in times},
                **{k: t["facts"][k] for k in ("sweep_bytes",
                                              "sweep_floor_ms")
                   + TILED_FACT_KEYS})


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
    if not _in_range(lo, hi):
        if _in_range(lo_single, hi_single):
            raise AssertionError(f"sharded mesh {mesh}: solution outside "
                                 f"the sanity range {SANITY_RANGE}")
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
    u_single, _ = _kernel_solve(kpp.build(cfg))
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


# ---------------------------------------------------------------------------
# Burgers (models/burgers.py) through the step kernels' Burgers instances
# ---------------------------------------------------------------------------


def burgers_state(mesh, dtype="float64", **over):
    """(problem, u, u_old, u_old_old, g) on the card after
    BURGERS_STATE_STEPS steps of the plain f64 path of the fixed-iteration
    config (the shocks have formed), g the Dirichlet data of the next step;
    dtype: the problem's (the fields are f64 either way)."""
    from conservation_fem_tpu_torch.models import burgers

    cfg = burgers.BurgersConfig(mesh_size=mesh, **{**BURGERS_FIXED, **over})
    p = burgers.build(dataclasses.replace(cfg, dtype="float64"),
                      device="cuda")
    carry = (p.u0,) * 3
    times = p.step_times()
    for t in times[:BURGERS_STATE_STEPS]:
        carry, _ = p.step(carry, t)
    sh = p._shape2
    u2, uo2, uoo2 = (v.reshape(sh) for v in carry)
    g2 = p.bc_value(p.points, times[BURGERS_STATE_STEPS]).reshape(sh)
    if dtype != "float64":
        p = burgers.build(dataclasses.replace(cfg, dtype=dtype),
                          device="cuda")
    return p, u2, uo2, uoo2, g2


def _as(state, dtype):
    """(problem, [u, u_old, u_old_old, g, M] in dtype, step kwargs)."""
    p, *fields = state
    return (p, [v.to(dtype) for v in fields] + [p.sd.M_coef.to(dtype)],
            p.fused_step_kwargs())


def check_burgers_kernels(regs):
    """Each step kernel's Burgers instance against its plain version with
    the Burgers flux, from BURGERS_STATE_STEPS steps in: the single kernel
    at mesh 64, the split kernels at 128, the tiled kernel (whole grid) at
    256, the block kernel and tiled block mode on 4 blocks of mesh 64 (the
    sharded Chebyshev config); f64 (BiCGStab with a frozen and Chebyshev
    with a fresh Jacobian) and f32 (the fixed config). Then the kernel of
    each f64 main path (BURGERS_PATHS: split at mesh 200, tiled at 400 and
    800, with the tile plans f64 narrows) at its shape, and each kernel
    timed at the shapes its f32 main path gives it (single at mesh 200,
    split at 400, tiled at 800; the block kernels on an interior block of
    64 x 4), checked there first. Returns {kernel: Burgers row of the
    kernels line}."""
    import torch

    from conservation_fem_tpu_torch.ops import _build
    from conservation_fem_tpu_torch.ops import fused_step as fs
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    errs = {}

    def gate(name, e, dn, tol):
        _gated(f"{name} (burgers)", e, dn, errs.setdefault(name, {}), tol)

    def solver_cases(kw):
        return [("fixed", kw), ("cheby fresh", dict(
            kw, inner_solver="cheby", freeze_jacobian=False, lin_iters=16))]

    def compare_single(f, kw, dn, label):
        out = fs.fused_rv_step(*f, **kw)
        ref = fs.fused_rv_step_plain(*f, **kw)
        torch.cuda.synchronize()
        e = max(max_err(a, b) for a, b in zip(out, ref))
        log(f"burgers fused_rv_step {label} {dn}: max|kernel-plain| = "
            f"{e:.3e} (step change {max_err(ref[0], f[0]):.3e})")
        gate("fused_rv_step", e, dn, F64_TOL)

    def compare_split(f, kw, dn, label):
        u2, uo2, uoo2, g2, Mc = f
        s = fs.step_args("split", kw)
        sd, body = fs._plain_data(u2, Mc, s), fs._body_kw(s)
        scr = fs.new_scratch(u2.dtype, u2.device, *u2.shape)
        got = fs.split_setup(*f, scratch=scr, **kw)
        ref = fs._split_setup_plain(sd, u2, uo2, uoo2, g2, **body)
        e_setup = max(max_err(a, b) for a, b in zip(got, ref))
        Kc, aux, uk, F = got
        uk1, F1 = fs.split_newton(uk, F, u2, g2, Mc, Kc, aux, uk,
                                  scratch=scr, **kw)
        ref = fs._split_newton_plain(sd, uk, F, u2, g2, Kc, aux, uk, **body)
        e_newton = max(max_err(uk1, ref[0]), max_err(F1, ref[1]))
        last = fs.split_newton(uk1, F1, u2, g2, Mc, Kc, aux, uk, scratch=scr,
                               relinearize=False, residual=False, **kw)
        ref = fs._split_newton_plain(sd, uk1, F1, u2, g2, Kc, aux, uk,
                                     relinearize=False, residual=False,
                                     **body)
        e_newton = max(e_newton, max_err(last[0], ref[0]))
        e_step = max_err(fs.fused_rv_step_split(*f, **kw),
                         fs.fused_rv_step_split_plain(*f, **kw))
        torch.cuda.synchronize()
        log(f"burgers split {label} {dn}: vs plain stage setup "
            f"{e_setup:.3e}, newton (both main-path keyword pairs) "
            f"{e_newton:.3e}; split step vs plain {e_step:.3e}")
        gate("split_setup", e_setup, dn, TILED_F64_TOL)
        gate("split_newton", max(e_newton, e_step), dn, TILED_F64_TOL)

    def compare_tiled(f, kw, dn, label):
        e = max_err(ts.tiled_rv_step(*f, **kw), ts.tiled_rv_step_plain(*f,
                                                                      **kw))
        torch.cuda.synchronize()
        log(f"burgers tiled_rv_step {label} {dn}: max|kernel-plain| = "
            f"{e:.3e}")
        gate("tiled_rv_step", e, dn, TILED_F64_TOL)

    def block_fns(ext, row0, abs_term, n1x, bkw):
        n1y = ext[0].shape[1]
        return {
            "fused_rv_block_step": lambda: fs.fused_rv_block_step(
                *ext, row0, abs_term, n_rows=n1x, n_cols=n1y, **bkw),
            "tiled_rv_step_block": lambda: ts.tiled_rv_step(
                *ext, row0_base=row0, n_rows=n1x, abs_term=abs_term,
                **bkw)}

    def blocks_of(f, kw):
        u2 = f[0]
        D = fs.required_halo(kw["cg_iters"], kw["newton_iters"],
                             kw["lin_iters"])
        blocks, L = _deep_halo_blocks(f[:4], f[4], 4, D)
        abs_term = (u2 - u2.mean()).abs().max().reshape(1)
        bkw = {k: v for k, v in kw.items() if k not in ("nx", "ny")}
        return blocks, L, D, abs_term, bkw

    def compare_blocks(f, kw, dn, label):
        n1x, n1y = f[0].shape
        blocks, L, D, abs_term, bkw = blocks_of(f, kw)
        worst = {}
        for d in (0, 1, 3):
            row0, ext = blocks[d]
            ref = fs.fused_rv_block_step_plain(*ext, row0, abs_term,
                                               n_rows=n1x, n_cols=n1y, **bkw)
            for name, fn in block_fns(ext, row0, abs_term, n1x,
                                      bkw).items():
                e = max_err(fn(), ref)
                worst[name] = max(worst.get(name, 0.0), e)
        torch.cuda.synchronize()
        log(f"burgers block kernels {label} {dn} 4 blocks (L {L}, D {D}), "
            f"blocks [0, 1, 3]: " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in worst.items()))
        gate("fused_rv_block_step", worst["fused_rv_block_step"], dn,
             F64_TOL)
        gate("tiled_rv_step_block", worst["tiled_rv_step_block"], dn,
             TILED_F64_TOL)

    for mesh, compare in ((64, compare_single), (128, compare_split),
                          (256, compare_tiled)):
        state = burgers_state(mesh)
        p, f64, kw = _as(state, torch.float64)
        for label, k in solver_cases(kw):
            compare(f64, k, "f64", f"mesh {mesh} {label}")
        p, f32, kw = _as(burgers_state(mesh, "float32"), torch.float32)
        compare(f32, kw, "f32", f"mesh {mesh} fixed")
    for dtype, dn in (("float64", "f64"), ("float32", "f32")):
        p, f, kw = _as(burgers_state(64, dtype, **BURGERS_SHARDED),
                       getattr(torch, dtype))
        compare_blocks(f, kw, dn, "mesh 64 Chebyshev 10/2x16")
    # the f64 main paths' kernels at their shapes (run_burgers_paths holds
    # _fused_mode to these picks)
    compare = {"single": compare_single, "split": compare_split,
               "tiled": compare_tiled}
    for mesh, dtype, mode in BURGERS_PATHS:
        if dtype == "float64":
            p, f, kw = _as(burgers_state(mesh), torch.float64)
            compare[mode](f, kw, "f64", f"mesh {mesh} fixed (main path "
                                        f"shape)")

    # timed, f32, at the main paths' shapes, the plain versions beside
    rows = {}
    p, f, kw = _as(burgers_state(200, "float32"), torch.float32)
    n = f[0].numel()
    compare_single(f, kw, "f32", "mesh 200 fixed (main path shape)")
    rows["fused_rv_step"] = dict(
        ms=cuda_ms(lambda: fs.fused_rv_step(*f, **kw), 20),
        plain_ms=cuda_ms(lambda: fs.fused_rv_step_plain(*f, **kw), 3),
        bound=bound(14 * n * 4, n * step_ops(fs.step_args("", kw)), "f32"),
        timed_case="mesh-200 f32 fixed config (201 x 201), one step")
    p, f, kw = _as(burgers_state(400, "float32"), torch.float32)
    u2, uo2, uoo2, g2, Mc = f
    n = u2.numel()
    compare_split(f, kw, "f32", "mesh 400 fixed (main path shape)")
    s = fs.step_args("split", kw)
    sd, body = fs._plain_data(u2, Mc, s), fs._body_kw(s)
    scr = fs.new_scratch(u2.dtype, u2.device, *u2.shape)
    Kc, aux, uk, F = fs.split_setup(*f, scratch=scr, **kw)
    uk1, F1 = fs.split_newton(uk, F, u2, g2, Mc, Kc, aux, uk, scratch=scr,
                              **kw)

    def newton_fn(relin, resid):
        start = (uk, F) if relin else (uk1, F1)
        return lambda: fs.split_newton(*start, u2, g2, Mc, Kc, aux, uk,
                                       scratch=scr, relinearize=relin,
                                       residual=resid, **kw)

    fns = {"split_setup": lambda: fs.split_setup(*f, scratch=scr, **kw)}
    for flags in MAIN_PATH_FLAGS:
        fns[NEWTON_FLAGS[flags]] = newton_fn(*flags)
    t = _alternated(fns, 20)
    main, last = (NEWTON_FLAGS[fl] for fl in MAIN_PATH_FLAGS)
    rows["split_setup"] = dict(
        ms=t["split_setup"],
        plain_ms=cuda_ms(lambda: fs._split_setup_plain(
            sd, u2, uo2, uoo2, g2, **body), 3),
        bound=bound(22 * n * 4, n * step_ops(s, "setup"), "f32"),
        timed_case="mesh-400 f32 fixed config (401 x 401), one launch, in "
                   "turns with the Newton launches",
        **plan_facts(*u2.shape, torch.float32, regs, "split_setup",
                     flux="burgers"))
    rows["split_newton"] = dict(
        ms=t[main],
        plain_ms=cuda_ms(lambda: fs._split_newton_plain(
            sd, uk, F, u2, g2, Kc, aux, uk, **body), 3),
        bound=bound(split_newton_values(True, True) * n * 4,
                    n * step_ops(s, "newton", True, True), "f32"),
        timed_case="mesh-400 f32 fixed config, one launch with "
                   "relinearisation and residual (the first of the main "
                   "path's two), in turns",
        ms_reinit_no_residual=t[last],
        bound_ms_reinit_no_residual=bound(
            split_newton_values(False, False) * n * 4,
            n * step_ops(s, "newton", False, False), "f32")[0],
        **plan_facts(*u2.shape, torch.float32, regs, "split_newton",
                     flux="burgers"))
    p, f, kw = _as(burgers_state(800, "float32"), torch.float32)
    n = f[0].numel()
    compare_tiled(f, kw, "f32", "mesh 800 fixed (main path shape)")
    rows["tiled_rv_step"] = dict(
        ms=cuda_ms(lambda: ts.tiled_rv_step(*f, **kw), 10),
        plain_ms=cuda_ms(lambda: ts.tiled_rv_step_plain(*f, **kw), 2),
        bound=bound(12 * n * 4, n * step_ops(fs.step_args("", kw)), "f32"),
        timed_case="mesh-800 f32 fixed config (801 x 801), one step",
        **{k: v for k, v in plan_facts(*f[0].shape, torch.float32, regs,
                                       flux="burgers").items()
           if k in TILED_FACT_KEYS})
    p, f, kw = _as(burgers_state(64, "float32", **BURGERS_SHARDED),
                   torch.float32)
    n1x, n1y = f[0].shape
    blocks, L, D, abs_term, bkw = blocks_of(f, kw)
    row0, ext = blocks[1]
    B = L + 2 * D
    fns = block_fns(ext, row0, abs_term, n1x, bkw)
    t = _alternated(fns, 20)
    plain = cuda_ms(lambda: fs.fused_rv_block_step_plain(
        *ext, row0, abs_term, n_rows=n1x, n_cols=n1y, **bkw), 2)
    ops = step_ops(fs.step_args("", kw))
    for name in fns:
        rows[name] = dict(
            ms=t[name], plain_ms=plain,
            bound=bound(12 * B * n1y * 4, B * n1y * ops, "f32"),
            timed_case=f"mesh-64 f32 Chebyshev 10/2x16, interior block of "
                       f"4, {B} x {n1y}, in turns")
    out = {}
    for name, r in rows.items():
        b = r.pop("bound")
        out[name] = dict(
            max_abs_err=errs[name]["f64"],
            max_abs_err_f32=errs[name]["f32"], bound_ms=b[0],
            bound_by=b[1], library_ms=None, **r)
        log(f"burgers {name}: {r['ms']:.5f} ms ({r['timed_case']}); plain "
            f"{r['plain_ms']:.4f} ms; bound {b[0]:.5f} ms ({b[1]}); max "
            f"|kernel-plain| f64 {errs[name]['f64']:.3e}, f32 "
            f"{errs[name]['f32']:.3e}")
    return out


def run_burgers_reference():
    """The f64 reference config (adaptive solvers, exact Newton,
    use_kernels: the mass solve is cg_solve): mesh 50 against the
    reference's last frame, mesh 100's errors against the exact solution
    against the JAX package's. Returns the cg_solve launches of each run."""
    import torch

    from conservation_fem_tpu_torch.models import burgers

    p = burgers.build(burgers.BurgersConfig(mesh_size=50, use_kernels=True))
    u, counts = _counted_solve(p)
    ref = np.load(os.path.join(REPO, "golden", "burgers_rv50_final.npy"))
    e = float(np.abs(u.cpu().numpy() - ref).max())
    log(f"burgers reference config mesh 50 f64, {p.num_steps} steps: "
        f"launches {counts}; max|u - golden/burgers_rv50 last frame| = "
        f"{e:.3e} (gate {BURGERS_GOLDEN_TOL})")
    if counts != {"cg_solve": p.num_steps} or p.num_steps != 51:
        raise AssertionError(f"burgers mesh 50: {p.num_steps} steps, "
                             f"launches {counts}")
    if not e <= BURGERS_GOLDEN_TOL:
        raise AssertionError(f"burgers mesh 50 differs from the golden "
                             f"frame by {e}")
    q = burgers.build(burgers.BurgersConfig(mesh_size=100, use_kernels=True))
    uq, cq = _counted_solve(q)
    got = dict(num_steps=q.num_steps,
               l1=float(burgers.l1_error_vs_exact(q, uq, 0.5)),
               l2=float(burgers.l2_error_vs_exact(q, uq, 0.5)))
    rel = {k: abs(got[k] - BURGERS_JAX_MESH100[k]) / BURGERS_JAX_MESH100[k]
           for k in ("l1", "l2")}
    log(f"burgers reference config mesh 100 f64, {q.num_steps} steps: "
        f"launches {cq}; L1 {got['l1']!r}, L2 {got['l2']!r} against the "
        f"exact solution at t = 0.5; the JAX package's "
        f"{BURGERS_JAX_MESH100['l1']!r}, {BURGERS_JAX_MESH100['l2']!r} "
        f"(relative {rel['l1']:.2e}, {rel['l2']:.2e}; gate "
        f"{BURGERS_ERR_RTOL})")
    if (got["num_steps"] != BURGERS_JAX_MESH100["num_steps"]
            or cq != {"cg_solve": q.num_steps}
            or not max(rel.values()) <= BURGERS_ERR_RTOL):
        raise AssertionError(f"burgers mesh 100: {got}, launches {cq}")
    torch.cuda.synchronize()
    return {"mesh 50": counts["cg_solve"], "mesh 100": cq["cg_solve"]}


def run_burgers_paths(card):
    """The fixed-iteration config through burgers.build(...).solve() with
    use_kernels, f32 and f64 at mesh 200, 400 and 800 (BURGERS_PATHS): the
    kernel _fused_mode picks, the launch counts of each run, errors against
    the exact solution, µs/step after a warm-up solve, and the idle share
    of mesh 200 f32. Gates: each f32 run within BURGERS_F32_VS_F64 (L2rel)
    of the f64 run on its mesh; the f64 L1 error falls from 200 to 400 to
    800. Returns ({launch key: count}, {launch key: run}) of the f32
    runs."""
    import torch

    from conservation_fem_tpu_torch.models import burgers

    counts, runs, finals, l1_f64 = {}, {}, {}, []
    for mesh, dtype, mode in BURGERS_PATHS:
        cfg = burgers.BurgersConfig(mesh_size=mesh, dtype=dtype,
                                    use_kernels=True, **BURGERS_FIXED)
        p = burgers.build(cfg)
        if p._fused_mode() != mode or p.num_steps != mesh + 1:
            raise AssertionError(f"burgers mesh {mesh} {dtype}: mode "
                                 f"{p._fused_mode()}, {p.num_steps} steps; "
                                 f"expected {mode}, {mesh + 1}")
        u, c = _counted_solve(p)
        want = _expected_launches(mode, p.num_steps, cfg.newton_iters,
                                  "burgers")
        if c != want:
            raise AssertionError(f"burgers mesh {mesh} {dtype}: launched "
                                 f"{c}, expected {want}")
        if not bool(torch.isfinite(u).all()):
            raise AssertionError(f"burgers mesh {mesh} {dtype}: not finite")
        l1 = float(burgers.l1_error_vs_exact(p, u, 0.5))
        l2 = float(burgers.l2_error_vs_exact(p, u, 0.5))
        u_again, us = _timed_solve(p)
        if not torch.equal(u_again, u):
            raise AssertionError(f"burgers mesh {mesh} {dtype}: repeated "
                                 "solves differ")
        n = int(p.u0.numel())
        extra = ""
        if (mesh, dtype) == (200, "float32"):
            carry = (u, u, u)
            g2 = p.dirichlet_grid(p.dirichlet_frames(p.step_times()[:1])[0])
            step_ms = cuda_ms(lambda: p._step_fused(carry, g2), 20)
            idle = 1.0 - step_ms * 1e3 / us
            prof = burgers_idle_profiled(p)
            extra = (f"; back-to-back step {step_ms * 1e3:.1f} us, "
                     f"unprofiled idle share {idle:.4%}; profiled: "
                     f"{json.dumps(prof)}")
        log(f"burgers path mesh {mesh} {dtype} ({mode}), fixed config, "
            f"{p.num_steps} steps: launches {c}; L1 {l1!r}, L2 {l2!r} "
            f"against the exact solution at t = 0.5; {us:.1f} us/step, "
            f"{n / us * 1e6:.4g} DOF-steps/s ({card}){extra}")
        finals[(mesh, dtype)] = u.double()
        if dtype == "float64":
            l1_f64.append(l1)
        else:
            for k, v in c.items():
                counts.setdefault(k, v)
                runs.setdefault(k, f"burgers mesh-{mesh} f32 fixed config "
                                   f"({mode})")
    for mesh in sorted({m for m, _, _ in BURGERS_PATHS}):
        a, b = finals[(mesh, "float32")], finals[(mesh, "float64")]
        rel = float((a - b).norm() / b.norm())
        log(f"burgers mesh {mesh}: L2rel f32 vs f64 {rel:.4e} (gate "
            f"{BURGERS_F32_VS_F64})")
        if not rel <= BURGERS_F32_VS_F64:
            raise AssertionError(f"burgers mesh {mesh}: f32 off f64 by {rel}")
    if not l1_f64[0] > l1_f64[1] > l1_f64[2]:
        raise AssertionError(f"burgers f64 L1 does not fall with the mesh: "
                             f"{l1_f64}")
    return counts, runs


def burgers_idle_profiled(p):
    """Device idle share of one solve under torch.profiler: the union of
    the kernels' spans over the host's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.solve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels)
    return dict(profiled_wall_us=wall_us, profiled_device_busy_us=busy,
                profiled_idle=1.0 - busy / wall_us,
                device_kernels=len(kernels),
                kernels_per_step=len(kernels) / p.num_steps)


def run_burgers_sharded():
    """One sharded Burgers run per block-mode kernel: f64, mesh 64 x 4
    blocks, the sharded Chebyshev config (Burgers' P1 bounds),
    BURGERS_SHARDED_STEPS steps, against the single-device kernel path of
    the same config. Returns the launch counts and their run."""
    import torch

    from conservation_fem_tpu_torch.models import burgers
    from conservation_fem_tpu_torch.ops import _build
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedFusedStructured)

    cfg = burgers.BurgersConfig(mesh_size=64, T=BURGERS_SHARDED_STEPS / 128,
                                **{**BURGERS_FIXED, **BURGERS_SHARDED})
    ref = burgers.build(dataclasses.replace(cfg, use_kernels=True))
    if ref._fused_mode() != "single":
        raise AssertionError(f"burgers mesh 64 f64: {ref._fused_mode()}")
    u_ref = ref.solve().u
    if ref.num_steps != BURGERS_SHARDED_STEPS:
        raise AssertionError(f"burgers sharded: {ref.num_steps} steps")
    counts, runs = {}, {}
    for kernel in ("block", "tiled"):
        p = burgers.build(cfg)
        sh = ShardedFusedStructured(p, LocalBlocks(4, "cuda"), kernel=kernel)
        _build.launches.clear()
        u = sh.solve()
        torch.cuda.synchronize()
        c = dict(_build.launches)
        name = _build.launch_key("fused_rv_block_step" if kernel == "block"
                                 else "tiled_rv_step_block", "burgers")
        e = max_err(u, u_ref)
        log(f"burgers sharded mesh 64 x 4 blocks ({kernel} kernel, L "
            f"{sh.L}, B {sh.B}) f64 Chebyshev 10/2x16, {p.num_steps} steps: "
            f"launches {c}; max|sharded - single kernel path| = {e:.3e} "
            f"(gate {F64_TOL})")
        if c != {name: p.num_steps * 4}:
            raise AssertionError(f"burgers sharded {kernel}: launched {c}")
        if not e <= F64_TOL:
            raise AssertionError(f"burgers sharded {kernel} differs by {e}")
        counts.update(c)
        runs[name] = ("burgers sharded mesh 64 x 4 blocks, f64 Chebyshev "
                      f"({kernel} kernel)")
    return counts, runs


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
    g2 = p.dirichlet_grid(p.dirichlet_frames([p.dt])[0])
    step_ms = cuda_ms(lambda: p._step_fused((u, u, u), g2), 20)
    return dict(mode=p._fused_mode(), profiled_wall_us=wall_us,
                profiled_device_busy_us=busy,
                profiled_idle=1.0 - busy / wall_us,
                device_kernels=len(kernels), solve_us_per_step=us_step,
                step_ms_back_to_back=step_ms,
                unprofiled_idle=1.0 - step_ms * 1e3 / us_step)


def _medians(title, fns, reps=30, rounds=7):
    """{name: median ms} of fns over `rounds` rounds of `reps` launches
    each, the order rotated and reversed from round to round; logs each
    median with the spread (min, max) of its rounds."""
    import statistics

    names = list(fns)
    got = {k: [] for k in names}
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in (order[::-1] if r % 2 else order):
            got[k].append(cuda_ms(fns[k], reps))
    med = {k: statistics.median(v) for k, v in got.items()}
    for k, v in got.items():
        log(f"{title} {k}: {med[k]:.5f} ms ({med[k] / med[names[0]]:.1%} "
            f"of {names[0]}; rounds {min(v):.5f} to {max(v):.5f})")
    return med


def band_ablation(card, states):
    """{ablation: {variant: median ms}}: the single kernel at mesh 64 and
    256 (f32 bench config) and the block kernel on the interior blocks of
    64 x 4 and 512 x 4 (Chebyshev 10 / 2 x 16), each in turns with its
    instances without one element of the band design
    (ops/fused_step.BAND_ABLATIONS, BLOCK_ABLATIONS); states: {mesh:
    mid_trajectory_state(mesh)}."""
    from conservation_fem_tpu_torch.ops import fused_step as fs

    out = {}
    for mesh in (64, 256):
        p, f32, base = _bench_f32(states[mesh])
        fns = {"full": lambda: fs.fused_rv_step(*f32, **base)}
        for name, design in fs.BAND_ABLATIONS.items():
            fns[name] = (lambda d=design: fs.fused_rv_step_ablated(
                d, *f32, **base))
        out[f"band_design_mesh{mesh}"] = _medians(
            f"ablate band design mesh {mesh} ({card})", fns)
    for mesh in (64, 512):
        p, f32, base = _bench_f32(states[mesh])
        n1x, n1y = f32[0].shape
        blocks, _ = _deep_halo_blocks(f32[:4], f32[4], 4, 62)
        row0, ext = blocks[1]
        at = (f32[0] - f32[0].mean()).abs().max().reshape(1)
        bkw = {k: v for k, v in dict(base, inner_solver="cheby",
                                     cg_iters=10, lin_iters=16).items()
               if k not in ("nx", "ny")}
        fns = {"full": lambda: fs.fused_rv_block_step(
            *ext, row0, at, n_rows=n1x, n_cols=n1y, **bkw)}
        for name, design in fs.BLOCK_ABLATIONS.items():
            fns[name] = (lambda d=design: fs.fused_rv_block_step_ablated(
                d, *ext, row0, at, n_rows=n1x, n_cols=n1y, **bkw))
        out[f"band_design_block_{mesh}x4"] = _medians(
            f"ablate band design, block kernel {mesh} x 4 ({card})", fns)
    return out


def ablate(card):
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = dict(card=card, clocks=clocks)
    states = {mesh: mid_trajectory_state(mesh) for mesh in (64, 256, 512)}
    out.update(band_ablation(card, states))
    for mesh in (64, 128, 256, 512):
        state = states.pop(mesh, None) or mid_trajectory_state(mesh)
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
        plans = {}
        n1 = f32[0].shape[0]
        if mesh == 128:
            # the split step's breakdown (the main path's kernels here)
            for name, change in ABLATIONS:
                kw = dict(base, **change)
                rows[f"split, {name}"] = cuda_ms(
                    lambda: fs.fused_rv_step_split(*f32, **kw), 20)
        if mesh >= 128:
            # the tiled kernel (and at mesh 128 the split step) by rows per
            # tile, beside the single kernel
            steps = {"tiled": ("tiled", ts.tiled_rv_step)}
            if mesh == 128:
                steps["split"] = ("split_newton", fs.fused_rv_step_split)
            for label, (kernel, fn) in steps.items():
                default = ts.card_plan(n1, n1, torch.float32,
                                       kernel=kernel)["rows"]
                for tr in TILE_ROWS:
                    name = (f"{label}, {tr}-row tiles"
                            + (" (default)" if tr == default else ""))
                    rows[name] = cuda_ms(
                        lambda: fn(*f32, tile_rows=tr, **base), 10)
                    plan = ts.card_plan(n1, n1, torch.float32, tr,
                                        kernel=kernel)
                    plans[name] = dict(plan, blocks_per_sm=ts.occupancy(
                        torch.float32, plan["smem"],
                        kernel=kernel)["blocks_per_sm"])
        if mesh >= 256:
            # the tiled kernel's own breakdown, default tiles
            for name, change in ABLATIONS[1:]:
                kw = dict(base, **change)
                rows[f"tiled, {name}"] = cuda_ms(
                    lambda: ts.tiled_rv_step(*f32, **kw), 10)
        torch.cuda.synchronize()
        for name, ms in rows.items():
            plan = plans.get(name)
            log(f"ablate mesh {mesh} {name}: {ms:.5f} ms "
                f"({ms / rows['full']:.1%} of the full single step)"
                + ("" if plan is None else
                   f"; {plan['cols']} columns, {plan['tiles']} tiles, "
                   f"{plan['rounds']} rounds over {plan['resident']} "
                   f"resident blocks ({plan['blocks_per_sm']} per SM), "
                   f"{plan['smem']} B of dynamic shared memory"))
        idle = idle_share(mesh)
        log(f"idle mesh {mesh}: {idle}")
        out[str(mesh)] = dict(step_ms=rows, tile_plans=plans, idle=idle)
    return out


def against(other, card):
    """{case: times} of the single and block kernels of the tree in
    `other` and of this one, in turns (other, this, this, other, twice),
    one process each (scripts/torch_kernel_times.py; the first makes the
    inputs)."""
    import torch

    other = os.path.abspath(other)
    if not os.path.isdir(os.path.join(other, "conservation_fem_tpu_torch")):
        raise SystemExit(f"--against {other}: no conservation_fem_tpu_torch "
                         "there")
    script = os.path.join(REPO, "scripts", "torch_kernel_times.py")
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        for k, (tree, who) in enumerate(2 * ((other, "other"),
                                             (REPO, "this"), (REPO, "this"),
                                             (other, "other"))):
            out = os.path.join(tmp, f"{k}.pt")
            subprocess.run([sys.executable, script, "run", tree, inputs,
                            out], check=True, cwd=tree)
            for name, ms in torch.load(out).items():
                got.setdefault(name, {"this": [], "other": []})[who].append(
                    ms)
    rows = {}
    for name, t in got.items():
        this, prev = (sum(v) / len(v) for v in (t["this"], t["other"]))
        rows[name] = dict(this_ms=this, other_ms=prev, ratio=this / prev,
                          this_runs=t["this"], other_runs=t["other"])
        log(f"against {other}: {name}: this tree {this:.5f} ms, the other "
            f"{prev:.5f} ms, ratio {this / prev:.4f} ({card})")
    return rows


def main(argv):
    card = phase_device()
    import torch

    regs = phase_build()
    if argv[1:] == ["--ablate"]:
        log(card)
        log(json.dumps({"ablation": ablate(card)}))
    elif argv[1:2] == ["--against"] and len(argv) == 3:
        log(json.dumps({"against": against(argv[2], card)}))
    elif argv[1:]:
        raise SystemExit(f"usage: {argv[0]} [--ablate | --against DIR]")
    else:
        smoke(card, regs)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def smoke(card, regs):
    from conservation_fem_tpu_torch.ops import _build

    summary, states = {}, {}
    check_stencil_matvec(summary)
    check_cg_solve(summary)
    for mesh in (16, 64, 128, 256, 512):
        states[mesh] = mid_trajectory_state(mesh)
    check_fused_step(summary, states)
    check_tiled(summary, states, regs)
    check_split(summary, states, regs)
    check_block_kernels(summary, states, regs)
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
    # Burgers: each kernel's instance against its plain version and timed,
    # the f64 reference config, the fixed config's main paths, one sharded
    # run per block-mode kernel
    burgers_rows = check_burgers_kernels(regs)
    burgers_cg = run_burgers_reference()
    b_counts, b_runs = run_burgers_paths(card)
    sharded_counts, sharded_runs = run_burgers_sharded()
    b_counts.update(sharded_counts)
    b_runs.update(sharded_runs)
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
        row = dict(
            name=name, route="cuda",
            source=f"conservation_fem_tpu_torch/csrc/{src}",
            replaces=f"conservation_fem_tpu/{tpu}",
            launches=counts.get(name, 0), launches_run=runs[name],
            **summary[name])
        if name in burgers_rows:
            # the step kernels: one instance per flux; the row's own
            # numbers are the KPP instance's
            key = _build.launch_key(name, "burgers")
            row.update(fluxes=["kpp", "burgers"], burgers=dict(
                source=f"conservation_fem_tpu_torch/csrc/"
                       f"{src[:-3]}_burgers.cu",
                launches=b_counts.get(key, 0), launches_run=b_runs[key],
                **burgers_rows[name]))
        if name in BAND_SHAPES:
            row["band_plan"] = band_facts(name, regs)
            log(f"{name} band plan and ptxas: "
                + json.dumps(row["band_plan"]))
        if name == "cg_solve":
            row.update(burgers_reference_launches=burgers_cg,
                       burgers_reference_runs="burgers mesh-50 and mesh-100 "
                                              "f64 reference config",
                       ptxas=cg_facts(regs))
            log("cg_solve ptxas: " + json.dumps(row["ptxas"]))
        rows.append(row)
    log(f"smoke run: {time.perf_counter() - T_START:.0f} s in all")
    log(card)
    log(json.dumps({"kernels": rows}))


if __name__ == "__main__":
    sys.exit(main(sys.argv))
