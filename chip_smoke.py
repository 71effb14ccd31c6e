"""Drive the PyTorch + CUDA port (conservation_fem_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --ablate   # the step ablation and idle share
    python3 chip_smoke.py --against DIR [--ell]   # the single and block
                                  # kernels, cg_solve and the ELL kernels
                                  # A-D (--ell: those alone) against
                                  # another tree's, in turns

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
     bit for bit (the fused path, phase 12's sharded twin and phase 13's
     unstructured twin);
 5b. bf16 operator planes (ROADMAP queue 2 item 5c): the tiled kernel's
     bf16-plane instance (csrc/tiled_step_bf16.cu, KPP f32; no spills)
     against its plain version on the card, within 1e-4 of max|plain|:
     mesh 16 with 8-row tiles over bicgstab/cheby, frozen/fresh Jacobian
     and gfem, the bench config at mesh 256 and 512, and block mode on the
     first, an interior and the last block of mesh 64 x 4; at f64 the flag
     launches the f64 instance, bit for bit; timed in turns with the
     f32-plane instance (mesh 256 and 512, the interior block of 256 x 4),
     beside its plain version, its bound and its sweep floor at 2-byte
     planes (run after phase 3's checks, on their states). Then, counts
     zeroed just before each run and read just after: the f32 bench config
     in tiled mode with tiled_bf16_planes at mesh 256 and at mesh 512 to T
     = 0.1, gated at the anchors and u in [0.5, 12], µs/step in turns with
     the flag off; the composed step with xla_bf16_planes (use_kernels
     off) at mesh 64, gated at its anchor, no hand-written launch; the
     sharded path at 256 x 4 on the bf16 block mode (SHARDED), held to the
     f32-plane sharded run as phase 5 holds its runs to the single device,
     in turns with it (after phase 5). A JSON line {"bf16_planes": ...}
     holds these readings;
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
  7. the ELL backend and the stabilisation library, which launch no
     hand-written kernel (the JAX package runs them as XLA gathers and
     segment sums, not Pallas): the five anchored irregular meshes
     (irregular_mesh nx 140 ... 640, seed 1, RCM order; IRR) built and
     checked against the JAX package's fingerprints; KPP RV through
     kpp.build(cfg, host_mesh=m).solve() with backend="ell", f32
     unstructured bench config (IRR_FIXED), gated at L2rel <= 2e-2 against
     golden/kpp_rv_anchor_irr*.npy with no hand-written launch, timed
     (µs/step, DOF-steps/s), profiled (kernels per step, idle share), and
     at irr140 and irr640 (IRR_PRECISE) again with precise_reductions;
     irr140 in f64: the adaptive config
     against its anchor, and RV, SI and GFEM for 5 fixed-config steps
     against the CPU (1e-10); KPP SI at mesh 64 on the stencil backend (5
     f64 steps against the CPU, the f32 bench trajectory timed, its L2rel
     to the f64 adaptive run printed); Burgers SI with l = 4 smoothing,
     f64 reference config at mesh 100 against the C++ reference's errors
     and the JAX package's (1e-3 relative), at mesh 200 in f64 and f32
     (timed, the f64 errors below mesh 100's); Burgers RV on the ELL
     backend at mesh 50 against the golden frame (1e-9). A JSON line
     {"ell": ...} holds these readings.
  8. linear advection and the Pk layer, which launch no hand-written
     kernel either (0 launches gated on every run, counts zeroed just
     before it): (a) linear_advection.run, the f64 reference config
     (disk, T = 1, adaptive to 1e-12): the convergence sweep h = 1/4 ...
     1/32 of gfem and rv_node, errors within 1e-8 relative of the JAX
     package's (ADVECTION_REFERENCE, scripts/advection_reference_errors.py)
     and slopes within 0.01; rv_cell, rv_node_simple, si and rk4 at mesh
     16 the same way; (b) rv_node, f32 fixed Chebyshev config
     (bench_advection.py's), one rotation on disk_mesh(1/64), within 1e-2
     of the card's f64 adaptive end state, timed (µs/step, DOF-steps/s)
     and profiled (kernels per step, idle share); (c) advection_ho: P2
     gfem at mesh 8 and 16, straight and curved, the degree sweep 1, 2, 3
     at mesh 8 (P2 and P3 below half of P1's error), within 1e-8 of the
     JAX package's, and P3 rv_simple at mesh 4, a chaotic run, within 3 x
     the JAX package's own spread (SPREAD_FACTOR); (d) P2 SI Burgers at
     mesh 32, T = 0.25: the f64 default config, its steps and dofs the JAX
     package's and its L1 and L2 errors within 3 x the JAX package's own
     spread (a renumbering of the dofs), its L2rel against
     golden/burgers_p2si_anchor_mesh32.npy
     printed; the f32 fixed Chebyshev config (bench_pk.py's) within 5e-2
     of that anchor (the state after 64 steps, the anchor's count, printed
     beside the gated 65-step one); mesh 64 in f32 timed and profiled. A
     JSON line {"advection": ...} holds these readings.
  9. compressible Euler and Stokes/IPCS, which launch no hand-written
     kernel either (0 launches gated on every run): (a) Euler through
     euler.build(...) and euler.solve, scripts/bench_euler.py's f32 cells
     (sod nx 100, riemann2d nx 128, 256, 512; stencil backend) with the
     JAX package's step counts and dt, gated at L2rel < 1e-3 against
     golden/euler_*_anchor_nx*.npy; sod 100 and riemann2d 128 in f64
     against the same anchors (the state rounded to f32 as they are
     stored; gate 1e-9 or 3 x the JAX package's own spread); riemann2d 128
     f64 on the ELL backend against the stencil run; (b) Stokes through
     stokes.solve: the f64 reference config (nx 10, 500 steps, ell,
     adaptive) within 1e-8 of the JAX package's Poiseuille L2 error;
     lattice and lattice + multigrid against ell at nx 16, 20 steps, f64,
     Linf <= 1e-9; the five f32 variants of scripts/bench_stokes.py at nx
     32 and 64 (ell adaptive, lattice adaptive, lattice fixed, lattice +
     multigrid adaptive and fixed), 10 steps timed after a warm-up, each
     against the ell run (fixed 1e-2, adaptive 1e-4). Every run: µs/step
     (CUDA events around the gated run, after its first steps twice,
     bit-equal), DOF-steps/s, kernels per step and idle share
     (torch.profiler, the first 3 steps). The JAX package's
     readings are EULER_STOKES_REFERENCE (scripts/euler_stokes_reference.py,
     CPU). A JSON line {"euler_stokes": ...} holds these readings.
 10. the unstructured fast path (ROADMAP queue 1 item 13) on the four
     hand-written ELL kernels of csrc/ell.cu (ell_spmv, ell_assemble,
     p1_newton_locals, ell_rv_epsilon; no TPU kernel under them), on phase
     7's meshes: (b) KPP RV, f32 bench config (IRR_FIXED), through
     kpp.build(cfg, host_mesh=m).solve() with ell_matvec_backend="blocked"
     at irr140 ... irr640 and "blocked2d" at irr140 and irr640 (the RCM
     mesh tiled, u[slot_of_node] gated), each at L2rel <= IRR_GATE against
     its anchor with the gather run's step count, repeated solves
     bit-equal, the launches of each kernel (counts zeroed just before
     the solve, read just after) equal to what the code predicts
     (blocked_launches), µs/step in turns with the gather run on the same
     mesh (BLOCKED_TURNS), DOF-steps/s, kernels per step and idle share
     (the first 3 steps); (a) each kernel against its plain version on the
     card at the end states of the blocked irr140 and irr640 runs, f32 and
     f64, each output on its own: ell_assemble (against its plain version
     on the CPU, which sums in its order; both modes), ell_rv_epsilon
     (on its int16 column codes and on patch_cols32) and ell_spmv's bc
     rows bit-equal, the other outputs within 1e-5 (f32) or F64_TOL (f64)
     of max|plain|,
     ell_spmv in f32 bit-equal to its plain version on the CPU in both
     modes, repeated launches bit-equal; timed at irr640 f32 on a CUDA
     graph of 100 calls, warm (one operand set) and L2-cold (rotating over
     sets of at least 100 MB in all), and per wrapper call back to back,
     beside its plain version, its bound and a PyTorch call timed the same
     way (a torch CSR product, torch.segment_reduce; one that cannot be
     captured is timed over 100 calls back to back, and said so), with
     what ptxas gave each instance; ell_spmv and ell_rv_epsilon on their
     int16 column codes and on their int32 columns, bit-equal and each
     timed; ell_assemble in vector mode and in f64, each bit-equal to the
     port's launch and timed; the four ranked by rule 2 (slower than the
     library call first, then launches a step x (L2-cold - bound),
     ell_assemble's by mode);
     (c) irr140 f64, 5 fixed-config steps,
     rv and si: the card against the CPU (F64_CARD_VS_CPU) and blocked
     against gather on the card (1e-9); (d) P2 SI Burgers mesh 32 f64
     blocked against phase 8's gather run through dof_perm (a chaotic run:
     3 x the JAX package's own move under the RCM dof order), linear
     advection rv_node f32 fixed Chebyshev on disk_mesh(1/64) blocked under
     phase 8's gate, advection_ho P2 gfem at mesh 8 blocked against gather
     (F64_TOL). A JSON line {"unstructured_fast_path": ...} holds these
     readings.
 11. the utilities and solve()'s checkpoint, resume and streaming (ROADMAP
     queue 1 item 14), which add no kernel: their runs launch the
     whole-step kernels and the ELL kernels A-D (utilities_phase): (a) KPP
     f32 bench config at mesh 256 (tiled) and mesh 64 (single), each to
     its T: a solve checkpointed every 100 (25) steps and one stopped at
     half its steps and resumed from the .npz, both bit-equal to the plain
     solve and launching the kernels as often, µs/step of each; (b) mesh
     256 streamed through a StreamingSink at every 1 and 10 steps: the
     frames' count, their times (step_times()), the last frame equal to
     the final u and the thinned frames to the unthinned ones, bit for
     bit, µs/step beside the unstreamed solve, and the idle share of each
     (profiled in a fresh interpreter: in the smoke run's own process,
     after the earlier phases, torch.profiler recorded none of the tiled
     kernel's launches); mesh 64
     streamed into a VTXWriter (bytes and ms a write); (c) phase 10's
     blocked irr640 run, reduced to UTIL_IRR_STEPS steps, as (a), with its
     78 ELL launches a step; (d) the native preprocessor built with g++
     on this machine against the numpy path on irr640 (host seconds of
     each); (e) irr640 f64: ops/dg.nodal_h_dg1 within 1e-12 of
     helpers.get_nodal_h_ell, guards.blown_up False on the final states,
     StepTimer's DOF-steps/s within 5 % of CUDA events on a mesh-256
     solve; (f) metrics.profile_trace around 3 steps of mesh 256 (the
     same fresh interpreter) names the tiled step kernel. A JSON line
     {"utilities": ...} holds these readings.
 12. the sharded twins (ROADMAP queue 1 item 15a) over LocalBlocks on the
     card, which launch no hand-written kernel (0 launches gated on every
     run; twins_phase, in a process of its own beside phases 7-9): (a)
     ShardedStructuredKPP, KPP f32 with the adaptive config of the JAX
     package's multichip path 1 (krylov_rtol 1e-5, TWIN_KPP) at mesh 512
     to T = 0.1 over 4 blocks, gated at L2rel <= 1e-2 against
     golden/kpp_rv_anchor_mesh512_T0.1.npy, µs/step in turns with the
     single-device stencil run of the same config (one turn each:
     TWIN_TURNS_LONG), Krylov iterations a
     step of each (the adaptive cg and bicgstab calls counted), kernels a
     step and idle share (torch.profiler, the first 3 steps); (b) f64, 5
     steps: KPP mesh 64 over 4 and 3 blocks against the single-device path
     on the card (1e-10) and on the CPU (F64_CARD_VS_CPU), Burgers mesh 50
     over 4 blocks against its single-device run (1e-10); (c)
     ShardedStructuredEuler over 4 blocks: riemann2d nx 512 and sod nx 100
     in f32 against phase 9's anchors and gate, in turns with the
     single-device run (the same readings as (a)), sod in f64 against its
     single-device run (1e-10); (d) the sharded carry checkpoint, KPP f32
     at mesh 256 over 4 blocks (TWIN_CKPT, cut to 50 steps):
     solve_checkpointed every TWIN_CKPT_EVERY steps bit-equal to solve(),
     a run stopped at half and resumed on 2 blocks from its
     snapshot bit-equal to the continuation from an in-memory transfer of
     the same carry, bytes and ms a save; (e) is phase 5's one-rank NCCL
     run, which also holds ShardedStructuredKPP over ProcessGroupBlocks to
     LocalBlocks(1) bit for bit. A JSON line {"sharded_twins": ...} holds
     these readings.
 13. the unstructured twins (ROADMAP queue 1 item 15b) over LocalBlocks
     on the card, which launch no hand-written kernel (0 launches gated on
     every run; unstructured_phase, after phase 12 in its process): (a)
     DistributedKPP, KPP f32 on the RCM-ordered irr640 over 4 blocks with
     the irr640 config (IRR[640]) and krylov_rtol 1e-5, gated at IRR_GATE
     against golden/kpp_rv_anchor_irr640.npy, in turns with the
     single-device ELL gather run (the readings of phase 12 (a)), with the
     host seconds of build_partition and build_cell_partition; (b) f64, 5
     steps, each solved twice bit-equal and held to the single-device run
     on the card (1e-10): DistributedKPP irr140 over 4 and 3 blocks (also
     against the CPU, F64_CARD_VS_CPU), Burgers SI with the l = 4
     smoothing on the unit square nx 50, advection rv_cell and rk4 at
     mesh 32, over 4 blocks; (c) shard_problem (owner cells) on the ELL
     backend, irr140 f64 over 4 blocks as (b), irr640 f32 over 4 blocks
     (the fixed irr config, its first 20 steps) in turns with the
     single-device run; (d) is phase 5's one-rank NCCL run, which also
     holds DistributedKPP over ProcessGroupBlocks to LocalBlocks(1) bit for
     bit. A JSON line {"unstructured_twins": ...} holds these readings.
 14. the blocked twins on the ELL kernels, the sharded reductions,
     ShardedStokes and backend="grid" (blocked_twins_phase, in a process
     of its own). A JSON line {"blocked_twins": ...} holds its readings.
 15. the example scripts (conservation_fem_tpu_torch/examples/, ROADMAP
     queue 1 item 16) at the JAX scripts' own sizes, launching no
     hand-written kernel (examples_phase, in a process of its own): the
     tutorial's sections 1-4 and 6 (disk_mesh(1/16) and its Poisson solve:
     49 CG iterations, L2 within 1e-10 relative; KPP mesh 8 with metrics:
     100 steps, Newton converged every step, min and max of u within
     1e-10; checkpoint/resume bit-exact; the run over 4 LocalBlocks within
     1e-10 of the single one) and make_figures' computations 1-6 without
     drawing (advection rv_node mesh 16 and gfem at mesh 4, 8, 16 within
     1e-8 of the JAX package's errors, slope printed; KPP mesh 16 within
     1e-10 L2rel of the JAX package's u; Burgers mesh 60's L2 error
     within SPREAD_FACTOR x the JAX package's own spread of its; Sod nx
     200's L1 density error within 1e-8 relative; the 8 frames of the
     evolution GIF, the last one's min and max within 1e-10), each
     against EXAMPLES_REFERENCE. A JSON line {"examples": ...} holds each
     section's numbers and wall seconds and the card.
From phase 6 (d) on, a run is timed on CUDA events around the one solve
that is gated or counted, after two solves of its trajectory's first
REPEAT_STEPS steps that must agree bit for bit (the repeat check, at that
depth, and the warm-up); phase 10's turns start with the counted solve.
Phase 7's Burgers SI runs, phase 8's (a) and (c), the whole of phase 9
and the whole of phases 12-15 run in five processes of their own
(SIDE_RUNS), on the card at once with the rest of phases 7 and 8 in this
one, so that their µs/step and idle shares are read beside each other's;
their log lines follow this process's, and phase 10 starts when all six
are done.
The second-to-last line is the per-kernel JSON summary (the eight ported
TPU kernels, the tiled kernel's two bf16-plane instances and the four ELL
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
config at mesh 64 and 256, and that of mesh 256 in f32; the ELL kernels
A, B (matrix and vector mode), C and D at the blocked irr640 f32 end
state, warm and L2-cold on a CUDA graph and per wrapper call: with --ell
these alone), and prints each case's times and the ratio this / DIR.
"""

import copy
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
# end states of phase 8's gather runs that phase 10 holds the blocked runs
# against
STATES = {}
F64_TOL = 1e-11          # kernel vs plain, f64
TILED_F64_TOL = 1e-10    # tiled kernel vs plain / single kernel, f64
F32_TOL = 1e-4           # kernel vs plain, f32
ACCURACY_GATE = 1e-2     # L2rel vs the committed f64 anchor (bench.py)
SANITY_RANGE = (0.5, 12.0)   # u of a sane KPP run (bench.py)
ADAPTIVE_TOL = 1e-9      # adaptive f64 solves to 1e-12 in two reduction orders
ADAPTIVE_STEPS = 5
# phase 7's Burgers SI runs, phase 8's (a) and (c), phase 9, and phases
# 12, 13, 14 and 15 (each tuple a process of its own, its functions in
# order) run beside the rest of phases 7 and 8, all six processes on the
# card at once (phase 13 after phase 12 in one process; phase 14, which
# launches the ELL kernels, and phase 15, the example scripts, each in one
# of its own); a process gets SIDE_TIMEOUT seconds after the rest is done
SIDE_RUNS = (("euler_stokes_phase",),
             ("run_advection_f64", "run_pk_advection", "run_burgers_si"),
             ("twins_phase", "unstructured_phase"),
             ("blocked_twins_phase",), ("examples_phase",))
SIDE_TIMEOUT = 600
# a path timed on one solve first solves its trajectory's first
# REPEAT_STEPS steps twice, bit-equal (_repeats): the repeat check at that
# depth, and the warm-up
REPEAT_STEPS = 5
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
BURGERS_STATES = {}   # burgers_state's f64 states by (mesh, over)
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

# The ELL path (models/scalar_hyperbolic.HyperbolicProblem.step): KPP RV on
# the JAX package's five anchored irregular meshes (irregular_mesh((-2,-2),
# (2,2), nx, seed=1) in RCM order; scripts/make_anchor.py:38-65), the
# unstructured bench config of scripts/bench_blocked_scaling.py:50-51 in
# f32 with backend="ell", gated at the JAX bench's L2rel
# (scripts/bench_blocked_scaling.py:36). nx: (dt, T), ~100 steps each.
IRR = {140: (0.005, 0.5), 224: (0.0025, 0.25), 316: (0.0018, 0.18),
       448: (0.00125, 0.125), 640: (0.0009, 0.09)}
IRR_FIXED = dict(modified_newton=True, cg_iters=10, newton_iters=3,
                 newton_linear_iters=8)
IRR_GATE = 2e-2
# the meshes whose gather run is repeated with precise_reductions: the
# smallest and the largest (the other three cost ~25 s of the smoke run's
# 1200 s limit, which phase 11 needs)
IRR_PRECISE = (140, 640)
# make_anchor.py:139-142's window, set for the f64 runs: printed, not gated
IRR_WINDOW = (0.2, 12.5)
# sha256 of points (f64) and cells (int64) of each anchored mesh in RCM
# order, as the JAX package builds it (ops/mesh.mesh_fingerprint of
# conservation_fem_tpu.ops.mesh.reorder_mesh(m, rcm_permutation(m)), CPU):
# the anchors hold only for these triangulations and this numbering
IRR_FINGERPRINTS = {
    140: "5e58cc78f229748744715b912cd550540bb29eb3c7a58d7ff6af43da9254a2fa",
    224: "fff162ca2132ff5dfc92ab917dbc62d57be8c4022e2da90d68860f6392cff582",
    316: "c0342f24a303eb9b949faefaa312092477f5517e8c90f90d5725017a3ad58e47",
    448: "5cf696dac536ce2e5de2f6566eb68f3e86a3fef0ece51256fdea81b0c115ddbc",
    640: "6614cbfd5d0a403d7d19b8652300cd8a213d311361a56e185aeb63ec144aab49",
}

# card against the CPU, f64, 5 steps of a fixed-iteration config (the
# same code; the reductions sum in other orders on the card)
F64_CARD_VS_CPU = 1e-10
# Burgers SI with the l = 4 smoothing (Exact_Burger_SI.py), f64 reference
# config: the C++ reference's errors at mesh 100 (tests/test_burgers.py:
# 41-51; gated at x 1.35 on L1 and x 1.05 on L2, as there) and the JAX
# package's, f64 on the CPU:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu');
#   jax.config.update('jax_enable_x64', True);
#   from conservation_fem_tpu.models import burgers as b;
#   p = b.build(b.BurgersConfig(mesh_size=100, stabilization='si',
#   smooth_l=4.0)); r = p.solve();
#   print(r.num_steps, repr(float(b.l1_error_vs_exact(p, r.u, 0.5))),
#   repr(float(b.l2_error_vs_exact(p, r.u, 0.5))))"
BURGERS_SI_CPP = dict(l1=0.0146037, l2=0.0928357)
BURGERS_SI_JAX_MESH100 = dict(num_steps=101, l1=0.015444565370997209,
                              l2=0.08178413380487048)
# the f32 run at mesh 200: BURGERS_FIXED's solvers with SI (f32 cannot
# reach the reference config's 1e-12)
BURGERS_SI_FIXED = dict(cg_iters=10, newton_iters=2, newton_linear_iters=8,
                        modified_newton=True)

# Linear advection and the Pk layer (phase 8), which launch no
# hand-written kernel either. The JAX package's readings, f64 on the CPU,
# printed by  python3 scripts/advection_reference_errors.py  (needs JAX):
# linear advection's f64 reference config (AdvectionConfig defaults: disk,
# T = 1, CFL 0.5, adaptive solvers to 1e-12) swept over mesh 4 ... 32 for
# gfem and rv_node and at mesh 16 for the other steps; advection_ho's P2
# gfem (straight and curved), its degree sweep at mesh 8 and P3 rv_simple
# at mesh 4; P2 SI Burgers at mesh 32, T = 0.25, f64 default config.
ADVECTION_REFERENCE = {
    "burgers_p2si": {"anchor_l2rel": 1.294177470969401e-05, "dofs": 4225,
                     "dt": 0.00390625, "l1": 0.020301354136689664,
                     "l2": 0.08249753749410113,
                     "rcm_l1": 0.0203013541656951,
                     "rcm_l2": 0.0824975375320464,
                     "rcm_max_abs": 2.343681060335001e-08, "steps": 64},
    "ho": {"p1_gfem_mesh8": {"dofs": 217, "error": 0.06070859923820846,
                             "steps": 143},
           "p2_gfem_mesh16": {"dofs": 3169, "error": 0.006394186409848222,
                              "steps": 285},
           "p2_gfem_mesh16_curved": {"dofs": 3169,
                                     "error": 0.006393644658432842,
                                     "steps": 285},
           "p2_gfem_mesh8": {"dofs": 817, "error": 0.01739049746777819,
                             "steps": 143},
           "p2_gfem_mesh8_curved": {"dofs": 817,
                                    "error": 0.017383336019917782,
                                    "steps": 143},
           "p3_gfem_mesh8": {"dofs": 1801, "error": 0.013971767623146268,
                             "steps": 143},
           "p3_rv_simple_mesh4": {"dofs": 469, "error": 0.2581202163391251,
                                  "noise_spread": 0.00589860278373311,
                                  "steps": 72}},
    "mesh16": {"rk4": {"error": 0.019010843064974407, "steps": 285},
               "rv_cell": {"error": 0.018636137428760864, "steps": 285},
               "rv_node_simple": {"error": 0.01504142965083981,
                                  "steps": 285},
               "si": {"error": 0.09766374539898391, "steps": 285}},
    "sweep": {"gfem": {"errors": [0.17374867096216892,
                                  0.060708599238208455,
                                  0.019122190863613362,
                                  0.00441480050082785],
                       "slope": 1.7562182719721386,
                       "steps": [72, 143, 285, 569]},
              "rv_node": {"errors": [0.26460227883035575,
                                     0.16949885282042107,
                                     0.02477300444699655,
                                     0.0046741549954463415],
                          "slope": 2.0243363060676502,
                          "steps": [72, 143, 285, 569]}}}
ADV_SWEEP = (4, 8, 16, 32)
ADV_ERR_RTOL = 1e-8      # an L2 error against the JAX package's, relative
ADV_SLOPE_TOL = 0.01     # a convergence slope against the JAX package's
# Runs that grow roundoff without bound are held to the JAX package's
# errors at this many times the JAX package's own spread (as
# BURGERS_ERR_RTOL is): P3 rv_simple at mesh 4 (its error moves by up to
# "noise_spread" when u0 moves by 4e-16) and P2 SI Burgers (its errors
# move by "rcm_*" when the dofs are renumbered, the same sums in another
# order); both spreads from scripts/advection_reference_errors.py
SPREAD_FACTOR = 3.0
# the f32 fixed-iteration Chebyshev config of scripts/bench_advection.py
# (gather): rv_node, one rotation on disk_mesh(1/64), gated against the
# card's own f64 adaptive end state at that script's tolerance for it (its
# anchor, on the reference's gmsh disk, is not in this repository)
ADV_FIXED = dict(cg_iters=8, krylov_iters=12, inner_solver="cheby")
ADV_F32_MESH = 64
ADV_F32_GATE = 1e-2
# P2 SI Burgers (higher_order_SI.py) at mesh 32, T = 0.25: the f64
# default config against the JAX package's errors; the f32 fixed-iteration
# Chebyshev config of scripts/bench_pk.py on gather against the committed
# anchor golden/burgers_p2si_anchor_mesh32.npy at that script's gate
PK_BURGERS = dict(degree=2, stabilization="si", T=0.25)
PK_BURGERS_FIXED = dict(modified_newton=True, cg_iters=12, newton_iters=2,
                        newton_linear_iters=10, inner_solver="cheby")
PK_BURGERS_ANCHOR_GATE = 5e-2
# the anchor is the f64 state after 64 steps (dt = 1/256); the f32 dt lies
# one ulp-level below 1/256, so the f32 run takes 65 steps, as the JAX
# package's does (ROADMAP queue 3): the gate reads the 65-step state, and
# the state after 64 steps, at the anchor's time, is printed beside it
PK_BURGERS_ANCHOR_STEPS = 64
PK_BURGERS_TIMED_MESH = 64

# Phase 9, Euler and Stokes (no hand-written kernel on either path).
# Euler: the f32 cells of scripts/bench_euler.py (config
# scripts/make_anchor.py:euler_problem, model defaults, stencil backend),
# each gated at its L2rel gate (bench_euler.py:27) against
# golden/euler_*_anchor_nx*.npy; sod 100 and riemann2d 128 again in f64,
# rounded to f32 as the anchors are stored, gated at
# max(EULER_F64_GATE, SPREAD_FACTOR x the JAX package's own spread);
# riemann2d 128 in f64 on the ELL backend against the stencil run at the
# same gate
EULER_CELLS = (("sod", 100), ("riemann2d", 128), ("riemann2d", 256),
               ("riemann2d", 512))
EULER_GATE = 1e-3
EULER_F64 = (("sod", 100), ("riemann2d", 128))
EULER_F64_GATE = 1e-9
EULER_ELL = ("riemann2d", 128)
# Stokes (IPCS, P2-P1): (a) the f64 reference config (nx 10, 500 steps to
# T = 10, ell, adaptive) within max(STOKES_ORACLE_RTOL, SPREAD_FACTOR x
# the JAX package's own spread) of its Poiseuille L2 error (the error,
# ~6e-8, is a small difference of O(1) fields: the JAX package's own run
# moves by up to 2.6e-8 relative under ulp-level changes of u0 or of its
# operators); (b) lattice, and lattice + multigrid, against ell
# at nx 16, 20 steps, f64 (tests/test_multigrid.py:60-67); (c) the five
# f32 variants of scripts/bench_stokes.py at nx 32 and 64 (krylov_rtol
# 1e-6), 10 steps timed after a warm-up, each against the ell run after
# the same steps: the fixed ones at the bar of RESULTS.md:28, the
# adaptive ones at STOKES_ADAPTIVE_GATE
STOKES_ORACLE_RTOL = 1e-8
STOKES_TIMED_ORACLE_STEPS = 20
STOKES_REPEAT_STEPS = 2   # a Stokes step: three adaptive solves
STOKES_IDENTITY = dict(nx=16, num_steps=20, T=0.4)
STOKES_IDENTITY_GATE = 1e-9
STOKES_BENCH = dict(num_steps=10, T=0.2, dtype="float32", krylov_rtol=1e-6)
STOKES_BENCH_NX = (32, 64)
STOKES_FIXED_GATE = 1e-2
STOKES_ADAPTIVE_GATE = 1e-4
# printed on the CPU by scripts/euler_stokes_reference.py (needs JAX):
# the JAX package's step counts, dt and nodes of each Euler cell; for the
# f64-gated ones its f64 L2rel against the anchor (unrounded, and rounded
# to f32) and its own noise spread; the Stokes reference config's error
EULER_STOKES_REFERENCE = {
    "euler": {
        "sod:100": {"steps": 95, "dt": 0.00211288563682127, "nodes": 2626,
            "f64_l2rel": 2.298468108004719e-08, "f64_l2rel_f32_rounded":
            6.346033735191172e-16, "f64_noise_spread": 9.347259394577994e-16},
        "riemann2d:128": {"steps": 346, "dt": 0.0008688486046240095, "nodes":
            16641, "f64_l2rel": 2.158511203592871e-08,
            "f64_l2rel_f32_rounded": 0.0, "f64_noise_spread":
            1.4424567369563713e-12},
        "riemann2d:256": {"steps": 691, "dt": 0.00043442430231200473, "nodes":
            66049},
        "riemann2d:512": {"steps": 1382, "dt": 0.00021721215115600237,
            "nodes": 263169},
    },
    "stokes": {
        "reference_error_l2": 5.790093812143546e-08,
        "noise_spread": 2.6345881041245656e-08,
        "spreads": {"lattice": 6.131017193816399e-09, "u0 seed 0":
            9.382516238044298e-10, "operators seed 0": 9.746838964356392e-10,
            "u0 seed 1": 5.935252573013281e-09, "operators seed 1":
            1.4320525050419223e-08, "u0 seed 2": 1.0260545517366719e-09,
            "operators seed 2": 8.860001768570315e-09, "u0 seed 3":
            6.564783450384404e-09, "operators seed 3": 1.3402714599868033e-08,
            "u0 seed 4": 1.0491237337917584e-08, "operators seed 4":
            6.488043819603971e-09, "u0 seed 5": 1.8912364928104976e-08,
            "operators seed 5": 7.929357225874803e-09, "u0 seed 6":
            4.584201481369144e-09, "operators seed 6": 9.159775965886942e-10,
            "u0 seed 7": 6.101560897998984e-09, "operators seed 7":
            1.0747274476108461e-08, "u0 seed 8": 1.677564681930561e-08,
            "operators seed 8": 4.915158425332983e-09, "u0 seed 9":
            7.31495707969373e-10, "operators seed 9": 2.6345881041245656e-08},
    },
}

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
            # the tiled kernel's bf16-plane instance
            half = "_bf16" if "13__nv_bfloat16" in line else ""
            name = (f"{m.group(1)}{half}{flux} "
                    f"{'f32' if m.group(2) == 'f' else 'f64'}{design}")
            # ell_spmv's instances: its mode and its columns
            a = re.search(r"ell_spmv_kernelI[fd]Lb([01])E([is])E", line)
            if a:
                name += (" constrained" if a.group(1) == "1" else
                         " unconstrained") + (" int16" if a.group(2) == "s"
                                              else " int32")
            # ell_assemble's: its mode; ell_rv_epsilon's: its columns
            b = re.search(r"ell_assemble_kernelI[fd]Lb([01])E", line)
            if b:
                name += " matrix" if b.group(1) == "1" else " vector"
            d = re.search(r"ell_rv_epsilon_kernelI[fd]NS_\d+\w+?E([is])E",
                          line)
            if d:
                name += " int16" if d.group(1) == "s" else " int32"
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
PTXAS_NAMES = {"tiled": "tiled_rv_step", "tiled_bf16": "tiled_rv_step_bf16",
               "split_setup": "split_setup",
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


def _counted_timed(fn, steps):
    """(fn(), launch counts, µs/step): counts zeroed just before fn and
    read just after it, CUDA events around it."""
    from conservation_fem_tpu_torch.ops import _build

    _build.launches.clear()
    out, us = _timed(fn, steps)
    return out, dict(_build.launches), us


def _prefix(p, steps=REPEAT_STEPS):
    """A copy of problem p that solves only its trajectory's first
    ``steps`` steps; p's static operators are built first, so that the
    copy shares them."""
    force = getattr(p, "_force_lazy_operators", None)
    if force is not None:
        force()
    q = copy.copy(p)
    q.num_steps = min(steps, p.num_steps)
    return q


def _repeats(label, fn):
    """Two calls of fn(), a short solve, must agree bit for bit. They are
    also the warm-up of the path before its one timed solve."""
    import torch

    a = fn()
    if not torch.equal(fn(), a):
        raise AssertionError(f"{label}: repeated solves differ")


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
    _prefix(q).solve()       # the warm-up: the first REPEAT_STEPS steps
    uq, us_plain = _timed(lambda: q.solve().u, q.num_steps)
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


# ---------------------------------------------------------------------------
# Phase 5b: bf16 operator planes, the tiled kernel's bf16-plane instance
# (tiled_bf16_planes, whole grid and block mode) and the composed step's
# bf16 sweeps (xla_bf16_planes)
# ---------------------------------------------------------------------------

# (mesh, T, anchor): the f32 bench config in tiled mode with
# tiled_bf16_planes, each run timed in turns with the flag off
BF16_PATHS = ((256, None, "kpp_rv_anchor_mesh256.npy"),
              (512, 0.1, "kpp_rv_anchor_mesh512_T0.1.npy"))
BF16_TURNS = ("bf16", "f32", "f32", "bf16")
# the composed step with xla_bf16_planes (use_kernels off), and the sharded
# path on the tiled kernel's bf16 block mode: (mesh, blocks, anchor)
BF16_COMPOSED = (64, "kpp_rv_anchor_mesh64.npy")
BF16_SHARDED = (256, 4, "kpp_rv_anchor_mesh256.npy")
BF16_REL_GATE = F32_TOL   # kernel against plain, relative to max|plain|


def bf16_floor(kw, n):
    """The sweeps of a step of the bf16 instance (tiled_sweeps) and the
    bytes they must move over n nodes: the planes its solver sweeps read
    (the mass solve's and the inner solves') and the Jacobian its
    linearisations write at 2 bytes a value, all else at 4."""
    from conservation_fem_tpu_torch.ops import fused_step as fs

    s = fs.step_args("", kw)
    count, values = tiled_sweeps(s)
    per_it = 1 if s["inner_solver"] == "cheby" else 2
    solver = s["cg_iters"] + s["newton_iters"] * s["lin_iters"] * per_it
    lins = 1 if s["freeze_jacobian"] else s["newton_iters"]
    b = (values * 4 - 7 * 2 * (solver + lins)) * n
    return dict(sweeps=count, sweep_bytes=b,
                sweep_floor_ms=b / HBM_BYTES_PER_S * 1e3)


def check_tiled_bf16(summary, states, regs, card):
    """The bf16 instance against its plain version (f32; gated at
    BF16_REL_GATE of max|plain|): mesh 16 with 8-row tiles over the inner
    solvers, Jacobian modes and gfem, the bench config at mesh 256 and 512,
    block mode on the first, an interior and the last block of mesh 64 x
    4; at f64 the flag launches the f64 instance, bit for bit; then timed
    in turns with the f32-plane instance (whole grid at mesh 256 and 512,
    block mode on the interior block of 256 x 4), beside its plain version,
    bound and sweep floor."""
    import torch

    from conservation_fem_tpu_torch.ops import _build
    from conservation_fem_tpu_torch.ops import fused_step as fs
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    _no_spill("tiled_rv_step_bf16 f32", regs.get("tiled_rv_step_bf16 f32"))
    errs = {"tiled_rv_step_bf16": [], "tiled_rv_step_block_bf16": []}

    def compare(name, fields, kw, label, tile_rows=None, **block):
        out = ts.tiled_rv_step(*fields, tile_rows=tile_rows,
                               bf16_planes=True, **block, **kw)
        ref = ts.tiled_rv_step_plain(*fields, bf16_planes=True, **block,
                                     **kw)
        off = ts.tiled_rv_step(*fields, tile_rows=tile_rows, **block, **kw)
        torch.cuda.synchronize()
        e, scale, moved = max_err(out, ref), float(ref.abs().max()), \
            max_err(out, off)
        log(f"{name} {label} f32: max|kernel-plain| = {e:.3e} "
            f"({e / scale:.3e} of max|plain|); max|bf16 - f32 planes| "
            f"{moved:.3e}")
        if not e <= BF16_REL_GATE * scale:
            raise AssertionError(f"{name} {label}: {e} > {BF16_REL_GATE} x "
                                 f"{scale}")
        if not moved > 0:
            raise AssertionError(f"{name} {label}: bf16 planes changed "
                                 "nothing")
        errs[name].append((e, e / scale))

    p, *f64 = states[16]
    f32 = [v.float() for v in f64] + [p.sd.M_coef.float()]
    for solver, frozen, newton, stab in (
            ("bicgstab", True, 2, "rv"), ("bicgstab", False, 3, "rv"),
            ("cheby", True, 3, "rv"), ("cheby", False, 2, "rv"),
            ("bicgstab", True, 3, "gfem")):
        kw = dict(p.fused_step_kwargs(), inner_solver=solver,
                  freeze_jacobian=frozen, newton_iters=newton,
                  stabilization=stab,
                  cg_iters=6 if solver == "bicgstab" else 10,
                  lin_iters=4 if solver == "bicgstab" else 16)
        compare("tiled_rv_step_bf16", f32, kw,
                f"mesh 16, 8-row tiles, {solver} frozen={frozen} "
                f"newton={newton} {stab}", tile_rows=8)
    # f64: the flag is a no-op, the f64 instance's launch, the same bits
    fields64 = list(f64) + [p.sd.M_coef]
    kw = p.fused_step_kwargs()
    _build.launches.clear()
    on = ts.tiled_rv_step(*fields64, tile_rows=8, bf16_planes=True, **kw)
    torch.cuda.synchronize()
    launched = dict(_build.launches)
    same = torch.equal(on, ts.tiled_rv_step(*fields64, tile_rows=8, **kw))
    log(f"tiled_rv_step mesh 16 f64 with bf16_planes: launches {launched}, "
        f"bit-equal to the call without it: {same}")
    if launched != {"tiled_rv_step": 1} or not same:
        raise AssertionError("bf16_planes changed an f64 tiled step")
    for mesh in (256, 512):
        p, f32, kw = _bench_f32(states[mesh])
        compare("tiled_rv_step_bf16", f32, kw, f"mesh {mesh} bench config")
    # block mode: first, interior and last block of mesh 64 x 4, Chebyshev
    p, f32, _ = _bench_f32(states[64])
    cheby = dict(p.fused_step_kwargs(), inner_solver="cheby", cg_iters=10,
                 lin_iters=16, newton_iters=2)
    bkw = {k: v for k, v in cheby.items() if k not in ("nx", "ny")}
    u2, n1x = f32[0], f32[0].shape[0]
    abs_term = (u2 - u2.mean()).abs().max().reshape(1)
    blocks, _ = _deep_halo_blocks(f32[:4], f32[4], 4, 62)
    for d in (0, 1, 3):
        row0, ext = blocks[d]
        compare("tiled_rv_step_block_bf16", ext, bkw,
                f"mesh 64 x 4 block {d}", row0_base=row0, n_rows=n1x,
                abs_term=abs_term)

    # timed, in turns with the f32-plane instance, as the main paths call
    # it: the bf16 mass planes made once (cast_ms: what making them costs)
    times = {}
    for mesh in (256, 512):
        p, f32, kw = _bench_f32(states[mesh])
        n = f32[0].numel()
        mc16 = ts.bf16_planes_of(f32[4])
        t = _alternated({
            "ms": lambda: ts.tiled_rv_step(*f32, bf16_planes=True,
                                           mc16=mc16, **kw),
            "f32_ms": lambda: ts.tiled_rv_step(*f32, **kw)}, 10)
        t.update(
            cast_ms=cuda_ms(lambda: ts.bf16_planes_of(f32[4]), 20),
            plain_ms=cuda_ms(lambda: ts.tiled_rv_step_plain(
                *f32, bf16_planes=True, **kw), 2),
            # u, uo, uoo, g, the f32 and bf16 mass planes in; u_{n+1} out
            bound=bound((12 * 4 + 7 * 2) * n,
                        n * step_ops(fs.step_args("", kw)), "f32"),
            plan={k: v for k, v in plan_facts(
                *f32[0].shape, torch.float32, regs,
                kernel="tiled_bf16").items() if k in TILED_FACT_KEYS},
            floor=bf16_floor(kw, n),
            f32_floor=floor_facts(tiled_sweeps(fs.step_args("", kw)), n, 4))
        t["ratio_to_f32_planes"] = t["ms"] / t["f32_ms"]
        times[mesh] = t
        log(f"tiled_rv_step_bf16 mesh {mesh} f32 bench config: "
            f"{t['ms']:.5f} ms; f32 planes in turns {t['f32_ms']:.5f} ms "
            f"(ratio {t['ratio_to_f32_planes']:.4f}); the bf16 cast of Mc "
            f"{t['cast_ms']:.5f} ms; plain "
            f"{t['plain_ms']:.4f} ms; bound {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]}); {t['floor']['sweeps']} sweeps moving "
            f"{t['floor']['sweep_bytes']} B, floor "
            f"{t['floor']['sweep_floor_ms']:.5f} ms (f32 planes "
            f"{t['f32_floor']['sweep_bytes']} B, "
            f"{t['f32_floor']['sweep_floor_ms']:.5f} ms); plan "
            + json.dumps(t["plan"]) + f" ({card})")
    p, f32, _ = _bench_f32(states[256])
    cheby = dict(p.fused_step_kwargs(), inner_solver="cheby", cg_iters=10,
                 lin_iters=16, newton_iters=2)
    bkw = {k: v for k, v in cheby.items() if k not in ("nx", "ny")}
    u2, (n1x, n1y) = f32[0], f32[0].shape
    abs_term = (u2 - u2.mean()).abs().max().reshape(1)
    blocks, L = _deep_halo_blocks(f32[:4], f32[4], 4, 62)
    row0, ext = blocks[1]
    B = ext[0].shape[0]
    blk = dict(row0_base=row0, n_rows=n1x, abs_term=abs_term)
    mc16 = ts.bf16_planes_of(ext[4])
    tb = _alternated({
        "ms": lambda: ts.tiled_rv_step(*ext, bf16_planes=True, mc16=mc16,
                                       **blk, **bkw),
        "f32_ms": lambda: ts.tiled_rv_step(*ext, **blk, **bkw)}, 20)
    tb.update(
        cast_ms=cuda_ms(lambda: ts.bf16_planes_of(ext[4]), 20),
        plain_ms=cuda_ms(lambda: ts.tiled_rv_step_plain(
            *ext, bf16_planes=True, **blk, **bkw), 2),
        bound=bound((12 * 4 + 7 * 2) * B * n1y,
                    B * n1y * step_ops(fs.step_args("", cheby)), "f32"),
        floor=bf16_floor(cheby, B * n1y),
        f32_floor=floor_facts(tiled_sweeps(fs.step_args("", cheby)),
                              B * n1y, 4),
        plan={k: v for k, v in plan_facts(
            B, n1y, torch.float32, regs, kernel="tiled_bf16").items()
              if k in TILED_FACT_KEYS})
    tb["ratio_to_f32_planes"] = tb["ms"] / tb["f32_ms"]
    log(f"tiled_rv_step_block_bf16 mesh 256 f32, interior block of 4 (L "
        f"{L}, B {B}), Chebyshev 10/2x16: {tb['ms']:.5f} ms; f32 planes in "
        f"turns {tb['f32_ms']:.5f} ms (ratio "
        f"{tb['ratio_to_f32_planes']:.4f}); the bf16 cast of Mc "
        f"{tb['cast_ms']:.5f} ms; plain {tb['plain_ms']:.4f} ms;"
        f" bound {tb['bound'][0]:.5f} ms ({tb['bound'][1]}); floor "
        f"{tb['floor']['sweep_floor_ms']:.5f} ms (f32 planes "
        f"{tb['f32_floor']['sweep_floor_ms']:.5f}); plan "
        + json.dumps(tb["plan"]) + f" ({card})")
    ptxas = regs.get("tiled_rv_step_bf16 f32")
    for name, t, case, err_case in (
            ("tiled_rv_step_bf16", times[256],
             "mesh-256 f32 bench config, one step",
             "f32 one step: mesh 16 with 8-row tiles (bicgstab/cheby, "
             "frozen/fresh, 2 and 3 Newton iterations, gfem), mesh 256 "
             "and 512 bench config"),
            ("tiled_rv_step_block_bf16", tb,
             f"mesh-256 f32 Chebyshev 10/2x16, interior block of 4, {B} x "
             f"{n1y}",
             "f32 one step, mesh 64 x 4 Chebyshev 10/2x16, first, interior "
             "and last block, every row")):
        e = max(errs[name])
        summary[name] = dict(
            max_abs_err=e[0], max_err_of_max_plain=max(
                r for _, r in errs[name]),
            err_case=err_case, gate=f"{BF16_REL_GATE} of max|plain|",
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=None, timed_case=case,
            f32_planes_ms=t["f32_ms"],
            ratio_to_f32_planes=t["ratio_to_f32_planes"],
            mc16_cast_ms=t["cast_ms"],
            sweeps_per_step=t["floor"]["sweeps"],
            sweep_bytes=t["floor"]["sweep_bytes"],
            sweep_floor_ms=t["floor"]["sweep_floor_ms"],
            f32_planes_sweep_floor_ms=t["f32_floor"]["sweep_floor_ms"],
            plan=t["plan"], ptxas=ptxas, card=card)
    summary["tiled_rv_step_bf16"].update(
        ms_mesh512=times[512]["ms"], f32_planes_ms_mesh512=times[512][
            "f32_ms"], ratio_to_f32_planes_mesh512=times[512][
            "ratio_to_f32_planes"], plain_ms_mesh512=times[512]["plain_ms"],
        bound_ms_mesh512=times[512]["bound"][0],
        sweep_floor_ms_mesh512=times[512]["floor"]["sweep_floor_ms"],
        plan_mesh512=times[512]["plan"])


def run_bf16_paths(card, counts, runs):
    """The main paths with bf16 planes, each gated and its launch counts
    zeroed just before it and read just after, each timed in turns with the
    flag off (BF16_TURNS, every repeat bit-equal to the first solve): (d)
    the f32 bench config in tiled mode with tiled_bf16_planes at mesh 256
    and mesh 512 to T = 0.1 (the anchors, u in [0.5, 12]); (e) the composed
    step with xla_bf16_planes at mesh 64 (no hand-written launch; the
    anchor); (f) the sharded path at 256 x 4 on the bf16 block mode,
    SHARDED's Chebyshev config, held to the f32-plane sharded run as phase
    5 holds its runs to the single device."""
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedFusedStructured)

    out = {}

    def turns(label, solvers, steps, first):
        """µs/step of each of solvers ({name: fn}) in BF16_TURNS order,
        each result equal bit for bit to first[name]."""
        got = {}
        for name in BF16_TURNS:
            u, us = _timed(solvers[name], steps)
            if not torch.equal(u, first[name]):
                raise AssertionError(f"{label} {name}: repeated solves "
                                     "differ")
            got.setdefault(name, []).append(us)
        return {k: sum(v) / len(v) for k, v in got.items()}

    for mesh, T, anchor in BF16_PATHS:
        extra = {} if T is None else dict(T=T)
        p = kpp.build(_bench_cfg(kpp, mesh, "float32", use_kernels=True,
                                 tiled_bf16_planes=True, **extra))
        q = kpp.build(_bench_cfg(kpp, mesh, "float32", use_kernels=True,
                                 **extra))
        if p._fused_mode() != "tiled":
            raise AssertionError(f"mesh {mesh}: mode {p._fused_mode()}")
        steps, n = p.num_steps, int(p.u0.numel())
        u, c = _counted_solve(p)
        want = {"tiled_rv_step_bf16": steps}
        log(f"bf16 main path mesh {mesh} (tiled, tiled_bf16_planes), f32 "
            f"bench config, {steps} steps: launches {c}")
        if c != want:
            raise AssertionError(f"mesh {mesh}: launched {c}, expected "
                                 f"{want}")
        rel, lo, hi = _field_stats(u, mesh, anchor)
        _gate(u, mesh, anchor)
        uq = q.solve().u
        rel_q = _gate(uq, mesh, anchor)
        us = turns(f"bf16 mesh {mesh}", {"bf16": lambda: p.solve().u,
                                         "f32": lambda: q.solve().u},
                   steps, {"bf16": u, "f32": uq})
        for name, k in c.items():
            counts.setdefault(name, k)
            runs.setdefault(name, f"mesh-{mesh} f32 bench config"
                            + ("" if T is None else f", T = {T}")
                            + " (tiled, tiled_bf16_planes)")
        out[f"mesh{mesh}"] = dict(
            steps=steps, us_per_step=us["bf16"], f32_us_per_step=us["f32"],
            ratio=us["bf16"] / us["f32"], l2rel=rel, f32_l2rel=rel_q,
            u_min=lo, u_max=hi, max_bf16_minus_f32=max_err(u, uq))
        log(f"bf16 main path mesh {mesh}: {us['bf16']:.1f} us/step, "
            f"{n / us['bf16'] * 1e6:.4g} DOF-steps/s; f32 planes in turns "
            f"{us['f32']:.1f} us/step (ratio {us['bf16'] / us['f32']:.4f}); "
            f"L2rel vs anchor bf16 {rel:.4e}, f32 planes {rel_q:.4e}; u in "
            f"[{lo:.4f}, {hi:.4f}]; max|bf16 - f32| {max_err(u, uq):.3e} "
            f"({card})")

    mesh, anchor = BF16_COMPOSED
    p = kpp.build(_bench_cfg(kpp, mesh, "float32", xla_bf16_planes=True))
    q = kpp.build(_bench_cfg(kpp, mesh, "float32"))
    u, c = _counted_solve(p)
    if c:
        raise AssertionError(f"composed xla_bf16_planes mesh {mesh}: "
                             f"launched {c}")
    uq = q.solve().u
    rel, rel_q = _gate(u, mesh, anchor), _gate(uq, mesh, anchor)
    us = turns(f"composed bf16 mesh {mesh}", {"bf16": lambda: p.solve().u,
                                              "f32": lambda: q.solve().u},
               p.num_steps, {"bf16": u, "f32": uq})
    us_p, us_q = us["bf16"], us["f32"]
    out["composed_mesh64"] = dict(
        us_per_step=us_p, f32_us_per_step=us_q, ratio=us_p / us_q,
        l2rel=rel, f32_l2rel=rel_q, max_bf16_minus_f32=max_err(u, uq))
    log(f"composed xla_bf16_planes mesh {mesh} f32 bench config (plain "
        f"PyTorch, no hand-written launch): {us_p:.1f} us/step, f32 planes "
        f"in turns {us_q:.1f} us/step (ratio {us_p / us_q:.4f}); L2rel vs "
        f"anchor "
        f"{rel:.4e}, f32 planes {rel_q:.4e}; max|bf16 - f32| "
        f"{max_err(u, uq):.3e} ({card})")

    mesh, n_blocks, anchor = BF16_SHARDED
    sh = ShardedFusedStructured(
        kpp.build(_sharded_cfg(kpp, mesh, "float32",
                               tiled_bf16_planes=True)),
        LocalBlocks(n_blocks, "cuda"))
    sq = ShardedFusedStructured(kpp.build(_sharded_cfg(kpp, mesh, "float32")),
                                LocalBlocks(n_blocks, "cuda"))
    if sh.kernel != "tiled":
        raise AssertionError(f"sharded bf16 mesh {mesh}: {sh.kernel} kernel")
    steps = sh.p.num_steps
    u, c = _counted_timed(sh.solve, steps)[:2]
    want = {"tiled_rv_step_block_bf16": steps * n_blocks}
    log(f"bf16 sharded path mesh {mesh} x {n_blocks} (tiled block mode, "
        f"tiled_bf16_planes), f32 Chebyshev 10/2x16, {steps} steps: "
        f"launches {c}")
    if c != want:
        raise AssertionError(f"sharded bf16: launched {c}, expected {want}")
    uq = sq.solve()
    rel, lo, hi = _field_stats(u, mesh, anchor)
    rel_q, lo_q, hi_q = _field_stats(uq, mesh, anchor)
    us = turns(f"sharded bf16 mesh {mesh}", {"bf16": sh.solve,
                                             "f32": sq.solve},
               steps, {"bf16": u, "f32": uq})
    for name, k in c.items():
        counts.setdefault(name, k)
        runs.setdefault(name, f"sharded path mesh {mesh} x {n_blocks} "
                              "blocks, f32 Chebyshev, tiled_bf16_planes")
    log(f"bf16 sharded path mesh {mesh} x {n_blocks}: {us['bf16']:.1f} "
        f"us/step; f32 planes in turns {us['f32']:.1f} us/step (ratio "
        f"{us['bf16'] / us['f32']:.4f}); L2rel vs anchor bf16 {rel:.4e}, "
        f"f32 planes {rel_q:.4e} (gate: within {SHARDED_VS_SINGLE}); u in "
        f"[{lo:.4f}, {hi:.4f}], f32 planes [{lo_q:.4f}, {hi_q:.4f}] "
        f"({card})")
    if not abs(rel - rel_q) <= SHARDED_VS_SINGLE:
        raise AssertionError(f"sharded bf16 L2rel {rel} against {rel_q}")
    if not _in_range(lo, hi) and not (
            not _in_range(lo_q, hi_q)
            and max(abs(lo - lo_q), abs(hi - hi_q)) <= SHARDED_RANGE_SLACK):
        raise AssertionError(f"sharded bf16: range [{lo}, {hi}]")
    out[f"sharded_mesh{mesh}x{n_blocks}"] = dict(
        steps=steps, us_per_step=us["bf16"], f32_us_per_step=us["f32"],
        ratio=us["bf16"] / us["f32"], l2rel=rel, f32_l2rel=rel_q, u_min=lo,
        u_max=hi)
    return out


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
    a temporary directory) against LocalBlocks(1), bit for bit: the fused
    sharded path (mesh 64, 5 steps) and, phase 12 (e), the sharded twin
    ShardedStructuredKPP (TWIN_KPP at mesh 64, 5 steps, no hand-written
    launch) and, phase 13 (d), the unstructured twin DistributedKPP
    (TWIN_KPP f32 on UNS_PG_MESH, 5 steps, no hand-written launch) and,
    phase 14 (f), the blocked twin DistributedBlocked (the f32 blocked
    bench config on UNS_PG_MESH, 5 steps, through the ELL kernels). One
    card cannot host two NCCL ranks, so the exchange between ranks is held
    to LocalBlocks on the CPU (gloo) by the test suite, not here."""
    import datetime

    import torch
    import torch.distributed as dist

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.ops import _build
    from conservation_fem_tpu_torch.ops import mesh as tmesh
    from conservation_fem_tpu_torch.parallel import (DistributedBlocked,
                                                     DistributedKPP,
                                                     LocalBlocks,
                                                     ProcessGroupBlocks,
                                                     ShardedFusedStructured,
                                                     ShardedStructuredKPP)

    cfg = _sharded_cfg(kpp, 64, "float32", T=0.05)
    local = ShardedFusedStructured(kpp.build(cfg), LocalBlocks(1, "cuda"))
    u_local = local.solve()
    twin_cfg = _twin_kpp_cfg(kpp, 64, "float32", T=0.05)
    twin = lambda blocks: _no_launch(
        f"sharded twin over {type(blocks).__name__}",
        ShardedStructuredKPP(kpp.build(twin_cfg), blocks).solve)
    twin_local = twin(LocalBlocks(1, "cuda"))
    um = tmesh.irregular_mesh((-2, -2), (2, 2), nx=UNS_PG_MESH, seed=1)
    up = kpp.build(kpp.KPPConfig(dtype="float32", dt=0.005, T=0.025,
                                 backend="ell", **TWIN_KPP),
                   host_mesh=tmesh.reorder_mesh(um, tmesh.rcm_permutation(um)))
    uns = lambda blocks: _no_launch(
        f"unstructured twin over {type(blocks).__name__}",
        DistributedKPP(up, blocks).solve)
    uns_local = uns(LocalBlocks(1, "cuda"))
    bp = kpp.build(kpp.KPPConfig(dtype="float32", dt=0.005, T=0.025,
                                 backend="ell", ell_matvec_backend="blocked",
                                 **IRR_FIXED), host_mesh=up.host_mesh)
    blk = lambda blocks: _some_launches(
        f"blocked twin over {type(blocks).__name__}",
        DistributedBlocked(bp, blocks).solve, tuple(ELL_KERNELS))
    blk_local, blk_counts = blk(LocalBlocks(1, "cuda"))
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
            twin_pg = twin(ProcessGroupBlocks(dist.group.WORLD))
            uns_pg = uns(ProcessGroupBlocks(dist.group.WORLD))
            blk_pg, blk_pg_counts = blk(ProcessGroupBlocks(dist.group.WORLD))
        finally:
            dist.destroy_process_group()
    same = torch.equal(u, u_local)
    twin_same = torch.equal(twin_pg, twin_local)
    uns_same = torch.equal(uns_pg, uns_local)
    blk_same = torch.equal(blk_pg, blk_local) and blk_pg_counts == blk_counts
    log(f"ProcessGroupBlocks, one NCCL rank, mesh 64 f32, {local.p.num_steps}"
        f" steps ({sh.kernel} kernel): launches {counts}; equal to "
        f"LocalBlocks(1) bit for bit: {same}; the sharded twin "
        f"(ShardedStructuredKPP, adaptive f32): no hand-written launch, "
        f"equal to LocalBlocks(1) bit for bit: {twin_same}; the "
        f"unstructured twin (DistributedKPP, irregular nx {UNS_PG_MESH}, "
        f"{up.num_steps} steps, adaptive f32): no hand-written launch, "
        f"equal to LocalBlocks(1) bit for bit: {uns_same}; the blocked twin "
        f"(DistributedBlocked, the same mesh, {bp.num_steps} steps, fixed "
        f"f32): launches {blk_pg_counts}, equal to LocalBlocks(1) bit for "
        f"bit and in launches: {blk_same}")
    if not same:
        raise AssertionError("ProcessGroupBlocks differs from LocalBlocks(1)")
    if not twin_same:
        raise AssertionError("ShardedStructuredKPP over ProcessGroupBlocks "
                             "differs from LocalBlocks(1)")
    if not uns_same:
        raise AssertionError("DistributedKPP over ProcessGroupBlocks "
                             "differs from LocalBlocks(1)")
    if not blk_same:
        raise AssertionError("DistributedBlocked over ProcessGroupBlocks "
                             "differs from LocalBlocks(1)")


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
    dtype: the problem's (the fields are f64 either way). The steps run
    once for each (mesh, over) (BURGERS_STATES); each call gets copies."""
    from conservation_fem_tpu_torch.models import burgers

    cfg = burgers.BurgersConfig(mesh_size=mesh, **{**BURGERS_FIXED, **over})
    key = (mesh, tuple(sorted(over.items())))
    if key not in BURGERS_STATES:
        p = burgers.build(dataclasses.replace(cfg, dtype="float64"),
                          device="cuda")
        carry = (p.u0,) * 3
        times = p.step_times()
        for t in times[:BURGERS_STATE_STEPS]:
            carry, _ = p.step(carry, t)
        sh = p._shape2
        g2 = p.bc_value(p.points, times[BURGERS_STATE_STEPS]).reshape(sh)
        BURGERS_STATES[key] = (p, [v.reshape(sh) for v in carry] + [g2])
    p, fields = BURGERS_STATES[key]
    if dtype != "float64":
        p = burgers.build(dataclasses.replace(cfg, dtype=dtype),
                          device="cuda")
    return (p, *(v.clone() for v in fields))


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
    BURGERS_STATES.clear()
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
    the exact solution, µs/step of the counted solve (after _repeats),
    and the idle share of mesh 200 f32. Gates: each f32 run within
    BURGERS_F32_VS_F64 (L2rel) of the f64 run on its mesh; the f64 L1
    error falls from 200 to 400 to 800. Returns ({launch key: count},
    {launch key: run}) of the f32 runs."""
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
        label = f"burgers mesh {mesh} {dtype}"
        q = _prefix(p)
        _repeats(label, lambda: q.solve().u)
        u, c, us = _counted_timed(lambda: p.solve().u, p.num_steps)
        want = _expected_launches(mode, p.num_steps, cfg.newton_iters,
                                  "burgers")
        if c != want:
            raise AssertionError(f"burgers mesh {mesh} {dtype}: launched "
                                 f"{c}, expected {want}")
        if not bool(torch.isfinite(u).all()):
            raise AssertionError(f"burgers mesh {mesh} {dtype}: not finite")
        l1 = float(burgers.l1_error_vs_exact(p, u, 0.5))
        l2 = float(burgers.l2_error_vs_exact(p, u, 0.5))
        n = int(p.u0.numel())
        extra = ""
        if (mesh, dtype) == (200, "float32"):
            carry = (u, u, u)
            g2 = p.dirichlet_grid(p.dirichlet_frames(p.step_times()[:1])[0])
            step_ms = cuda_ms(lambda: p._step_fused(carry, g2), 20)
            idle = 1.0 - step_ms * 1e3 / us
            prof = idle_profiled(p)
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


def idle_profiled(p, steps=None, solve=None):
    """Device idle share of one solve under torch.profiler, recording the
    device's activity only: the union of the kernels' spans over the
    host's wall time. steps: solve only the trajectory's first steps (a
    copy of p with num_steps = steps); None: the whole solve. solve: the
    function that solves p (None: p.solve)."""
    if steps is not None:
        p = copy.copy(p)
        p.num_steps = steps
    return profiled(lambda: p.solve() if solve is None else solve(p),
                    p.num_steps)


def profiled(fn, steps):
    """idle_profiled's readings of fn(), which takes ``steps`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_spans(prof)
    busy = _busy_us(kernels)
    return dict(profiled_wall_us=wall_us, profiled_device_busy_us=busy,
                profiled_idle=1.0 - busy / wall_us,
                device_kernels=len(kernels),
                kernels_per_step=len(kernels) / steps,
                device_busy_us_per_step=busy / steps)


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


def irr_mesh(nx):
    """irregular_mesh((-2,-2), (2,2), nx, seed=1) in RCM order, its ELL
    structure built, checked against the JAX package's fingerprint first
    (the anchors hold only for the same triangulation and numbering)."""
    from conservation_fem_tpu_torch.ops import mesh as tmesh

    t0 = time.perf_counter()
    m = tmesh.irregular_mesh((-2, -2), (2, 2), nx=nx, seed=1)
    m = tmesh.reorder_mesh(m, tmesh.rcm_permutation(m))
    fp = tmesh.mesh_fingerprint(m)
    if fp != IRR_FINGERPRINTS[nx]:
        raise AssertionError(
            f"irregular_mesh nx {nx}: this machine's triangulation or "
            f"RCM numbering differs from the JAX package's (fingerprint "
            f"{fp}, expected {IRR_FINGERPRINTS[nx]}): the committed "
            f"anchor golden/kpp_rv_anchor_irr{nx}.npy does not apply")
    _ = m.ell
    log(f"irr{nx}: {m.n_nodes} nodes, {m.n_cells} cells, K "
        f"{m.max_patch}, fingerprint matches the JAX package's; built "
        f"in {time.perf_counter() - t0:.1f} s on the host")
    return m


def irr_meshes():
    """{nx: irr_mesh(nx)} of the five anchored irregular meshes."""
    return {nx: irr_mesh(nx) for nx in IRR}


def _ell_run(p, label):
    """(u, launch counts, us/step): the trajectory's first REPEAT_STEPS
    steps twice, bit-equal (_repeats), then one counted solve timed on
    CUDA events."""
    q = _prefix(p)
    _repeats(label, lambda: q.solve().u)
    u, counts, us = _counted_timed(lambda: p.solve().u, p.num_steps)
    if counts:
        raise AssertionError(f"{label}: launched hand-written kernels "
                             f"{counts}; this path has none")
    return u, counts, us


def _irr_gate(u, nx, label):
    ref = np.load(os.path.join(REPO, "golden",
                               f"kpp_rv_anchor_irr{nx}.npy")).astype(
        np.float64)
    ud = u.double().cpu().numpy()
    if not np.isfinite(ud).all():
        raise AssertionError(f"{label}: not finite")
    rel = float(np.linalg.norm(ud - ref) / np.linalg.norm(ref))
    if not rel <= IRR_GATE:
        raise AssertionError(f"{label}: L2rel {rel} against the anchor")
    return rel, float(ud.min()), float(ud.max()), float(ref.min()), \
        float(ref.max())


def run_ell_paths(card, meshes):
    """KPP RV on the ELL backend at irr140..irr640, f32 unstructured bench
    config (IRR_FIXED), through kpp.build(cfg, host_mesh=m).solve(): gated
    at L2rel <= IRR_GATE against each anchor, min and max beside the
    anchor's, no hand-written launch, µs/step and DOF-steps/s (CUDA events
    around the gated solve, after _repeats), kernels per step and idle
    share (torch.profiler, the first 3 steps), and at IRR_PRECISE the same
    run with precise_reductions, timed the same way.
    Returns {nx: readings}."""
    from conservation_fem_tpu_torch.models import kpp

    out = {}
    for nx, m in meshes.items():
        dt, T = IRR[nx]
        cfg = kpp.KPPConfig(dtype="float32", dt=dt, T=T, backend="ell",
                            **IRR_FIXED)
        p = kpp.build(cfg, host_mesh=m)
        label = f"irr{nx} f32 ELL bench config"
        u, counts, us = _ell_run(p, label)
        rel, lo, hi, rlo, rhi = _irr_gate(u, nx, label)
        prof = idle_profiled(p, steps=3)
        relq = usq = None
        if nx in IRR_PRECISE:
            q = kpp.build(dataclasses.replace(cfg, precise_reductions=True),
                          host_mesh=m)
            uq, _, usq = _ell_run(q, label + " precise_reductions")
            relq = _irr_gate(uq, nx, label + " precise_reductions")[0]
        n = m.n_nodes
        out[nx] = dict(nodes=n, steps=p.num_steps, l2rel=rel, u_min=lo,
                       u_max=hi, anchor_min=rlo, anchor_max=rhi,
                       us_per_step=us, dof_steps_per_s=n / us * 1e6,
                       hand_written_launches=sum(counts.values()),
                       precise_l2rel=relq, precise_us_per_step=usq, **prof)
        log(f"{label}, {p.num_steps} steps: L2rel {rel:.4e} against "
            f"golden/kpp_rv_anchor_irr{nx}.npy (gate {IRR_GATE}); u in "
            f"[{lo:.4f}, {hi:.4f}], anchor [{rlo:.4f}, {rhi:.4f}] (window "
            f"{IRR_WINDOW}, not gated); hand-written launches 0; {us:.1f} "
            f"us/step, {n / us * 1e6:.4g} DOF-steps/s; "
            f"{prof['kernels_per_step']:.1f} kernels/step, idle share "
            f"{prof['profiled_idle']:.4f} (profiled, first 3 steps)"
            + ("" if relq is None else f"; precise_reductions: L2rel "
               f"{relq:.4e}, {usq:.1f} us/step") + f" ({card})")
    return out


def _ell_f64_fixed(stabilization):
    return dict(stabilization=stabilization, dtype="float64", **IRR_FIXED)


def run_ell_f64(meshes):
    """f64 on the card at irr140: the adaptive config (KPPConfig defaults,
    krylov_rtol 1e-12), the anchor's own run, gated at IRR_GATE; and RV,
    SI and GFEM for 5 steps of the fixed config, card against the CPU
    (F64_CARD_VS_CPU)."""
    import torch

    from conservation_fem_tpu_torch.models import kpp

    m = meshes[140]
    dt, T = IRR[140]
    p = kpp.build(kpp.KPPConfig(dt=dt, T=T, backend="ell",
                                krylov_rtol=1e-12), host_mesh=m)
    u, _, us = _ell_run(p, "irr140 f64 adaptive")
    rel, lo, hi, _, _ = _irr_gate(u, 140, "irr140 f64 adaptive")
    log(f"irr140 f64 adaptive config (krylov_rtol 1e-12), {p.num_steps} "
        f"steps: L2rel {rel!r} against golden/kpp_rv_anchor_irr140.npy "
        f"(this run on the CPU, stored f32; gate {IRR_GATE}); u in "
        f"[{lo:.4f}, {hi:.4f}]; {us:.1f} us/step")
    out = dict(adaptive_l2rel=rel, adaptive_us_per_step=us)
    for stab in ("rv", "si", "gfem"):
        cfg = kpp.KPPConfig(dt=dt, T=5 * dt, backend="ell",
                            **_ell_f64_fixed(stab))
        uc = kpp.build(cfg, host_mesh=m).solve().u
        torch.cuda.synchronize()
        ref = kpp.build(cfg, host_mesh=m, device="cpu").solve().u
        e = max_err(uc.cpu(), ref)
        log(f"irr140 f64 fixed config {stab}, 5 steps: max|card - CPU| = "
            f"{e:.3e} (gate {F64_CARD_VS_CPU})")
        if not e <= F64_CARD_VS_CPU:
            raise AssertionError(f"irr140 {stab}: card off the CPU by {e}")
        out[f"{stab}_card_vs_cpu"] = e
    return out


def run_kpp_si(card):
    """KPP SI (Cm 0.5) at mesh 64 on the stencil backend: 5 steps of the
    f64 fixed config, card against the CPU; the f32 bench-config
    trajectory (100 steps), timed and profiled, finite; its L2rel against
    the card's f64 adaptive run, printed (the JAX package gates SI on
    finite values only)."""
    import torch

    from conservation_fem_tpu_torch.models import kpp

    si = dict(stabilization="si", Cm=0.5)
    cfg = _bench_cfg(kpp, 64, "float64", T=0.05, **si)
    uc = kpp.build(cfg).solve().u
    torch.cuda.synchronize()
    e = max_err(uc.cpu(), kpp.build(cfg, device="cpu").solve().u)
    log(f"kpp si mesh 64 f64 bench config, 5 steps: max|card - CPU| = "
        f"{e:.3e} (gate {F64_CARD_VS_CPU})")
    if not e <= F64_CARD_VS_CPU:
        raise AssertionError(f"kpp si mesh 64: card off the CPU by {e}")
    p = kpp.build(_bench_cfg(kpp, 64, "float32", **si))
    u, counts = _counted_solve(p)
    if counts or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"kpp si mesh 64 f32: launches {counts}, "
                             f"finite {bool(torch.isfinite(u).all())}")
    _, us = _timed(lambda: p.solve().u, p.num_steps)
    prof = idle_profiled(p, steps=3)
    q = kpp.build(kpp.KPPConfig(mesh_size=64, **si))
    uq, _, usq = _ell_run(q, "kpp si mesh 64 f64 adaptive")
    rel = float((u.double() - uq).norm() / uq.norm())
    n = int(u.numel())
    log(f"kpp si mesh 64 f32 bench config, {p.num_steps} steps: finite, u "
        f"in [{float(u.min()):.4f}, {float(u.max()):.4f}]; {us:.1f} "
        f"us/step, {n / us * 1e6:.4g} DOF-steps/s; "
        f"{prof['kernels_per_step']:.1f} kernels/step, idle share "
        f"{prof['profiled_idle']:.4f} (profiled, first 3 steps); L2rel "
        f"against the f64 adaptive run {rel:.4e} (printed, not gated); f64 "
        f"adaptive {usq:.1f} us/step ({card})")
    return dict(card_vs_cpu=e, us_per_step=us, dof_steps_per_s=n / us * 1e6,
                f32_vs_f64_l2rel=rel, f64_adaptive_us_per_step=usq, **prof)


def run_burgers_si(card):
    """Burgers SI with the l = 4 smoothing (Exact_Burger_SI.py): the f64
    reference config at mesh 100 within the C++ reference's figures and
    within BURGERS_ERR_RTOL of the JAX package's errors; at mesh 200 (the
    reference's N) the f64 reference config and the f32 fixed config,
    timed, the f64 errors below mesh 100's. Then Burgers RV on the ELL
    backend, f64 reference config at mesh 50, against the golden frame."""
    import torch

    from conservation_fem_tpu_torch.models import burgers

    out = {}
    si = dict(stabilization="si", smooth_l=4.0)
    errs = {}
    for mesh, dtype, extra in ((100, "float64", {}), (200, "float64", {}),
                               (200, "float32", BURGERS_SI_FIXED)):
        p = burgers.build(burgers.BurgersConfig(mesh_size=mesh, dtype=dtype,
                                                **si, **extra))
        label = f"burgers si l=4 mesh {mesh} {dtype}" + (
            " fixed config" if extra else " reference config")
        u, _, us = _ell_run(p, label)
        if not bool(torch.isfinite(u).all()):
            raise AssertionError(f"{label}: not finite")
        l1 = float(burgers.l1_error_vs_exact(p, u, 0.5))
        l2 = float(burgers.l2_error_vs_exact(p, u, 0.5))
        prof = idle_profiled(p, steps=3)
        n = int(u.numel())
        log(f"{label}, {p.num_steps} steps: L1 {l1!r}, L2 {l2!r} against "
            f"the exact solution at t = 0.5; {us:.1f} us/step, "
            f"{n / us * 1e6:.4g} DOF-steps/s; {prof['kernels_per_step']:.1f}"
            f" kernels/step, idle share {prof['profiled_idle']:.4f} "
            f"(profiled, first 3 steps) ({card})")
        errs[(mesh, dtype)] = (l1, l2)
        out[label] = dict(steps=p.num_steps, l1=l1, l2=l2, us_per_step=us,
                          dof_steps_per_s=n / us * 1e6, **prof)
        if (mesh, dtype) == (100, "float64"):
            rel = {k: abs(v - BURGERS_SI_JAX_MESH100[k])
                   / BURGERS_SI_JAX_MESH100[k]
                   for k, v in (("l1", l1), ("l2", l2))}
            log(f"  against the C++ reference: L1 {l1:.6f} <= "
                f"{BURGERS_SI_CPP['l1'] * 1.35:.6f}, L2 {l2:.6f} <= "
                f"{BURGERS_SI_CPP['l2'] * 1.05:.6f}; against the JAX "
                f"package's {BURGERS_SI_JAX_MESH100['l1']!r}, "
                f"{BURGERS_SI_JAX_MESH100['l2']!r}: relative "
                f"{rel['l1']:.2e}, {rel['l2']:.2e} (gate {BURGERS_ERR_RTOL})")
            if (p.num_steps != BURGERS_SI_JAX_MESH100["num_steps"]
                    or not l1 <= BURGERS_SI_CPP["l1"] * 1.35
                    or not l2 <= BURGERS_SI_CPP["l2"] * 1.05
                    or not max(rel.values()) <= BURGERS_ERR_RTOL):
                raise AssertionError(f"{label}: L1 {l1}, L2 {l2}, relative "
                                     f"{rel}, {p.num_steps} steps")
    a, b = errs[(100, "float64")], errs[(200, "float64")]
    if not (b[0] < a[0] and b[1] < a[1]):
        raise AssertionError(f"burgers si: the f64 errors do not fall from "
                             f"mesh 100 {a} to mesh 200 {b}")
    p = burgers.build(burgers.BurgersConfig(mesh_size=50, backend="ell"))
    u, _, us = _ell_run(p, "burgers rv mesh 50 f64 ELL reference config")
    ref = np.load(os.path.join(REPO, "golden", "burgers_rv50_final.npy"))
    e = float(np.abs(u.cpu().numpy() - ref).max())
    log(f"burgers rv mesh 50 f64 reference config on the ELL backend, "
        f"{p.num_steps} steps: max|u - golden/burgers_rv50 last frame| = "
        f"{e:.3e} (gate {BURGERS_GOLDEN_TOL}); {us:.1f} us/step ({card})")
    if p.num_steps != 51 or not e <= BURGERS_GOLDEN_TOL:
        raise AssertionError(f"burgers rv ELL mesh 50: {p.num_steps} "
                             f"steps, {e} from the golden frame")
    out["burgers rv mesh 50 ELL"] = dict(golden_max_abs=e, us_per_step=us)
    return out


# ---------------------------------------------------------------------------
# Linear advection and the Pk layer (phase 8): no hand-written kernel
# ---------------------------------------------------------------------------

# advection_ho runs of ADVECTION_REFERENCE["ho"] (T = 1, CFL 0.5, gfem
# unless given)
HO_RUNS = {"p2_gfem_mesh8": dict(mesh_size=8, degree=2),
           "p2_gfem_mesh16": dict(mesh_size=16, degree=2),
           "p2_gfem_mesh8_curved": dict(mesh_size=8, degree=2,
                                        curved_boundary=True),
           "p2_gfem_mesh16_curved": dict(mesh_size=16, degree=2,
                                         curved_boundary=True),
           "p1_gfem_mesh8": dict(mesh_size=8, degree=1),
           "p3_gfem_mesh8": dict(mesh_size=8, degree=3),
           "p3_rv_simple_mesh4": dict(mesh_size=4, degree=3,
                                      stabilization="rv_simple")}


def _no_launch(label, fn):
    """fn() with the launch counts zeroed just before it and read just
    after it; raises if it launched a hand-written kernel."""
    import torch

    from conservation_fem_tpu_torch.ops import _build

    _build.launches.clear()
    out = fn()
    torch.cuda.synchronize()
    if _build.launches:
        raise AssertionError(f"{label}: launched hand-written kernels "
                             f"{dict(_build.launches)}; this path has none")
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


def _adv_check(label, err, steps, ref, card):
    """Gate one L2 error and step count against the JAX package's (within
    ADV_ERR_RTOL, or SPREAD_FACTOR x its own noise spread where it has
    one)."""
    rel = _rel(err, ref["error"])
    gate = (SPREAD_FACTOR * ref["noise_spread"] if "noise_spread" in ref
            else ADV_ERR_RTOL)
    log(f"{label}, {steps} steps: L2 error {err!r}, the JAX package's "
        f"{ref['error']!r}, relative {rel:.3e} (gate {gate:.3g}) "
        f"({card})")
    if steps != ref["steps"] or not rel <= gate:
        raise AssertionError(f"{label}: {steps} steps (JAX {ref['steps']}), "
                             f"error {err} off the JAX package's by {rel}")
    return dict(steps=steps, error=err, rel_to_jax=rel)


def run_advection_f64(card, device="cuda"):
    """(a) Linear advection's f64 reference config through
    linear_advection.run: the convergence sweep h = 1/4 ... 1/32 of gfem
    and rv_node (utils/convergence.run_convergence), each error within
    ADV_ERR_RTOL of the JAX package's and each slope within ADV_SLOPE_TOL
    of its; rv_cell (last-cell-wins), rv_node_simple, si and rk4 at mesh
    16 the same way. No hand-written launch; seconds of each run."""
    from conservation_fem_tpu_torch.models import linear_advection as la
    from conservation_fem_tpu_torch.utils.convergence import run_convergence

    out = {}
    for stab in ("gfem", "rv_node"):
        ref = ADVECTION_REFERENCE["sweep"][stab]
        runs = {}

        def err(n):
            t0 = time.perf_counter()
            r = _no_launch(f"advection {stab} mesh {n}", lambda: la.run(
                mesh_size=n, stabilization=stab, device=device))
            runs[n] = dict(steps=r.num_steps, error=float(r.error_l2),
                           seconds=time.perf_counter() - t0)
            return runs[n]["error"]

        c = run_convergence(err, ADV_SWEEP)
        rels = [_rel(e, r) for e, r in zip(c.errors, ref["errors"])]
        steps = [runs[n]["steps"] for n in ADV_SWEEP]
        d_slope = abs(c.slope - ref["slope"])
        log(f"advection {stab} f64 reference config, mesh {ADV_SWEEP}, "
            f"{steps} steps: L2 errors {[float(e) for e in c.errors]!r}, "
            f"the JAX package's {ref['errors']!r}, relative "
            f"{max(rels):.3e} at most (gate {ADV_ERR_RTOL}); slope "
            f"{c.slope!r}, the JAX package's {ref['slope']!r} (|diff| "
            f"{d_slope:.2e}, gate {ADV_SLOPE_TOL}); rates "
            f"{c.rates().tolist()!r}; seconds "
            f"{[round(runs[n]['seconds'], 2) for n in ADV_SWEEP]} ({card})")
        if (steps != ref["steps"] or not max(rels) <= ADV_ERR_RTOL
                or not d_slope <= ADV_SLOPE_TOL):
            raise AssertionError(f"advection {stab} sweep: steps {steps}, "
                                 f"relative errors {rels}, slope {c.slope}")
        out[stab] = dict(runs=runs, slope=c.slope, max_rel_to_jax=max(rels),
                         rates=c.rates().tolist())
    for stab, ref in ADVECTION_REFERENCE["mesh16"].items():
        t0 = time.perf_counter()
        r = _no_launch(f"advection {stab} mesh 16", lambda: la.run(
            mesh_size=16, stabilization=stab, device=device))
        out[f"{stab}_mesh16"] = _adv_check(
            f"advection {stab} mesh 16 f64 reference config",
            float(r.error_l2), r.num_steps, ref, card)
        out[f"{stab}_mesh16"]["seconds"] = time.perf_counter() - t0
    return out


def run_advection_f32(card):
    """(b) rv_node, one rotation on disk_mesh(1/64), f32 fixed-iteration
    Chebyshev config (ADV_FIXED): L2rel <= ADV_F32_GATE against the card's
    f64 adaptive end state on the same mesh; no hand-written launch;
    µs/step and DOF-steps/s (CUDA events around the one solve, after
    _repeats), kernels per step and idle share (torch.profiler, the first
    3 steps); the f64 run's µs/step beside it."""
    import torch

    from conservation_fem_tpu_torch.models import linear_advection as la
    from conservation_fem_tpu_torch.ops.mesh import disk_mesh

    n = ADV_F32_MESH
    m = disk_mesh(1.0 / n)
    cfg = la.AdvectionConfig(mesh_size=n, stabilization="rv_node")
    p64 = la.build(cfg, host_mesh=m)
    la.solve(_prefix(p64))       # the warm-up: the first REPEAT_STEPS steps
    u64, us64 = _no_launch("advection rv_node f64 mesh 64", lambda: _timed(
        lambda: la.solve(p64).u, p64.num_steps))
    p = la.build(dataclasses.replace(cfg, dtype="float32", **ADV_FIXED),
                 host_mesh=m)
    label = f"advection rv_node f32 fixed Chebyshev mesh {n}"
    q = _prefix(p)
    _repeats(label, lambda: la.solve(q).u)
    u, us = _no_launch(label, lambda: _timed(lambda: la.solve(p).u,
                                             p.num_steps))
    if not bool(torch.isfinite(u).all()):
        raise AssertionError(f"{label}: not finite")
    rel = float((u.double() - u64).norm() / u64.norm())
    err = float(la.l2_error_vs_ic(p, u))
    prof = idle_profiled(p, steps=3, solve=la.solve)
    STATES["advection_f64"] = (m, u64)
    STATES["advection_f32_us"] = us
    nodes = m.n_nodes
    log(f"{label} ({nodes} nodes), {p.num_steps} steps: L2rel {rel:.4e} "
        f"against the card's f64 adaptive end state (gate {ADV_F32_GATE}); "
        f"L2 error against the IC {err!r}; {us:.1f} us/step, "
        f"{nodes / us * 1e6:.4g} DOF-steps/s; "
        f"{prof['kernels_per_step']:.1f} kernels/step, idle share "
        f"{prof['profiled_idle']:.4f} (profiled, first 3 steps); f64 "
        f"adaptive {us64:.1f} us/step ({card})")
    if not rel <= ADV_F32_GATE:
        raise AssertionError(f"{label}: L2rel {rel} against f64")
    return dict(nodes=nodes, steps=p.num_steps, l2rel_vs_f64=rel,
                error_vs_ic=err, us_per_step=us,
                dof_steps_per_s=nodes / us * 1e6, f64_us_per_step=us64,
                hand_written_launches=0, **prof)


def run_pk_advection(card, device="cuda"):
    """(c) advection_ho through advection_ho.run, f64, T = 1 (HO_RUNS): P2
    gfem at mesh 8 and 16, straight and curved, the degree sweep 1, 2, 3
    at mesh 8 and P3 rv_simple at mesh 4, each error within ADV_ERR_RTOL
    of the JAX package's; P2 and P3 each below half of P1's error at mesh
    8 (tests/test_advection_ho.py)."""
    from conservation_fem_tpu_torch.models import advection_ho as ho

    out = {}
    for name, kw in HO_RUNS.items():
        t0 = time.perf_counter()
        p, _, err = _no_launch(f"advection_ho {name}", lambda: ho.run(
            ho.HOAdvectionConfig(**kw), device=device))
        ref = ADVECTION_REFERENCE["ho"][name]
        if p.space.ndof != ref["dofs"]:
            raise AssertionError(f"advection_ho {name}: {p.space.ndof} dofs")
        out[name] = _adv_check(f"advection_ho {name} ({ref['dofs']} dofs)",
                               err, p.num_steps, ref, card)
        out[name]["seconds"] = time.perf_counter() - t0
    e = {k: out[f"p{k}_gfem_mesh8"]["error"] for k in (1, 2, 3)}
    log(f"advection_ho degree sweep, gfem mesh 8: P1 {e[1]!r}, P2 "
        f"{e[2]!r}, P3 {e[3]!r} (P2 and P3 below P1 / 2) ({card})")
    if not (e[2] < e[1] / 2 and e[3] < e[1] / 2):
        raise AssertionError(f"advection_ho degree sweep: {e}")
    return out


def run_pk_burgers(card, device="cuda"):
    """(d) P2 SI Burgers (PK_BURGERS) through burgers.build(...).solve():
    the f64 default config at mesh 32, its steps and dofs the JAX
    package's and its L1 and L2 errors against the exact solution within
    SPREAD_FACTOR x the JAX package's own spread under a renumbering of
    the dofs, its L2rel against the anchor printed; the f32 fixed Chebyshev config (PK_BURGERS_FIXED) at
    mesh 32 gated at L2rel < PK_BURGERS_ANCHOR_GATE against the anchor.
    No hand-written launch."""
    from conservation_fem_tpu_torch.models import burgers

    ref = ADVECTION_REFERENCE["burgers_p2si"]
    anchor = np.load(os.path.join(REPO, "golden",
                                  "burgers_p2si_anchor_mesh32.npy"))
    an = lambda u: float(np.linalg.norm(u.double().cpu().numpy() - anchor)
                         / np.linalg.norm(anchor))
    p = burgers.build(burgers.BurgersConfig(mesh_size=32, **PK_BURGERS),
                      device=device)
    t0 = time.perf_counter()
    u = _no_launch("burgers P2 SI mesh 32 f64", lambda: p.solve().u)
    secs = time.perf_counter() - t0
    STATES["pk_burgers_f64"] = (u, secs)
    t = p.num_steps * p.dt
    l1 = float(burgers.l1_error_vs_exact(p, u, t))
    l2 = float(burgers.l2_error_vs_exact(p, u, t))
    rel = max(_rel(l1, ref["l1"]), _rel(l2, ref["l2"]))
    spread = max(_rel(ref["rcm_l1"], ref["l1"]), _rel(ref["rcm_l2"],
                                                     ref["l2"]))
    gate = SPREAD_FACTOR * spread
    a64 = an(u)
    log(f"burgers P2 SI mesh 32 f64 default config ({u.numel()} dofs), "
        f"{p.num_steps} steps: L1 {l1!r}, L2 {l2!r} against the exact "
        f"solution at t = {t!r}; the JAX package's {ref['l1']!r}, "
        f"{ref['l2']!r}: relative {rel:.3e} at most (gate {gate:.3g}: "
        f"{SPREAD_FACTOR} x {spread:.3e}, the JAX package's own spread); "
        f"L2rel against "
        f"golden/burgers_p2si_anchor_mesh32.npy {a64:.4e} (the JAX "
        f"package's {ref['anchor_l2rel']:.4e}); {secs:.2f} s ({card})")
    if ((p.num_steps, u.numel(), p.dt) != (ref["steps"], ref["dofs"],
                                           ref["dt"])
            or not rel <= gate):
        raise AssertionError(f"burgers P2 SI f64: {p.num_steps} steps, "
                             f"{u.numel()} dofs, dt {p.dt}, relative {rel}")
    q = burgers.build(burgers.BurgersConfig(
        mesh_size=32, dtype="float32", **PK_BURGERS, **PK_BURGERS_FIXED),
        device=device)
    uq = _no_launch("burgers P2 SI mesh 32 f32", lambda: q.solve().u)
    a32 = an(uq)
    q_at = copy.copy(q)
    q_at.num_steps = PK_BURGERS_ANCHOR_STEPS
    a32_at = an(_no_launch("burgers P2 SI mesh 32 f32, the anchor's steps",
                           lambda: q_at.solve().u))
    log(f"burgers P2 SI mesh 32 f32 fixed Chebyshev config, {q.num_steps} "
        f"steps (the JAX package's count; t = {q.num_steps * q.dt!r}): "
        f"L2rel against the anchor {a32:.4e} (gate "
        f"{PK_BURGERS_ANCHOR_GATE}); after {PK_BURGERS_ANCHOR_STEPS} steps, "
        f"the anchor's (t = {PK_BURGERS_ANCHOR_STEPS * q.dt!r}): "
        f"{a32_at:.4e}, printed ({card})")
    if not a32 < PK_BURGERS_ANCHOR_GATE:
        raise AssertionError(f"burgers P2 SI f32: L2rel {a32}")
    return dict(f64=dict(steps=p.num_steps, dofs=u.numel(), l1=l1, l2=l2,
                         rel_to_jax=rel, anchor_l2rel=a64, seconds=secs),
                f32=dict(steps=q.num_steps, anchor_l2rel=a32,
                         anchor_steps=PK_BURGERS_ANCHOR_STEPS,
                         anchor_l2rel_at_anchor_steps=a32_at))


def time_pk_burgers(card):
    """(d) P2 SI Burgers at mesh PK_BURGERS_TIMED_MESH, f32 fixed
    Chebyshev config: finite, no hand-written launch, µs/step and
    DOF-steps/s (CUDA events around the one solve, after _repeats),
    kernels per step and idle share (torch.profiler, the first 3
    steps)."""
    import torch

    from conservation_fem_tpu_torch.models import burgers

    n = PK_BURGERS_TIMED_MESH
    p = burgers.build(burgers.BurgersConfig(
        mesh_size=n, dtype="float32", **PK_BURGERS, **PK_BURGERS_FIXED))
    label = f"burgers P2 SI mesh {n} f32 fixed Chebyshev config"
    q = _prefix(p)
    _repeats(label, lambda: q.solve().u)
    u, us = _no_launch(label, lambda: _timed(lambda: p.solve().u,
                                             p.num_steps))
    if not bool(torch.isfinite(u).all()):
        raise AssertionError(f"{label}: not finite")
    prof = idle_profiled(p, steps=3)
    dofs = int(u.numel())
    log(f"{label} ({dofs} dofs), {p.num_steps} steps: {us:.1f} us/step, "
        f"{dofs / us * 1e6:.4g} DOF-steps/s; {prof['kernels_per_step']:.1f} "
        f"kernels/step, idle share {prof['profiled_idle']:.4f} (profiled, "
        f"first 3 steps) ({card})")
    return dict(dofs=dofs, steps=p.num_steps, us_per_step=us,
                dof_steps_per_s=dofs / us * 1e6, hand_written_launches=0,
                **prof)


def advection_phase(card):
    """Phase 8: (a) - (d); {part: readings}."""
    return dict(advection_f64=run_advection_f64(card),
                advection_f32=run_advection_f32(card),
                pk_advection=run_pk_advection(card),
                pk_burgers=run_pk_burgers(card),
                pk_burgers_timed=time_pk_burgers(card))


# ---------------------------------------------------------------------------
# phase 9: compressible Euler and Stokes/IPCS (no hand-written kernel)
# ---------------------------------------------------------------------------


def _l2rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _euler_run(card, prob, nx, dtype, backend="auto"):
    """One Euler run through euler.build(...) and euler.solve: the JAX
    package's steps and dt, the first REPEAT_STEPS steps twice and
    bit-equal, then one solve with no hand-written launch, timed (CUDA
    events), the first 3 steps profiled. (end state (N,4) f64 numpy,
    readings)."""
    import torch

    from conservation_fem_tpu_torch.models import euler

    ref = EULER_STOKES_REFERENCE["euler"][f"{prob}:{nx}"]
    name = "stencil" if backend == "auto" else backend
    label = f"euler {prob}:{nx} {dtype} {name}"
    t0 = time.perf_counter()
    p = euler.build(euler.EulerConfig(problem=prob, nx=nx, dtype=dtype,
                                      backend=backend))
    build_s = time.perf_counter() - t0
    k = min(REPEAT_STEPS, p.num_steps)
    _repeats(label, lambda: euler.solve(p, num_steps=k).U)
    U, us = _no_launch(label, lambda: _timed(lambda: euler.solve(p).U,
                                             p.num_steps))
    nodes = int(U.shape[0])
    if (p.num_steps, p.dt, nodes) != (ref["steps"], ref["dt"], ref["nodes"]):
        raise AssertionError(f"{label}: {p.num_steps} steps, dt {p.dt}, "
                             f"{nodes} nodes; the JAX package's {ref}")
    if not bool(torch.isfinite(U).all()):
        raise AssertionError(f"{label}: not finite")
    prof = profiled(lambda: euler.solve(p, num_steps=3), 3)
    row = dict(nodes=nodes, steps=p.num_steps, build_s=build_s,
               us_per_step=us, dof_steps_per_s=nodes / us * 1e6,
               hand_written_launches=0, **prof)
    log(f"{label} ({nodes} nodes), {p.num_steps} steps: {us:.1f} us/step, "
        f"{nodes / us * 1e6:.4g} DOF-steps/s; "
        f"{prof['kernels_per_step']:.1f} kernels/step, idle share "
        f"{prof['profiled_idle']:.4f} (profiled, first 3 steps); build "
        f"{build_s:.2f} s ({card})")
    return U.double().cpu().numpy(), row


def run_euler(card):
    """Phase 9 Euler: EULER_CELLS in f32 against their anchors (gate
    EULER_GATE); EULER_F64 in f64 against the same anchors, the state
    rounded to f32 (gate max(EULER_F64_GATE, SPREAD_FACTOR x the JAX
    package's own spread)); riemann2d 128 f64 on the ELL backend against
    the stencil run (the same gate)."""
    out, f64 = {}, {}
    anchor = lambda prob, nx: np.load(os.path.join(
        REPO, "golden", f"euler_{prob}_anchor_nx{nx}.npy")).astype(
            np.float64)
    for prob, nx in EULER_CELLS:
        U, row = _euler_run(card, prob, nx, "float32")
        rel = _l2rel(U, anchor(prob, nx))
        log(f"euler {prob}:{nx} f32: L2rel against the f64 anchor "
            f"{rel:.4e} (gate {EULER_GATE}) ({card})")
        if not rel < EULER_GATE:
            raise AssertionError(f"euler {prob}:{nx} f32: L2rel {rel}")
        out[f"{prob}:{nx} f32"] = dict(l2rel_vs_anchor=rel, **row)
    for prob, nx in EULER_F64:
        ref = EULER_STOKES_REFERENCE["euler"][f"{prob}:{nx}"]
        U, row = _euler_run(card, prob, nx, "float64")
        a = anchor(prob, nx)
        rel = _l2rel(U.astype(np.float32).astype(np.float64), a)
        gate = max(EULER_F64_GATE, SPREAD_FACTOR * ref["f64_noise_spread"])
        log(f"euler {prob}:{nx} f64: L2rel against the anchor, rounded to "
            f"f32 as it is stored, {rel:.4e} (gate {gate:.3g}; the JAX "
            f"package's {ref['f64_l2rel_f32_rounded']:.4e}, its own spread "
            f"{ref['f64_noise_spread']:.3e}); unrounded {_l2rel(U, a):.4e} "
            f"(the JAX package's {ref['f64_l2rel']:.4e}) ({card})")
        if not rel <= gate:
            raise AssertionError(f"euler {prob}:{nx} f64: L2rel {rel}")
        out[f"{prob}:{nx} f64"] = dict(l2rel_vs_anchor_f32_rounded=rel,
                                       l2rel_vs_anchor=_l2rel(U, a), **row)
        f64[(prob, nx)] = U
    prob, nx = EULER_ELL
    ref = EULER_STOKES_REFERENCE["euler"][f"{prob}:{nx}"]
    U, row = _euler_run(card, prob, nx, "float64", backend="ell")
    rel = _l2rel(U, f64[(prob, nx)])
    gate = max(EULER_F64_GATE, SPREAD_FACTOR * ref["f64_noise_spread"])
    log(f"euler {prob}:{nx} f64 ELL against the stencil run: L2rel "
        f"{rel:.4e} (gate {gate:.3g}) ({card})")
    if not rel <= gate:
        raise AssertionError(f"euler {prob}:{nx} ELL: L2rel {rel}")
    out[f"{prob}:{nx} f64 ell"] = dict(l2rel_vs_stencil=rel, **row)
    return out


def _stokes_stepper(**kw):
    """(problem, run): run(n) marches n IPCS steps from rest with the
    operators built once (stokes.make_step) and returns (u, p)."""
    from conservation_fem_tpu_torch.models import stokes

    p, fd = stokes.build(stokes.StokesConfig(**kw))
    step = stokes.make_step(p, fd)

    def run(n):
        c = (p.u0, p.p0)
        for _ in range(n):
            c = step(c)
        return c
    return p, run


def _stokes_timed(card, label, n, **kw):
    """One Stokes configuration: the first STOKES_REPEAT_STEPS steps
    twice and bit-equal, then n steps with no hand-written launch, timed
    (CUDA events), the first 3 steps profiled. (u (2,N2) f64 numpy,
    readings)."""
    import torch

    t0 = time.perf_counter()
    p, run = _stokes_stepper(**kw)
    build_s = time.perf_counter() - t0
    _repeats(label, lambda: run(min(STOKES_REPEAT_STEPS, n))[0])
    (u, pr), us = _no_launch(label, lambda: _timed(lambda: run(n), n))
    if not bool(torch.isfinite(u).all()):
        raise AssertionError(f"{label}: not finite")
    prof = profiled(lambda: run(3), 3)
    dofs = int(u.numel() + pr.numel())
    row = dict(dofs=dofs, steps=n, build_s=build_s, us_per_step=us,
               dof_steps_per_s=dofs / us * 1e6, hand_written_launches=0,
               **prof)
    log(f"{label} ({dofs} dofs), {n} steps: {us:.1f} us/step, "
        f"{dofs / us * 1e6:.4g} DOF-steps/s; {prof['kernels_per_step']:.1f} "
        f"kernels/step, idle share {prof['profiled_idle']:.4f} (profiled, "
        f"first 3 steps); build {build_s:.2f} s ({card})")
    return u.double().cpu().numpy(), row


def stokes_oracle(card):
    """Phase 9 Stokes (a): the f64 reference config through stokes.solve
    against the JAX package's Poiseuille L2 error; its first
    STOKES_TIMED_ORACLE_STEPS steps timed."""
    from conservation_fem_tpu_torch.models import stokes

    ref = EULER_STOKES_REFERENCE["stokes"]["reference_error_l2"]
    gate = max(STOKES_ORACLE_RTOL, SPREAD_FACTOR
               * EULER_STOKES_REFERENCE["stokes"]["noise_spread"])
    t0 = time.perf_counter()
    r = _no_launch("stokes reference config",
                   lambda: stokes.solve(cfg=stokes.StokesConfig()))
    secs = time.perf_counter() - t0
    rel = _rel(r.error_l2, ref)
    _, timed = _stokes_timed(card, "stokes reference config, its first "
                             f"{STOKES_TIMED_ORACLE_STEPS} steps",
                             STOKES_TIMED_ORACLE_STEPS)
    log(f"stokes reference config (nx 10, {r.num_steps} steps to T = 10, "
        f"ell, adaptive, f64): Poiseuille L2 error {r.error_l2!r}, the JAX "
        f"package's {ref!r}, relative {rel:.3e} (gate {gate:.3g}: "
        f"{STOKES_ORACLE_RTOL} or {SPREAD_FACTOR} x the JAX package's own "
        f"spread); {secs:.2f} s with the build ({card})")
    if not rel <= gate:
        raise AssertionError(f"stokes oracle: error {r.error_l2}, relative "
                             f"{rel}")
    return dict(error_l2=r.error_l2, rel_to_jax=rel, gate=gate,
                seconds=secs, timed=timed)


def stokes_identity(card):
    """Phase 9 Stokes (b): lattice and lattice + multigrid against ell,
    f64 (STOKES_IDENTITY)."""
    out = {}
    n = STOKES_IDENTITY["num_steps"]
    kw = dict(STOKES_IDENTITY)
    tag = f"stokes nx {kw['nx']} f64"
    base, out["identity ell"] = _stokes_timed(card, f"{tag} ell", n, **kw)
    for name, over in (("lattice", dict(backend="lattice")),
                       ("lattice mg", dict(backend="lattice",
                                           multigrid=True))):
        u, row = _stokes_timed(card, f"{tag} {name}", n, **kw, **over)
        d = float(np.abs(u - base).max())
        log(f"{tag} {name} against ell after {n} steps: Linf {d:.3e} (gate "
            f"{STOKES_IDENTITY_GATE}) ({card})")
        if not d <= STOKES_IDENTITY_GATE:
            raise AssertionError(f"stokes {name}: Linf {d} against ell")
        out[f"identity {name}"] = dict(linf_vs_ell=d, **row)
    return out


def stokes_bench(card):
    """Phase 9 Stokes (c): the five f32 variants of bench_stokes.py at
    STOKES_BENCH_NX, each against the ell run after the same steps."""
    out = {}
    n = STOKES_BENCH["num_steps"]
    for nx in STOKES_BENCH_NX:
        kw = dict(nx=nx, **STOKES_BENCH)
        ki = max(25, nx)
        base, out[f"nx {nx} ell"] = _stokes_timed(
            card, f"stokes nx {nx} f32 ell adaptive", n, **kw)
        for name, over, gate in (
                ("lattice adaptive", dict(backend="lattice"),
                 STOKES_ADAPTIVE_GATE),
                (f"lattice fixed ki={ki} kip={3 * nx}",
                 dict(backend="lattice", krylov_iters=ki),
                 STOKES_FIXED_GATE),
                ("lattice mg adaptive", dict(backend="lattice",
                                             multigrid=True),
                 STOKES_ADAPTIVE_GATE),
                ("lattice mg fixed ki=6 kip=6",
                 dict(backend="lattice", multigrid=True, krylov_iters=6),
                 STOKES_FIXED_GATE)):
            u, row = _stokes_timed(card, f"stokes nx {nx} f32 {name}", n,
                                   **kw, **over)
            d = float(np.abs(u - base).max())
            log(f"stokes nx {nx} f32 {name} against ell after {n} steps: "
                f"Linf {d:.3e} (gate {gate}) ({card})")
            if not d <= gate:
                raise AssertionError(f"stokes nx {nx} {name}: Linf {d}")
            out[f"nx {nx} {name}"] = dict(linf_vs_ell=d, **row)
    return out


def euler_stokes_phase(card):
    """Phase 9: Euler, then Stokes (a) - (c); {part: readings}."""
    return dict(euler=run_euler(card), stokes_oracle=stokes_oracle(card),
                stokes_identity=stokes_identity(card),
                stokes_bench=stokes_bench(card))


def _device_spans(prof):
    """(start, end) in µs of each device activity (kernels, copies, sets)
    that the finished torch.profiler ``prof`` recorded, read from its
    kineto events as prof.events() reads them (hidden and memory records
    left out) without building its FunctionEvents, which costs seconds a
    profile of a few thousand kernels."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ns = [(e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and not e.name().startswith("[")
          and not getattr(e, "is_hidden_event", lambda: False)()]
    t0 = min((s for s, _ in ns), default=0)    # exact in integers
    return [((s - t0) / 1e3, (e - t0) / 1e3) for s, e in ns]


def _busy_us(spans):
    """Microseconds covered by the union of the (start, end) spans."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
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
    kernels = _device_spans(prof)
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


def against(other, card, ell_only=False):
    """{case: times} of the single and block kernels, cg_solve and the ELL
    kernels A-D (``ell_only``: those alone) of the tree in `other` and
    of this one, in turns (other, this, this, other, twice), one process
    each (scripts/torch_kernel_times.py; the first makes the inputs). A
    wrapper's host time is also given over the mean ratio of the controls
    (torch's code alone, the same in both trees): what the two processes
    differ by apart from the wrappers."""
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
                            out] + (["--ell"] if ell_only else []),
                           check=True, cwd=tree)
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
    controls = [r["ratio"] for k, r in rows.items() if k.startswith(
        "control, the same code in both trees")]
    if controls:
        c = sum(controls) / len(controls)
        for name, r in rows.items():
            if name.endswith("host time a wrapper call"):
                r["ratio_over_controls"] = r["ratio"] / c
                log(f"against {other}: {name}: ratio {r['ratio']:.4f} over "
                    f"the controls' {c:.4f}: {r['ratio'] / c:.4f} ({card})")
    return rows


# ---------------------------------------------------------------------------
# phase 10: the unstructured fast path (banded, blocked, blocked2d) on the
# hand-written ELL kernels (csrc/ell.cu)
# ---------------------------------------------------------------------------

# name: (source, the JAX function it stands in for; no pallas_call)
ELL_KERNELS = {
    "ell_spmv": ("ell.cu", "ops/blocked.py:564 (spmv; ops/banded.py:64 "
                           "banded_matvec; no pallas_call)"),
    "ell_assemble": ("ell.cu", "ops/blocked.py:641 (assemble_matrix_"
                               "components; :611 scatter_components; no "
                               "pallas_call)"),
    "p1_newton_locals": ("ell.cu", "ops/blocked.py:741 (conv_plus_locals_"
                                   "rhs_components; :775, :789; no "
                                   "pallas_call)"),
    "ell_rv_epsilon": ("ell.cu", "ops/blocked.py:876 (rv_epsilon_nonlinear; "
                                 "no pallas_call)"),
}
# the meshes of each backend's KPP RV f32 bench-config runs (IRR, IRR_FIXED)
BLOCKED_PATHS = {"blocked": (140, 224, 316, 448, 640),
                 "blocked2d": (140, 640)}
# the turns a run is timed in, the counted solve the first (after two
# solves of REPEAT_STEPS steps, the warm-up): blocked, gather, blocked at
# irr140 and irr640; blocked, gather at the mid sizes; blocked2d at irr140
# once, untimed against gather (the smoke run's time limit)
BLOCKED_TURNS = {("blocked", 140): 3, ("blocked", 640): 3,
                 ("blocked2d", 640): 3, ("blocked2d", 140): 1}
BLOCKED_VS_GATHER_F64 = 1e-9
ELL_F32_RTOL = 1e-5          # a kernel against its plain version, f32
ELL_KERNEL_MESHES = (140, 640)
# operations a P1 cell of kernel C does (Dunavant degree 4, 6 points; the
# flux's own operations per point, FLUX_POINT_OPS, added): the gradient
# 12, per point u_q 5, f' and f'' 2, conv 3, f'' . grad u 3, the rhs 9
# and in Jacobian mode the 9 locals 63; K_eps 40, the rhs 24, the
# Jacobian's assembly 45
OPS_LOCALS_RHS = 12 + 6 * 22 + 40 + 24
OPS_LOCALS_JAC = OPS_LOCALS_RHS + 6 * 63 + 45


def blocked_launches(cfg, steps, flux="kpp"):
    """The hand-written launches the blocked P1 step makes in ``steps``
    steps of cfg (HyperbolicConfig fields; fixed-iteration solvers): per
    step, N(u_n) (C, B) and the mass projection (A: 1 + cg_iters) under
    RV, the RV kernel (D), NK(u_n) (C, B), each Newton residual (A, C, B)
    and each linearisation (C, B), and the inner products (A, constrained:
    2 a BiCGStab iteration, 1 a Chebyshev one)."""
    from conservation_fem_tpu_torch.ops import _build

    rv = cfg.stabilization == "rv"
    res = 1 + cfg.newton_iters - (0 if cfg.newton_final_residual else 1)
    jac = 1 if cfg.modified_newton else cfg.newton_iters
    lin = 2 if cfg.inner_solver == "bicgstab" else 1
    spmv = ((1 + cfg.cg_iters) if rv else 0) + res \
        + cfg.newton_iters * lin * cfg.newton_linear_iters
    loc = (1 if rv else 0) + 1 + res + jac
    want = {"ell_spmv": spmv, "ell_assemble": loc,
            _build.launch_key("p1_newton_locals", flux): loc}
    if rv:
        want[_build.launch_key("ell_rv_epsilon", flux)] = 1
    return {k: v * steps for k, v in want.items()}


def _blocked_cfg(kpp, nx, backend, **kw):
    dt, T = IRR[nx]
    return kpp.KPPConfig(**{**dict(dtype="float32", dt=dt, T=T,
                                   backend="ell", ell_matvec_backend=backend,
                                   **IRR_FIXED), **kw})


def run_blocked_paths(card, meshes):
    """(b) KPP RV, f32 bench config, on the blocked backend at irr140 ...
    irr640 and on blocked2d at irr140 and irr640 (the RCM mesh tiled,
    gated through slot_of_node): L2rel <= IRR_GATE against each anchor,
    the gather run's step count, repeated solves bit-equal, the launch
    counts of each kernel against blocked_launches; µs/step (CUDA events)
    in turns with the gather run on the same mesh (BLOCKED_TURNS),
    DOF-steps/s, kernels per step and idle share
    (torch.profiler, the first 3 steps). Returns (readings, {nx: (p, u)}
    of the blocked runs at ELL_KERNEL_MESHES, irr640's counts)."""
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.ops.tiling import tile_mesh

    out, states, main_counts = {}, {}, None
    for backend, nxs in BLOCKED_PATHS.items():
        for nx in nxs:
            m, slot = meshes[nx], None
            t0 = time.perf_counter()
            if backend == "blocked2d":
                m, slot = tile_mesh(m)
            p = kpp.build(_blocked_cfg(kpp, nx, backend), host_mesh=m)
            setup = time.perf_counter() - t0
            g = kpp.build(_blocked_cfg(kpp, nx, "gather"),
                          host_mesh=meshes[nx])
            label = f"{backend} irr{nx} f32 bench config"
            if p.num_steps != g.num_steps:
                raise AssertionError(f"{label}: {p.num_steps} steps, gather "
                                     f"{g.num_steps}")
            pre = _prefix(p)              # M, h_cg: set-up, not steps
            _repeats(label, lambda: pre.solve().u)
            # the counted solve is the first of the turns (BLOCKED_TURNS)
            u, counts, t = _counted_timed(lambda: p.solve().u, p.num_steps)
            want = blocked_launches(p.cfg, p.num_steps)
            if counts != want:
                raise AssertionError(f"{label}: launched {counts}, the code "
                                     f"predicts {want}")
            un = u if slot is None else u[torch.as_tensor(slot,
                                                          device=u.device)]
            rel, lo, hi, _, _ = _irr_gate(un, nx, label)
            # timed in turns (BLOCKED_TURNS); a blocked solve after the
            # counted one repeats its bits
            us = {backend: [t]}
            turns = (("gather", g), (backend, p))
            for name, q in turns[:BLOCKED_TURNS.get((backend, nx), 2) - 1]:
                got, t = _timed(lambda: q.solve().u, q.num_steps)
                us.setdefault(name, []).append(t)
                if q is p and not torch.equal(got, u):
                    raise AssertionError(f"{label}: repeated solves differ")
            us = {k: sum(v) / len(v) for k, v in us.items()}
            gus = us.get("gather")
            prof = idle_profiled(p, steps=3)
            n = int(p.plan.row_valid.sum()) if slot is not None else m.n_nodes
            per_step = {k: v / p.num_steps for k, v in counts.items()}
            out[f"{backend}_irr{nx}"] = dict(
                nodes=n, slots=m.n_nodes, steps=p.num_steps, l2rel=rel,
                u_min=lo, u_max=hi, us_per_step=us[backend],
                gather_us_per_step=gus,
                speedup_vs_gather=None if gus is None else gus / us[backend],
                dof_steps_per_s=n / us[backend] * 1e6,
                launches_per_step=per_step, setup_s=setup,
                bandwidth=p.plan.B, **prof)
            log(f"{label} ({n} nodes"
                + (f" in {m.n_nodes} slots" if slot is not None
                   else f", bandwidth {p.plan.B}")
                + f"), {p.num_steps} steps: L2rel {rel:.4e} against "
                f"golden/kpp_rv_anchor_irr{nx}.npy (gate {IRR_GATE}); u in "
                f"[{lo:.4f}, {hi:.4f}]; repeated solve bit-equal; launches "
                f"per step {per_step} (as predicted); {us[backend]:.1f} "
                f"us/step"
                + ("" if gus is None else f" against gather {gus:.1f} in "
                   f"turns ({gus / us[backend]:.3f} x)")
                + f", {n / us[backend] * 1e6:.4g} DOF-steps/s; "
                f"{prof['kernels_per_step']:.1f} kernels/step, idle share "
                f"{prof['profiled_idle']:.4f} (profiled, first 3 steps); "
                f"set-up {setup:.1f} s ({card})")
            if backend == "blocked" and nx in ELL_KERNEL_MESHES:
                states[nx] = (p, u)
            if backend == "blocked" and nx == 640:
                main_counts = counts
    return out, states, main_counts


def _ell_bounds(n, nnz, M, s, a_cols, d_cols):
    """{kernel: (bytes, operations)} of one call at these sizes (each input
    read once, each output written once; s the float size; nnz the stored
    entries of the patches, the ELL padding left out, as a CSR form of the
    same operator needs none of it): A constrained (nnz values, nnz columns
    of a_cols bytes, the copy that ell_kernels.spmv_columns gives it, x,
    the bc mask, y; a multiply-add per entry), B matrix mode (9M locals and
    their int32 order, a uint8 offset per entry, an int32 base per row and
    one more, the nnz outputs; an add per local; its tile index, 8 bytes a
    tile of ~1,500 locals, left out), C Jacobian mode (cells,
    area, grads, u, eps in; 3 + 9 locals out), D (nnz columns of d_cols
    bytes, ell_kernels.rv_columns, u_n, Rh, h, the abs term; eps out; 3
    compares per entry, 10 per node)."""
    return {
        "ell_spmv": (nnz * (s + a_cols) + n * (2 * s + 1), 2 * nnz),
        "ell_assemble": (9 * M * (s + 4) + nnz + (n + 1) * 4 + nnz * s,
                         9 * M),
        "p1_newton_locals": (3 * M * 4 + 7 * M * s + 2 * n * s
                             + 12 * M * s, OPS_LOCALS_JAC * M),
        "ell_rv_epsilon": (nnz * d_cols + 4 * n * s + s, 3 * nnz + 10 * n),
    }


def _assemble_vector_bound(n, M, s):
    """(bytes, operations) of B's vector mode: 3M locals and their int32
    order, a uint8 offset per node, an int32 base per VEC_GROUP nodes and
    one more, n outputs; an add per local."""
    from conservation_fem_tpu_torch.ops.mesh import VEC_GROUP

    return (3 * M * (s + 4) + n + (n // VEC_GROUP + 1) * 4 + n * s, 3 * M)


def assemble_launches(cfg):
    """(matrix mode, vector mode) launches of B a step of the blocked P1
    step (blocked_launches): the linearisations assemble matrices, N(u_n),
    NK(u_n) and the residuals vectors."""
    total = blocked_launches(cfg, 1)["ell_assemble"]
    matrix = 1 if cfg.modified_newton else cfg.newton_iters
    return matrix, total - matrix


def _rel_err(a, b):
    """(max|a - b|, max|a - b| / max|b|), in f64."""
    e = float((a.double() - b.double()).abs().max())
    return e, e / float(b.double().abs().max())


# the ELL kernels' timing: calls on one CUDA graph, and the operand sets a
# graph rotates over to read from a cold L2 (their bytes at least twice the
# 50 MB L2, and at least 2 sets)
ELL_GRAPH_REPS = 100
ELL_COLD_BYTES = 100e6
# the index and geometry fields of a mesh a set clones
ELL_SET_FIELDS = ("patch_cols32", "patch_cols_bc32", "patch_cols_d16",
                  "cells32", "mat_perm32", "mat_off8", "mat_base32",
                  "mat_tile32", "vec_perm32", "vec_off8", "vec_base32",
                  "vec_tile32",
                  "area", "grads", "boundary_mask", "mat_lens")


def _ell_set(base, clone):
    """One operand set of the timed ELL calls: the tensors of ``base`` (m,
    u, J, jac, rhs, eps, rh, h, abs_term) and, derived from them, A's torch
    CSR yardstick, B's locals in the sorted order (torch.segment_reduce's
    input) and B's f64 locals (jac64); ``clone``: every tensor copied, the
    mesh's ELL_SET_FIELDS too."""
    import torch

    m = base["m"]
    if clone:
        m = m._replace(**{f: getattr(m, f).clone() for f in ELL_SET_FIELDS
                          if getattr(m, f) is not None})
    s = {k: (v.clone() if clone else v) for k, v in base.items() if k != "m"}
    s["m"] = m
    n = m.patch_cols.shape[0]
    mask = m.patch_mask
    crow = torch.zeros(n + 1, dtype=torch.int64, device=s["u"].device)
    crow[1:] = torch.cumsum(mask.sum(1), 0)
    s["csr"] = torch.sparse_csr_tensor(crow, m.patch_cols[mask],
                                       s["J"][mask], (n, n))
    s["flat"] = s["jac"].reshape(-1)[m.mat_perm]
    s["jac64"] = s["jac"].double()
    return s


def _set_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _on_graph(fn, sets, n_cold):
    """(warm ms, L2-cold ms): fn(set) on a CUDA graph of ELL_GRAPH_REPS
    calls on sets[0], and rotating over sets[:n_cold]. A call that cannot
    be captured raises."""
    import itertools

    turn = itertools.cycle(sets[:n_cold])
    return (graph_ms(lambda: fn(sets[0]), ELL_GRAPH_REPS),
            graph_ms(lambda: fn(next(turn)), ELL_GRAPH_REPS))


def _library_times(what, fn, sets, n_cold):
    """(warm ms, L2-cold ms, how) of a library call: on a CUDA graph as
    _on_graph, or, where it cannot be captured, said so and timed over as
    many calls back to back (CUDA events)."""
    import itertools

    try:
        return _on_graph(fn, sets, n_cold) + ("CUDA graph",)
    except RuntimeError as e:
        log(f"{what} cannot be captured on a CUDA graph ({e}); timed over "
            f"{ELL_GRAPH_REPS} calls back to back instead")
        turn = itertools.cycle(sets[:n_cold])
        return (cuda_ms(lambda: fn(sets[0]), ELL_GRAPH_REPS),
                cuda_ms(lambda: fn(next(turn)), ELL_GRAPH_REPS),
                "calls back to back")


def time_ell_kernels(base, half, bounds, cfg, card):
    """{kernel: times} of A-D at one state (irr640 f32): warm (one operand
    set) and L2-cold (a graph rotating over sets whose operands together
    reach ELL_COLD_BYTES) on a CUDA graph of ELL_GRAPH_REPS calls; per
    wrapper call back to back (the host's cost: checks, allocation, ctypes);
    the plain version per call; the library call (A: torch's CSR product,
    B: torch.segment_reduce over the sorted locals) timed as the kernel is;
    the bound; A and D on their int32 columns too (their fallback where a
    mesh has no int16 codes); B in vector mode and in f64 (whose locals
    exceed the L2).
    Then the rule-2 ranking: kernels slower L2-cold than their library
    call first, then by the time lost a step, launches x (L2-cold -
    bound), B's by mode."""
    import math

    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.ops import assembly
    from conservation_fem_tpu_torch.ops import ell_kernels as ek

    flux = kpp.FLUX
    m = base["m"]
    kernels = {
        "ell_spmv": (lambda s: ek.ell_spmv(s["m"], s["J"], s["u"], True),
                     lambda s: ek.ell_spmv_plain(s["m"], s["J"], s["u"],
                                                 True),
                     lambda s: (s["J"], ek.spmv_columns(s["m"]), s["u"],
                                s["m"].boundary_mask)),
        "ell_assemble": (lambda s: ek.assemble_matrix(s["m"], s["jac"]),
                         lambda s: assembly.scatter_matrix(s["m"], s["jac"]),
                         lambda s: (s["jac"], s["m"].mat_perm32,
                                    s["m"].mat_off8, s["m"].mat_base32,
                                    s["m"].mat_tile32)),
        "p1_newton_locals": (
            lambda s: ek.p1_newton_locals(s["m"], s["u"], s["eps"], half,
                                          flux, True),
            lambda s: ek.p1_newton_locals_plain(s["m"], s["u"], s["eps"],
                                                half, flux, True),
            lambda s: (s["m"].cells32, s["m"].area, s["m"].grads, s["u"],
                       s["eps"])),
        "ell_rv_epsilon": (
            lambda s: ek.ell_rv_epsilon(s["m"], 0.5, 4.0, s["u"], s["rh"],
                                        s["u"], s["h"], s["abs_term"], flux),
            lambda s: ek.ell_rv_epsilon_plain(s["m"], 0.5, 4.0, s["u"],
                                              s["rh"], s["u"], s["h"],
                                              s["abs_term"], flux),
            lambda s: (ek.rv_columns(s["m"]), s["u"], s["rh"], s["h"])),
    }
    library = {
        "ell_spmv": ("torch CSR product", lambda s: s["csr"] @ s["u"],
                     lambda s: (s["csr"].crow_indices(),
                                s["csr"].col_indices(), s["csr"].values(),
                                s["u"])),
        "ell_assemble": ("torch.segment_reduce over the sorted locals",
                         lambda s: torch.segment_reduce(
                             s["flat"], "sum", lengths=s["m"].mat_lens,
                             unsafe=True),
                         lambda s: (s["flat"], s["m"].mat_lens)),
    }
    first = _ell_set(base, clone=False)
    # the yardsticks compute the kernels' functions
    if not _rel_err(library["ell_spmv"][1](first),
                    ek.ell_spmv(m, base["J"], base["u"]))[1] <= ELL_F32_RTOL:
        raise AssertionError("CSR yardstick differs")
    if not _rel_err(library["ell_assemble"][1](first),
                    ek.assemble_matrix(m, base["jac"]).reshape(-1))[1] \
            <= ELL_F32_RTOL:
        raise AssertionError("segment_reduce yardstick differs")
    need = lambda b: max(2, math.ceil(ELL_COLD_BYTES / b))
    n_sets = max(need(_set_bytes(*v[2](first)))
                 for v in list(kernels.values()) + list(library.values()))
    sets = [first] + [_ell_set(base, clone=True) for _ in range(n_sets - 1)]
    per_step = blocked_launches(cfg, 1)
    out = {}
    for name, (fn, plain, ops) in kernels.items():
        set_b = _set_bytes(*ops(first))
        n_cold = need(set_b)
        warm, cold = _on_graph(fn, sets, n_cold)
        host = cuda_ms(lambda: fn(first), ELL_GRAPH_REPS)
        plain_ms = cuda_ms(lambda: plain(first), 20)
        b_ms, b_by = bound(*bounds[name], "f32")
        row = dict(ms=cold, warm_ms=warm, host_ms_per_call=host,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   bytes=bounds[name][0], operations=bounds[name][1],
                   share_of_bound_cold=b_ms / cold, cold_sets=n_cold,
                   set_bytes=set_b, timed_on="CUDA graph",
                   library_ms=None,
                   launches_per_step=per_step.get(name, 0))
        lib_txt = "none"
        if name in library:
            what, lfn, lops = library[name]
            lb = _set_bytes(*lops(first))
            lw, lc, how = _library_times(what, lfn, sets, need(lb))
            row.update(library_ms=lc, library_warm_ms=lw, library=what,
                       library_timed_on=how, library_cold_sets=need(lb))
            lib_txt = (f"{what} warm {lw:.5f}, L2-cold {lc:.5f} ms ({how}, "
                       f"{need(lb)} sets)")
        out[name] = row
        log(f"{name} irr640 f32: on a CUDA graph of {ELL_GRAPH_REPS} calls "
            f"warm {warm:.5f} ms, L2-cold {cold:.5f} ms ({n_cold} sets of "
            f"{set_b} B); per wrapper call back to back {host:.5f} ms; "
            f"plain {plain_ms:.5f} ms; library {lib_txt}; bound {b_ms:.5f} "
            f"ms ({b_by}), L2-cold at {b_ms / cold:.1%} of it ({card})")
    # A's columns: the int16 codes the wrapper reads beside the int32
    # flagged columns it falls back to (a mesh without the codes)
    def wide(s):
        return kernels["ell_spmv"][0](dict(s, m=s["m"]._replace(
            patch_cols_d16=None)))

    if not torch.equal(wide(first), kernels["ell_spmv"][0](first)):
        raise AssertionError("ell_spmv: int16 and int32 columns differ")
    ww, wc = _on_graph(wide, sets, need(_set_bytes(
        base["J"], m.patch_cols_bc32, base["u"], m.boundary_mask)))
    out["ell_spmv"].update(int32_columns_warm_ms=ww, int32_columns_ms=wc)
    log(f"ell_spmv irr640 f32, its columns: int16 codes warm "
        f"{out['ell_spmv']['warm_ms']:.5f}, L2-cold "
        f"{out['ell_spmv']['ms']:.5f} ms; int32 flagged columns warm "
        f"{ww:.5f}, L2-cold {wc:.5f} ms ({card})")
    def rv_wide(s):
        return kernels["ell_rv_epsilon"][0](dict(s, m=s["m"]._replace(
            patch_cols_d16=None)))

    if not torch.equal(rv_wide(first), kernels["ell_rv_epsilon"][0](first)):
        raise AssertionError("ell_rv_epsilon: int16 and int32 columns "
                             "differ")
    ww, wc = _on_graph(rv_wide, sets, need(_set_bytes(
        m.patch_cols32, base["u"], base["rh"], base["h"])))
    out["ell_rv_epsilon"].update(int32_columns_warm_ms=ww,
                                 int32_columns_ms=wc)
    log(f"ell_rv_epsilon irr640 f32, its columns: int16 codes warm "
        f"{out['ell_rv_epsilon']['warm_ms']:.5f}, L2-cold "
        f"{out['ell_rv_epsilon']['ms']:.5f} ms; patch_cols32 warm "
        f"{ww:.5f}, L2-cold {wc:.5f} ms ({card})")
    # B: vector mode (most of its launches a step) and matrix mode in f64,
    # each bit-equal to the launch the port makes
    n = m.patch_cols.shape[0]
    M = m.cells.shape[0]
    variants = {
        "vector": (ek._VECTOR, "rhs", ek.assemble_vector),
        "f64": (ek._MATRIX, "jac64", ek.assemble_matrix),
    }
    b = out["ell_assemble"]
    for tag, (fields, key, wrapper) in variants.items():
        fn = lambda s, w=wrapper, k=key: w(s["m"], s[k])
        if not torch.equal(fn(first), wrapper(m, first[key])):
            raise AssertionError(f"ell_assemble {tag}: not the port's bits")
        idx = [getattr(m, f) for f in fields[:4]]
        vw, vc = _on_graph(fn, sets, need(_set_bytes(first[key], *idx)))
        b.update({f"{tag}_warm_ms": vw, f"{tag}_ms": vc})
    vb = _assemble_vector_bound(n, M, 4)
    b["vector_bound_ms"] = bound(*vb, "f32")[0]
    b["vector_bytes"] = vb[0]
    nnz = int(m.patch_mask.sum())
    b["f64_bound_ms"] = bound(*_ell_bounds(n, nnz, M, 8, 2, 2)[
        "ell_assemble"], "f64")[0]
    log("ell_assemble irr640: " + "; ".join(
        f"{tag} warm {b[tag + '_warm_ms']:.5f}, L2-cold {b[tag + '_ms']:.5f} "
        "ms" for tag in variants) + f"; vector bound "
        f"{b['vector_bound_ms']:.5f} ms ({card})")
    # rule 2: slower than the library call first, then the time lost a step
    # (B's launches by mode: most assemble vectors)
    mat_n, vec_n = assemble_launches(cfg)
    b.update(matrix_launches_per_step=mat_n, vector_launches_per_step=vec_n)
    for name, row in out.items():
        row["slower_than_library"] = (row["library_ms"] is not None
                                      and row["ms"] > row["library_ms"])
        row["lost_ms_per_step"] = row["launches_per_step"] * (
            row["ms"] - row["bound_ms"])
    b["lost_ms_per_step"] = mat_n * (b["ms"] - b["bound_ms"]) + vec_n * (
        b["vector_ms"] - b["vector_bound_ms"])
    rank = sorted(out, key=lambda k: (not out[k]["slower_than_library"],
                                      -out[k]["lost_ms_per_step"]))
    for i, name in enumerate(rank):
        out[name]["rule2_rank"] = i + 1
    log("ELL kernels by rule 2 (slower than the library call L2-cold first, "
        "then launches a step x (L2-cold - bound)): " + "; ".join(
            f"{k} (lost {out[k]['lost_ms_per_step']:.5f} ms a step, "
            f"{out[k]['share_of_bound_cold']:.1%} of its bound"
            + (", slower than its library call" if out[k][
                "slower_than_library"] else "") + ")" for k in rank))
    return out


def check_ell_kernels(states, regs, card):
    """(a) Each ELL kernel against its plain version on the card, at the
    operands of the blocked runs' end states at irr140 and irr640 (f32, and
    the same state in f64 on the f64 problem): A constrained on the
    assembled Newton Jacobian, B on its locals (matrix mode) and the rhs
    locals (vector mode), C in both modes, D with the residual N(u) as Rh
    (on its int16 codes and on patch_cols32). Gates, each output held on
    its own: B (its plain
    version run on the CPU, which sums in the kernel's order) and D
    bit-equal, A's bc rows
    (y = x), and A in f32 against its plain version on the CPU in both
    modes; A's other rows and C's outputs within max|kernel - plain| /
    max|plain| <= F64_TOL (f64) or ELL_F32_RTOL (f32). Times at irr640 f32
    (time_ell_kernels), and what ptxas gave each instance (registers and
    spills, printed: these memory-bound kernels are not held to the band
    kernels' no-spill rule). Returns {kernel: row}."""
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.ops import assembly, blocked
    from conservation_fem_tpu_torch.ops import ell_kernels as ek

    rows = {k: dict(errs={}, rels={}, times={}) for k in ELL_KERNELS}
    for nx, (p32, u32) in states.items():
        p64 = kpp.build(_blocked_cfg(kpp, nx, "blocked", dtype="float64"),
                        host_mesh=p32.host_mesh)
        for dn, p, u in (("f32", p32, u32), ("f64", p64, u32.double())):
            m, plan, flux = p.mesh, p.plan, kpp.FLUX
            n = m.patch_cols.shape[0]
            M = m.cells.shape[0]
            nnz = int(m.patch_mask.sum())
            s = u.element_size()
            rh = blocked.conv_rhs_components(plan, u, flux)
            h = p.h_cg
            abs_term = (u - u.mean()).abs().max()
            eps = ek.ell_rv_epsilon(m, 0.5, 4.0, u, rh, u, h, abs_term, flux)
            half = 0.5 * p.dt
            rhs, jac = ek.p1_newton_locals(m, u, eps, half, flux, True)
            J = ek.assemble_matrix(m, jac)
            bc = m.boundary_mask
            # B's reference: its plain version on the CPU, which sums each
            # segment in the kernel's order (torch.segment_reduce on the
            # card takes another); the card's plain version is what is
            # timed
            mc = type(m)(*(t.cpu() if torch.is_tensor(t) else t for t in m))
            jac_c, rhs_c = jac.cpu(), rhs.cpu()
            # name: [(what, kernel, reference, gate)]; gate "equal": bit-
            # equal (the same order of operations), "equal f32": so in f32
            # (A against its plain version on the CPU, which sums each row
            # in slot order with rounded products as the kernel does) and
            # "rel" in f64, "rel": max|kernel - plain| / max|plain| within
            # the dtype's tolerance, with A's bc rows (y = x) bit-equal and
            # its other rows held relative to their own scale
            checks = {
                "ell_spmv": [("constrained, interior rows",
                              lambda: ek.ell_spmv(m, J, u, True)[~bc],
                              lambda: ek.ell_spmv_plain(m, J, u,
                                                        True)[~bc],
                              "rel"),
                             ("constrained, bc rows",
                              lambda: ek.ell_spmv(m, J, u, True)[bc],
                              lambda: u[bc], "equal"),
                             ("constrained, plain on the CPU",
                              lambda: ek.ell_spmv(m, J, u, True).cpu(),
                              lambda: ek.ell_spmv_plain(
                                  mc, J.cpu(), u.cpu(), True),
                              "equal f32"),
                             ("unconstrained, plain on the CPU",
                              lambda: ek.ell_spmv(m, J, u).cpu(),
                              lambda: ek.ell_spmv_plain(mc, J.cpu(),
                                                        u.cpu()),
                              "equal f32")],
                "ell_assemble": [("matrix", lambda: ek.assemble_matrix(
                                      m, jac).cpu(),
                                  lambda: assembly.scatter_matrix(mc, jac_c),
                                  "equal"),
                                 ("vector", lambda: ek.assemble_vector(
                                      m, rhs).cpu(),
                                  lambda: assembly.scatter_vector(mc, rhs_c),
                                  "equal")],
                "p1_newton_locals": [
                    ("rhs", lambda: ek.p1_newton_locals(
                        m, u, eps, half, flux, True)[0],
                     lambda: ek.p1_newton_locals_plain(
                         m, u, eps, half, flux, True)[0], "rel"),
                    ("jac", lambda: ek.p1_newton_locals(
                        m, u, eps, half, flux, True)[1],
                     lambda: ek.p1_newton_locals_plain(
                         m, u, eps, half, flux, True)[1], "rel"),
                    ("rhs alone", lambda: ek.p1_newton_locals(
                        m, u, eps, half, flux)[0],
                     lambda: ek.p1_newton_locals_plain(
                         m, u, eps, half, flux, False)[0], "rel")],
                "ell_rv_epsilon": [("eps", lambda: ek.ell_rv_epsilon(
                    m, 0.5, 4.0, u, rh, u, h, abs_term, flux),
                    lambda: ek.ell_rv_epsilon_plain(
                        m, 0.5, 4.0, u, rh, u, h, abs_term, flux),
                    "equal"),
                    ("eps, patch_cols32", lambda: ek.ell_rv_epsilon(
                        m._replace(patch_cols_d16=None), 0.5, 4.0, u, rh, u,
                        h, abs_term, flux),
                     lambda: ek.ell_rv_epsilon_plain(
                         m, 0.5, 4.0, u, rh, u, h, abs_term, flux),
                     "equal")],
            }
            bounds = _ell_bounds(n, nnz, M, s,
                                 ek.spmv_columns(m).element_size(),
                                 ek.rv_columns(m).element_size())
            tol = F64_TOL if dn == "f64" else ELL_F32_RTOL
            for name, cases in checks.items():
                errs, rels = [], []
                for what, k_fn, p_fn, gate in cases:
                    a, b = k_fn(), p_fn()
                    torch.cuda.synchronize()
                    e, rel = _rel_err(a, b)
                    if (gate == "equal" or gate == "equal f32"
                            and dn == "f32") and not torch.equal(a, b):
                        raise AssertionError(
                            f"{name} {what} irr{nx} {dn}: kernel not "
                            f"bit-equal to its plain version (off by {e})")
                    if not rel <= tol:
                        raise AssertionError(
                            f"{name} {what} irr{nx} {dn}: kernel off its "
                            f"plain version by {e}, {rel} of its scale "
                            f"(gate {tol})")
                    if not torch.equal(k_fn(), a):
                        raise AssertionError(f"{name} {what} irr{nx} {dn}: "
                                             "repeated launches differ")
                    errs.append(e)
                    rels.append(rel)
                rows[name]["rels"][f"irr{nx} {dn}"] = max(rels)
                rows[name]["errs"][f"irr{nx} {dn}"] = max(errs)
            if nx == max(ELL_KERNEL_MESHES) and dn == "f32":
                timed = dict(m=m, u=u, J=J, jac=jac, rhs=rhs, eps=eps,
                             rh=rh, h=h, abs_term=abs_term)
                timed_args = (half, bounds, p.cfg)
    times = time_ell_kernels(timed, *timed_args, card)
    for name, t in times.items():
        rows[name]["times"] = t
    out = {}
    for name, r in rows.items():
        # each instance (A's by its mode and columns)
        ptxas = {k: v for k, v in regs.items()
                 for dn in ("f32", "f64") for tag in ("", " burgers")
                 if k == f"{name}{tag} {dn}"
                 or k.startswith(f"{name}{tag} {dn} ")}
        if not ptxas:
            raise AssertionError(f"{name}: ptxas reported nothing")
        def worst(key, dn):
            return max(v for k, v in r[key].items() if k.endswith(dn))
        out[name] = dict(max_abs_err=worst("errs", "f64"),
                         err_case="f64, irr140 and irr640",
                         max_abs_err_f32=worst("errs", "f32"),
                         max_rel_err=worst("rels", "f64"),
                         max_rel_err_f32=worst("rels", "f32"), **r["times"],
                         timed_case="irr640 f32, the blocked run's end "
                                    "state; ms L2-cold on a CUDA graph, "
                                    "library_ms L2-cold as "
                                    "library_timed_on says", ptxas=ptxas)
        log(f"{name} ptxas: " + json.dumps(ptxas))
    return out


def run_blocked_f64(meshes):
    """(c) irr140, 5 steps of the f64 fixed config, rv and si, blocked:
    the card against the CPU (F64_CARD_VS_CPU) and against the gather
    backend on the card (BLOCKED_VS_GATHER_F64)."""
    import torch

    from conservation_fem_tpu_torch.models import kpp

    m = meshes[140]
    dt = IRR[140][0]
    out = {}
    for stab in ("rv", "si"):
        cfg = kpp.KPPConfig(dt=dt, T=5 * dt, backend="ell",
                            ell_matvec_backend="blocked",
                            **_ell_f64_fixed(stab))
        uc = kpp.build(cfg, host_mesh=m).solve().u
        ug = kpp.build(dataclasses.replace(cfg, ell_matvec_backend="gather"),
                       host_mesh=m).solve().u
        torch.cuda.synchronize()
        ref = kpp.build(cfg, host_mesh=m, device="cpu").solve().u
        e, eg = max_err(uc.cpu(), ref), max_err(uc, ug)
        log(f"blocked irr140 f64 fixed config {stab}, 5 steps: max|card - "
            f"CPU| = {e:.3e} (gate {F64_CARD_VS_CPU}); max|blocked - gather| "
            f"on the card = {eg:.3e} (gate {BLOCKED_VS_GATHER_F64})")
        if not (e <= F64_CARD_VS_CPU and eg <= BLOCKED_VS_GATHER_F64):
            raise AssertionError(f"blocked irr140 f64 {stab}: {e}, {eg}")
        out[stab] = dict(card_vs_cpu=e, blocked_vs_gather=eg)
    return out


def _some_launches(label, fn, kernels):
    """fn() with the launch counts zeroed just before it and read just
    after; raises unless each of ``kernels`` launched."""
    import torch

    from conservation_fem_tpu_torch.ops import _build

    _build.launches.clear()
    out = fn()
    torch.cuda.synchronize()
    c = dict(_build.launches)
    if any(not c.get(k) for k in kernels):
        raise AssertionError(f"{label}: launched {c}, expected {kernels}")
    return out, c


def run_blocked_pk_advection(card):
    """(d) P2 SI Burgers mesh 32 f64 (PK_BURGERS) on the blocked backend
    against phase 8's gather run through dof_perm, and its L1 and L2
    errors against the JAX package's on the same RCM dof order (a chaotic
    run: gated at SPREAD_FACTOR x the JAX package's own move under that
    renumbering);
    linear advection rv_node f32 fixed Chebyshev on disk_mesh(1/64)
    (ADV_FIXED) under phase 8's gate against its f64 end state, through
    the RCM order, timed; advection_ho P2 gfem at mesh 8, f64, T = 1,
    blocked against gather (F64_TOL)."""
    import torch

    from conservation_fem_tpu_torch.models import advection_ho as ho
    from conservation_fem_tpu_torch.models import burgers
    from conservation_fem_tpu_torch.models import linear_advection as la
    from conservation_fem_tpu_torch.ops.mesh import rcm_permutation

    out = {}
    ug, secs_g = STATES["pk_burgers_f64"]
    p = burgers.build(burgers.BurgersConfig(mesh_size=32,
                                            ell_matvec_backend="blocked",
                                            **PK_BURGERS))
    t0 = time.perf_counter()
    u, c = _some_launches("burgers P2 SI blocked", lambda: p.solve().u,
                          ("ell_spmv", "ell_assemble"))
    secs = time.perf_counter() - t0
    e = max_err(u[torch.as_tensor(p.dof_perm, device=u.device)], ug)
    # a chaotic run in the JAX package itself: its own run on the RCM dof
    # numbering (the blocked backend's) moves the state by rcm_max_abs
    # and the errors by the spread of run_pk_burgers; both gated at
    # SPREAD_FACTOR x those
    ref = ADVECTION_REFERENCE["burgers_p2si"]
    t = p.num_steps * p.dt
    l1 = float(burgers.l1_error_vs_exact(p, u, t))
    l2 = float(burgers.l2_error_vs_exact(p, u, t))
    rel = max(_rel(l1, ref["rcm_l1"]), _rel(l2, ref["rcm_l2"]))
    spread = max(_rel(ref["rcm_l1"], ref["l1"]), _rel(ref["rcm_l2"],
                                                     ref["l2"]))
    gate_u = SPREAD_FACTOR * ref["rcm_max_abs"]
    log(f"burgers P2 SI mesh 32 f64 blocked, {p.num_steps} steps: "
        f"max|blocked[dof_perm] - gather| = {e:.3e} (gate {gate_u:.3g}: "
        f"{SPREAD_FACTOR} x {ref['rcm_max_abs']:.3e}, the JAX package's own "
        f"move under the RCM dof order); L1 {l1!r}, L2 {l2!r}, relative to "
        f"the JAX package's on the RCM order {rel:.3e} (gate "
        f"{SPREAD_FACTOR * spread:.3g}); {secs:.2f} s against gather "
        f"{secs_g:.2f} s; launches {c} ({card})")
    if not (e <= gate_u and rel <= SPREAD_FACTOR * spread):
        raise AssertionError(f"burgers P2 SI blocked: {e}, {rel}")
    out["pk_burgers_p2si_mesh32_f64"] = dict(
        blocked_vs_gather=e, l1=l1, l2=l2, rel_to_jax_rcm=rel,
        seconds=secs, gather_seconds=secs_g, launches=c)
    m, u64 = STATES["advection_f64"]
    cfg = la.AdvectionConfig(mesh_size=ADV_F32_MESH, stabilization="rv_node",
                             dtype="float32", ell_matvec_backend="blocked",
                             **ADV_FIXED)
    q = la.build(cfg, host_mesh=m)
    label = f"advection rv_node f32 fixed Chebyshev mesh {ADV_F32_MESH} " \
            "blocked"
    pre = _prefix(q)
    _repeats(label, lambda: la.solve(pre).u)
    uq, c, us = _counted_timed(lambda: la.solve(q).u, q.num_steps)
    if any(not c.get(k) for k in ("ell_spmv", "ell_assemble")):
        raise AssertionError(f"{label}: launched {c}, expected ell_spmv "
                             "and ell_assemble")
    perm = torch.as_tensor(rcm_permutation(m), device=uq.device)
    rel = float((uq.double()[perm] - u64).norm() / u64.norm())
    prof = idle_profiled(q, steps=3, solve=la.solve)
    log(f"{label}, {q.num_steps} steps: L2rel {rel:.4e} against the card's "
        f"f64 gather end state (gate {ADV_F32_GATE}); {us:.1f} us/step "
        f"(gather {STATES['advection_f32_us']:.1f}, phase 8), "
        f"{prof['kernels_per_step']:.1f} kernels/step, idle share "
        f"{prof['profiled_idle']:.4f}; launches per step "
        f"{ {k: v / q.num_steps for k, v in c.items()} } ({card})")
    if not rel <= ADV_F32_GATE:
        raise AssertionError(f"{label}: L2rel {rel}")
    out["advection_rv_node_f32_mesh64"] = dict(
        l2rel_vs_f64=rel, us_per_step=us,
        gather_us_per_step=STATES["advection_f32_us"], **prof)
    # gfem: P2 rv at mesh 8 to T = 1 is chaotic in the JAX package itself
    # (its blocked run leaves its gather run by 7.2e-3, CPU f64)
    kw = dict(mesh_size=8, degree=2, stabilization="gfem")
    pg, ugh, _ = ho.run(ho.HOAdvectionConfig(**kw))
    (pb, ub, _), c = _some_launches(
        "advection_ho P2 gfem blocked",
        lambda: ho.run(ho.HOAdvectionConfig(**kw,
                                            ell_matvec_backend="blocked")),
        ("ell_spmv", "ell_assemble"))
    e = max_err(ub[torch.as_tensor(pb.space_perm, device=ub.device)], ugh)
    log(f"advection_ho P2 gfem mesh 8 f64 T = 1 blocked, {pb.num_steps} "
        f"steps: max|blocked[perm] - gather| = {e:.3e} (gate {F64_TOL})")
    if not e <= F64_TOL:
        raise AssertionError(f"advection_ho blocked: {e}")
    out["advection_ho_p2_gfem_mesh8_f64"] = dict(blocked_vs_gather=e)
    return out


def blocked_phase(card, meshes, regs):
    """Phase 10: (b), (a), (c), (d). Returns (readings, kernel rows,
    irr640's launch counts, the blocked irr640 problem)."""
    t0 = time.perf_counter()
    paths, states, counts = run_blocked_paths(card, meshes)
    rows = check_ell_kernels(states, regs, card)
    main = states[640][0]
    states.clear()
    out = dict(paths=paths, f64=run_blocked_f64(meshes),
               pk_advection=run_blocked_pk_advection(card))
    out["seconds"] = time.perf_counter() - t0
    log(f"unstructured fast path phase: {out['seconds']:.0f} s ({card})")
    return out, rows, counts, main


# phase 11: the stencil main paths (mesh, checkpoint every) whose
# checkpointed and resumed solves are held to the plain solve's bits; the
# blocked irr640 run, cut to UTIL_IRR_STEPS steps, checkpointed every
# UTIL_IRR_EVERY; the streams' thinning; the VTX stream's; the steps of the
# idle-share windows and of the profile trace; the gates of StepTimer
# against CUDA events and of nodal_h_dg1 against get_nodal_h_ell
UTIL_PATHS = ((256, 100), (64, 25))
UTIL_IRR_STEPS = 20
UTIL_IRR_EVERY = 5
UTIL_STREAM_EVERY = (1, 10)
UTIL_VTX_EVERY = 10
UTIL_IDLE_STEPS = 40
UTIL_TRACE_STEPS = 3
UTIL_TIMER_TOL = 0.05
UTIL_NODAL_H_TOL = 1e-12


def checkpoint_runs(p, every, label, want, tmp):
    """(a), (c): p's plain solve, a solve checkpointed every ``every``
    steps and one stopped at half its steps and resumed from the .npz,
    the last two bit-equal to the first with its launch counts (``want``,
    the code's prediction; the stopped and the resumed solve counted
    together). Returns (u, readings)."""
    import torch

    from conservation_fem_tpu_torch.utils.checkpoint import load_checkpoint

    n = p.num_steps
    p.solve()
    u, counts, us_plain = _counted_timed(lambda: p.solve().u, n)
    if counts != want:
        raise AssertionError(f"{label}: launched {counts}, expected {want}")
    path = os.path.join(tmp, f"{label.split()[0]}_chunked.npz")
    uc, c_ck, us_ck = _counted_timed(
        lambda: p.solve(checkpoint_path=path, checkpoint_every=every).u, n)
    if load_checkpoint(path).step != n:
        raise AssertionError(f"{label}: the last checkpoint is not step {n}")
    half, path2 = n // 2, os.path.join(tmp, f"{label.split()[0]}_stopped")

    def stop_and_resume():
        p.num_steps = half
        try:
            p.solve(checkpoint_path=path2, checkpoint_every=every)
        finally:
            p.num_steps = n
        if load_checkpoint(path2).step != half:
            raise AssertionError(f"{label}: stopped at the wrong step")
        return p.solve(checkpoint_path=path2, checkpoint_every=every,
                       resume=True).u

    ur, c_res, us_res = _counted_timed(stop_and_resume, n)
    for name, v, c in (("checkpointed", uc, c_ck),
                       ("stopped and resumed", ur, c_res)):
        if not torch.equal(v, u):
            raise AssertionError(f"{label}: the {name} solve differs from "
                                 f"the plain solve")
        if c != counts:
            raise AssertionError(f"{label}: the {name} solve launched {c}, "
                                 f"the plain solve {counts}")
    nbytes = os.path.getsize(path)
    log(f"{label}, {n} steps: the solve checkpointed every {every} steps "
        f"and the one stopped at step {half} and resumed from "
        f"{os.path.basename(path2)}.npz bit-equal to the plain solve, "
        f"launches {counts} in each ({sum(counts.values()) / n:g} a "
        f"step); {us_plain:.1f} us/step plain, "
        f"{us_ck:.1f} checkpointed ({us_ck / us_plain:.4f} x), "
        f"{us_res:.1f} stopped and resumed; a checkpoint {nbytes} bytes")
    return u, dict(steps=n, every=every, launches=counts,
                   us_per_step_plain=us_plain,
                   us_per_step_checkpointed=us_ck,
                   us_per_step_stopped_resumed=us_res,
                   checkpoint_bytes=nbytes)


def stream_runs(p, u, label):
    """(b): p solved with a StreamingSink at each of UTIL_STREAM_EVERY:
    the frames' count, their times (step_times()), the last frame equal to
    u and every thinned frame to the unthinned one at its step, bit for
    bit; µs/step of each."""
    import torch

    from conservation_fem_tpu_torch.utils.streaming import StreamingSink

    n, times = p.num_steps, p.step_times()
    out, frames = {}, {}
    for every in UTIL_STREAM_EVERY:
        got = frames[every] = []
        sink = StreamingSink(lambda v, t: got.append((v, t)), every=every)
        v, us = _timed(lambda: p.solve(stream=sink).u, n)
        sink.close()
        if not torch.equal(v, u):
            raise AssertionError(f"{label}: the streamed solve differs")
        if len(got) != -(-n // every):
            raise AssertionError(f"{label}: {len(got)} frames at every = "
                                 f"{every}, {n} steps")
        if [t for _, t in got] != times[::every]:
            raise AssertionError(f"{label}: frame times differ from "
                                 f"step_times() at every = {every}")
        out[f"every_{every}"] = dict(frames=len(got), us_per_step=us)
    if not np.array_equal(frames[1][-1][0], u.cpu().numpy()):
        raise AssertionError(f"{label}: the last frame is not the final u")
    for j, (v, _) in enumerate(frames[UTIL_STREAM_EVERY[1]]):
        if not np.array_equal(v, frames[1][j * UTIL_STREAM_EVERY[1]][0]):
            raise AssertionError(f"{label}: thinned frame {j} differs")
    frames.clear()
    return out


def utilities_profiled():
    """(b), (f) in a fresh interpreter: the idle share (torch.profiler, the
    first UTIL_IDLE_STEPS steps) of the mesh-256 f32 bench config
    unstreamed and streamed at each of UTIL_STREAM_EVERY, and
    metrics.profile_trace around its first UTIL_TRACE_STEPS steps, which
    must name the tiled step kernel. Returns the readings."""
    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.utils.metrics import (TRACE_FILE,
                                                          profile_trace)
    from conservation_fem_tpu_torch.utils.streaming import StreamingSink

    mesh = UTIL_PATHS[0][0]
    p = kpp.build(_bench_cfg(kpp, mesh, "float32", use_kernels=True),
                  device="cuda")
    q = copy.copy(p)
    q.num_steps = UTIL_TRACE_STEPS
    q.solve()
    out = dict(unstreamed=idle_profiled(p, steps=UTIL_IDLE_STEPS))
    for every in UTIL_STREAM_EVERY:
        drop = StreamingSink(lambda v, t: None, every=every)
        out[f"every_{every}"] = idle_profiled(
            p, steps=UTIL_IDLE_STEPS, solve=lambda r: r.solve(stream=drop))
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp) as logdir:
            q.solve()
        trace = os.path.join(logdir, TRACE_FILE)
        with open(trace) as fh:
            names = fh.read().count("tiled_rv_step_kernel")
        out["trace"] = dict(bytes=os.path.getsize(trace),
                            tiled_rv_step_kernel=names)
    if names < UTIL_TRACE_STEPS:
        raise AssertionError(f"profile_trace around {UTIL_TRACE_STEPS} "
                             f"steps names the tiled step kernel {names} "
                             f"times")
    return out


def _side_start(names, *args):
    """Start chip_smoke.<name>(*args) for each of ``names``, in order, in
    a fresh interpreter of their own; its output goes to temporary files
    (a pipe could fill and stop it). _side_join reads the results."""
    code = ("import json, chip_smoke as cs; print(json.dumps("
            f"{{n: getattr(cs, n)(*{args!r}) for n in {tuple(names)!r}}}))")
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=out, stderr=err, text=True)
    return dict(names=tuple(names), proc=proc, out=out, err=err,
                t0=time.perf_counter())


def _side_join(side, timeout=SIDE_TIMEOUT):
    """{name: result} of a _side_start process: waits for it, relays its
    log lines and its standard error to this process's, raises if it
    failed."""
    side["proc"].wait(timeout)
    secs = time.perf_counter() - side["t0"]
    out, err = side["out"], side["err"]
    out.seek(0)
    err.seek(0)
    lines = out.read().strip().splitlines()
    sys.stderr.write(err.read())
    for line in lines[:-1]:
        log(line)
    if side["proc"].returncode != 0 or not lines:
        raise RuntimeError(f"{', '.join(side['names'])} failed in their "
                           f"process (exit {side['proc'].returncode})")
    log(f"{', '.join(side['names'])}: {secs:.0f} s in a process of their "
        "own")
    return json.loads(lines[-1])


def _side_stop(side):
    """Stop a _side_start process if it still runs; close its files."""
    if side["proc"].poll() is None:
        side["proc"].kill()
    side["proc"].wait()
    side["out"].close()
    side["err"].close()


def _fresh(fn_name):
    """chip_smoke.<fn_name>() in a fresh interpreter, its result (in this
    process torch.profiler stopped recording the tiled kernel's launches
    after phase 10; a fresh one records them)."""
    side = _side_start((fn_name,))
    try:
        return _side_join(side)[fn_name]
    finally:
        _side_stop(side)


def vtx_stream(p, label, tmp):
    """(b): p solved with a VTXWriter stream of every UTIL_VTX_EVERY-th
    step into tmp; the writes, bytes and ms a write."""
    from conservation_fem_tpu_torch.utils.io import VTXWriter
    from conservation_fem_tpu_torch.utils.streaming import StreamingSink

    n = p.num_steps
    with VTXWriter(os.path.join(tmp, "kpp"), p.host_mesh, p.u0) as vtx:
        sink = StreamingSink(lambda v, t: vtx.write(t, field=v),
                             every=UTIL_VTX_EVERY)
        _, us = _timed(lambda: p.solve(stream=sink).u, n)
    st = vtx.stats
    files = sorted(os.listdir(vtx.dir))
    if st["writes"] != -(-n // UTIL_VTX_EVERY) or len(files) != st[
            "writes"] + 1:
        raise AssertionError(f"{label}: VTX stream wrote {st['writes']} "
                             f"steps, files {files[:3]}...")
    log(f"{label} with a VTXWriter stream every {UTIL_VTX_EVERY} steps: "
        f"{st['writes']} writes, {st['bytes_per_write']} bytes and "
        f"{st['ms_per_write']:.3f} ms a write (host), {us:.1f} us/step")
    return dict(us_per_step=us, **st)


def native_check(m):
    """(d): the native preprocessor built here (g++) on irr640 against the
    numpy path: boundary mask, ELL adjacency and everything built from it,
    and the RCM order; host seconds of each."""
    from conservation_fem_tpu_torch import native_ext
    from conservation_fem_tpu_torch.ops import mesh as tmesh

    t0 = time.perf_counter()
    native_ext.build()
    t_build = time.perf_counter() - t0
    cells = m.cells.astype(np.int64)
    t0 = time.perf_counter()
    bnd, _, _, rcm = native_ext.preprocess_mesh(m.n_nodes, cells)
    t_lib = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = tmesh.mesh_from_arrays(m.points, m.cells, use_native=True)
    t_nat_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_patches = tmesh._build_patches(m.n_nodes, cells)
    ref_bnd = tmesh._boundary_mask(m.n_nodes, cells)
    ref_rcm = tmesh.rcm_permutation(m)
    t_numpy = time.perf_counter() - t0
    same = [np.array_equal(bnd, ref_bnd), np.array_equal(rcm, ref_rcm),
            np.array_equal(ref_patches[0], nat.patch_cols)]
    same += [np.array_equal(getattr(nat, k), getattr(m, k)) for k in (
        "boundary_mask", "patch_cols", "patch_mask", "diag_slot",
        "cell_slots", "mat_perm", "mat_segs", "vec_perm", "vec_segs")]
    if not all(same):
        raise AssertionError(f"native preprocessor differs from numpy on "
                             f"irr640: {same}")
    log(f"native preprocessor (g++ build {t_build:.1f} s) on irr640: "
        f"boundary, adjacency and RCM equal to the numpy path's, and the "
        f"mesh built from them equal in every ELL array; host seconds: "
        f"library {t_lib:.3f} (the mesh with it {t_nat_mesh:.3f}), numpy "
        f"{t_numpy:.3f} (patches, boundary, RCM)")
    return dict(build_s=t_build, library_s=t_lib, native_mesh_s=t_nat_mesh,
                numpy_s=t_numpy)


def utilities_phase(card, mesh640, irr640):
    """Phase 11: the utilities and solve()'s checkpoint, resume and
    streaming on the card (ROADMAP queue 1 item 14; no kernel of its own:
    the stencil main paths launch the whole-step kernels, the blocked
    path the ELL kernels A-D). (a) KPP f32 bench config at mesh 256
    (tiled) and 64 (single), each to its T: checkpointed and stopped and
    resumed solves bit-equal to the plain solve with its launch counts;
    (b) mesh 256 streamed at every 1 and 10, then mesh 64 into a
    VTXWriter; (c) blocked irr640 (phase 10's problem) cut to
    UTIL_IRR_STEPS steps, as (a); (d) the native preprocessor against
    numpy on irr640; (e) f64 on irr640 nodal_h_dg1 against
    get_nodal_h_ell, blown_up on the final states, StepTimer against CUDA
    events on a mesh-256 solve; (f) profile_trace around mesh 256's first
    UTIL_TRACE_STEPS steps names the tiled kernel. The profiles of (b) and
    (f) run in a fresh interpreter (utilities_profiled). Every gate
    raises."""
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.ops import dg
    from conservation_fem_tpu_torch.ops.assembly import assemble_mass
    from conservation_fem_tpu_torch.ops.helpers import get_nodal_h_ell
    from conservation_fem_tpu_torch.utils.guards import blown_up
    from conservation_fem_tpu_torch.utils.metrics import StepTimer

    t_phase = time.perf_counter()
    out, finals = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        problems = {}
        for mesh, every in UTIL_PATHS:
            p = kpp.build(_bench_cfg(kpp, mesh, "float32", use_kernels=True),
                          device="cuda")
            mode = p._fused_mode()
            label = f"mesh-{mesh} f32 bench config ({mode})"
            want = _expected_launches(mode, p.num_steps, p.cfg.newton_iters)
            finals[f"mesh{mesh}"], out[f"mesh{mesh}"] = checkpoint_runs(
                p, every, label, want, tmp)
            problems[mesh] = p
        # the first path streamed, the second into a VTXWriter
        (big, _), (small, _) = UTIL_PATHS
        p256, u256 = problems[big], finals[f"mesh{big}"]
        label = f"mesh-{big} f32 bench config ({p256._fused_mode()})"
        out[f"stream_mesh{big}"] = st = stream_runs(p256, u256, label)
        prof = out["profiled"] = _fresh("utilities_profiled")
        log(f"{label}, {p256.num_steps} steps, streamed: frames, times "
            f"(step_times()) and bits as expected; us/step "
            + ", ".join(f"every {e} {st[f'every_{e}']['us_per_step']:.1f}"
                        for e in UTIL_STREAM_EVERY)
            + f" against {out[f'mesh{big}']['us_per_step_plain']:.1f} "
            f"unstreamed; idle share (first {UTIL_IDLE_STEPS} steps, "
            f"profiled in a fresh interpreter) "
            f"{prof['unstreamed']['profiled_idle']:.4f} unstreamed, "
            + ", ".join(f"every {e} "
                        f"{prof[f'every_{e}']['profiled_idle']:.4f}"
                        for e in UTIL_STREAM_EVERY) + f" ({card})")
        log(f"profile_trace around {UTIL_TRACE_STEPS} steps of mesh {big} "
            f"(fresh interpreter): {prof['trace']['bytes']} bytes, names "
            f"tiled_rv_step_kernel "
            f"{prof['trace']['tiled_rv_step_kernel']} times")
        out[f"vtx_mesh{small}"] = vtx_stream(
            problems[small], f"mesh-{small} f32 bench config "
            f"({problems[small]._fused_mode()})", tmp)
        # (c) the unstructured main path, cut to UTIL_IRR_STEPS steps
        full = irr640.num_steps
        irr640.num_steps = UTIL_IRR_STEPS
        label = (f"blocked irr640 f32 bench config (reduced: {UTIL_IRR_STEPS}"
                 f" of its {full} steps)")
        finals["irr640"], out["blocked_irr640"] = checkpoint_runs(
            irr640, UTIL_IRR_EVERY, label,
            blocked_launches(irr640.cfg, UTIL_IRR_STEPS), tmp)
        out["blocked_irr640"]["reduced_from_steps"] = full
        # (d)
        out["native_irr640"] = native_check(mesh640)
        # (e)
        ma = mesh640.device_arrays(torch.float64, "cuda")
        M = assemble_mass(ma)
        h_ref = get_nodal_h_ell(ma, M)
        h_dg = dg.nodal_h_dg1(ma, M)
        rel = float((h_dg - h_ref).abs().max() / h_ref.abs().max())
        if not rel <= UTIL_NODAL_H_TOL:
            raise AssertionError(f"nodal_h_dg1 against get_nodal_h_ell on "
                                 f"irr640 f64: {rel:.3e} > {UTIL_NODAL_H_TOL}")
        for name, v in finals.items():
            flag = blown_up(v)
            if flag.device != v.device or bool(flag):
                raise AssertionError(f"blown_up({name}) is {flag}")
        n = int(u256.numel())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with StepTimer(n) as timer:
            p256.solve()
        end.record()
        end.synchronize()
        timer.count(p256.num_steps)
        rate_events = n * p256.num_steps / (start.elapsed_time(end) * 1e-3)
        ratio = timer.dof_steps_per_sec / rate_events
        if abs(ratio - 1.0) > UTIL_TIMER_TOL:
            raise AssertionError(f"StepTimer {timer.dof_steps_per_sec:.4g} "
                                 f"DOF-steps/s against CUDA events "
                                 f"{rate_events:.4g}")
        log(f"irr640 f64: nodal_h_dg1 against get_nodal_h_ell, max "
            f"relative difference {rel:.3e} (gate {UTIL_NODAL_H_TOL}); "
            f"blown_up False on the final states of {', '.join(finals)}; "
            f"StepTimer on a mesh-{big} solve {timer.dof_steps_per_sec:.6g} "
            f"DOF-steps/s, CUDA events {rate_events:.6g} ({ratio:.5f} x)")
        out["nodal_h_dg1_rel_err"] = rel
        out["step_timer"] = dict(dof_steps_per_s=timer.dof_steps_per_sec,
                                 cuda_events_dof_steps_per_s=rate_events)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"utilities phase: {out['seconds']:.0f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 12: the sharded twins (ROADMAP queue 1 item 15a) over LocalBlocks
# ---------------------------------------------------------------------------

# The adaptive KPP config of the JAX package's multichip path 1
# (__graft_entry__.py:120-121: krylov_rtol 1e-5, exact Newton), here in
# f32 at mesh 512 to T = 0.1 over 4 blocks (80 steps at the bench's dt),
# gated against the mesh-512 anchor; (mesh, T, blocks, anchor)
TWIN_KPP = dict(krylov_rtol=1e-5)
TWIN_KPP_PATH = (512, 0.1, 4, "kpp_rv_anchor_mesh512_T0.1.npy")
TWIN_F64_STEPS = 5
TWIN_F64_KPP = (64, (4, 3))        # mesh, block counts
TWIN_F64_BURGERS = (50, 4)
# the order of the timed solves of a run in turns with the single-device
# run; a long run (80 steps of mesh 512, 1382 of riemann2d 512: 7-9 s a
# solve) takes one turn each, to keep the phase near a minute
TWIN_TURNS = ("sharded", "single", "single", "sharded")
TWIN_TURNS_LONG = ("sharded", "single")
# Euler f32 cells (phase 9's anchors and gate) over TWIN_EULER_BLOCKS, with
# their turns; sod in f64 against its single-device run
TWIN_EULER = (("riemann2d", 512, TWIN_TURNS_LONG), ("sod", 100, TWIN_TURNS))
TWIN_EULER_BLOCKS = 4
TWIN_ID_TOL = 1e-10                # sharded against single device, f64
# the sharded carry checkpoint: KPP mesh 256 f32 (TWIN_KPP) over 4 blocks
# to T, a snapshot every TWIN_CKPT_EVERY steps; stopped at half, resumed
# on TWIN_CKPT_RESUME_BLOCKS. Cut from 200 steps with a snapshot every 100
# to 50 steps, every 25: a step of this config takes ~87 ms on the card,
# and the case solves 3.5 trajectories (62 s at 200 steps)
TWIN_CKPT = (256, 0.125, 4)        # mesh, T, blocks
TWIN_CKPT_EVERY = 25
TWIN_CKPT_RESUME_BLOCKS = 2
TWIN_TRACE_STEPS = 3


def _twin_kpp_cfg(kpp, mesh, dtype, **kw):
    return kpp.KPPConfig(mesh_size=mesh, dtype=dtype,
                         dt=0.01 * min(1.0, 64.0 / mesh), **TWIN_KPP, **kw)


class _KrylovCount:
    """Inside ``with``: the iterations of every adaptive cg and bicgstab
    call of the stencil and ELL paths, single-device and sharded (the
    names the modules call are wrapped, and put back on exit)."""

    def __enter__(self):
        from conservation_fem_tpu_torch.models import scalar_hyperbolic
        from conservation_fem_tpu_torch.models import (
            structured_hyperbolic as shp)
        from conservation_fem_tpu_torch.ops import newton
        from conservation_fem_tpu_torch.parallel import (structured_sharded,
                                                         unstructured_sharded)

        us = unstructured_sharded
        self.iters = dict(cg=0, bicgstab=0)
        self._saved = [(shp, "cg", shp.cg),
                       (structured_sharded, "cg", structured_sharded.cg),
                       (scalar_hyperbolic, "cg", scalar_hyperbolic.cg),
                       (us, "cg", us.cg), (us, "bicgstab", us.bicgstab),
                       (newton, "bicgstab", newton.bicgstab)]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        def counted(*args, **kw):
            res = fn(*args, **kw)
            self.iters[name] += res.iters
            return res
        return counted

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _rows_run(sh):
    """k -> the end state of a row-sharded twin after its first k steps."""
    return lambda k: sh._to_global(sh.run_chunk(sh.init_carry(), 0, k)[0])


def _twin_run(label, sharded, single, steps, turns):
    """A sharded twin beside the single-device run of the same problem,
    neither launching a hand-written kernel: the first REPEAT_STEPS steps
    of each solved twice, bit-equal (the warm-up); the whole trajectory
    timed on CUDA events in the order ``turns``, the Krylov iterations a
    step counted in the first solve of each; kernels a step and idle share
    over the first TWIN_TRACE_STEPS steps (torch.profiler).
    sharded(k), single(k): the end states after k steps. ({name: end
    state}, readings, their summary for the log)."""
    runs = dict(sharded=sharded, single=single)
    for name, fn in runs.items():
        _no_launch(label, lambda: _repeats(f"{label} {name}",
                                           lambda: fn(REPEAT_STEPS)))
    fields, us, krylov = {}, {k: [] for k in runs}, {}
    for name in turns:
        with _KrylovCount() as kc:
            u, t = _no_launch(label, lambda: _timed(
                lambda: runs[name](steps), steps))
        us[name].append(t)
        if name not in fields:
            fields[name] = u
            krylov[name] = {k: v / steps for k, v in kc.iters.items()}
    prof = {name: _no_launch(label, lambda: profiled(
        lambda: fn(TWIN_TRACE_STEPS), TWIN_TRACE_STEPS))
        for name, fn in runs.items()}
    for name, r in prof.items():
        if not r["device_kernels"]:
            # the profiler recorded no device activity at all (seen in a
            # side process beside three others): not measured, not 0
            prof[name] = dict.fromkeys(r)
    read = lambda name, key, fmt: ("not measured" if prof[name][key] is None
                                   else format(prof[name][key], fmt))
    med = {k: float(np.median(v)) for k, v in us.items()}
    text = (f"{med['sharded']:.1f} us/step against {med['single']:.1f} "
            f"single device in turns ({us['sharded']} / {us['single']}; "
            f"ratio {med['sharded'] / med['single']:.3f}); ")
    if any(krylov["sharded"].values()):
        text += (f"Krylov iterations a step {krylov['sharded']} / "
                 f"{krylov['single']}; ")
    text += (f"kernels a step {read('sharded', 'kernels_per_step', '.1f')}"
             f" / {read('single', 'kernels_per_step', '.1f')}, idle share "
             f"{read('sharded', 'profiled_idle', '.4f')} / "
             f"{read('single', 'profiled_idle', '.4f')} (first "
             f"{TWIN_TRACE_STEPS} steps)")
    return fields, dict(us_per_step=us, krylov_iters_per_step=krylov,
                        profiled=prof, hand_written_launches=0), text


def run_twin_kpp(card):
    """(a) KPP f32 at mesh 512 over LocalBlocks(4), the adaptive config,
    against its anchor, in turns with the single-device stencil run."""
    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedStructuredKPP)

    mesh, T, n, anchor = TWIN_KPP_PATH
    p = kpp.build(_twin_kpp_cfg(kpp, mesh, "float32", T=T))
    sh = ShardedStructuredKPP(p, LocalBlocks(n, "cuda"))
    steps, nodes = p.num_steps, int(p.u0.numel())
    label = f"sharded twin kpp mesh {mesh} x {n} f32 adaptive"
    fields, row, text = _twin_run(
        label, _rows_run(sh), lambda k: _prefix(p, k).solve().u, steps,
        TWIN_TURNS_LONG)
    rel, lo, hi = _field_stats(fields["sharded"], mesh, anchor)
    rel_single, _, _ = _field_stats(fields["single"], mesh, anchor)
    log(f"{label} ({nodes} nodes, L {sh.L}), {steps} steps: {text}; L2rel "
        f"against the anchor {rel:.4e} (gate {ACCURACY_GATE}), single "
        f"device {rel_single:.4e}; max|sharded - single| "
        f"{max_err(fields['sharded'], fields['single']):.3e}; u in "
        f"[{lo:.4f}, {hi:.4f}] ({card})")
    if not rel <= ACCURACY_GATE:
        raise AssertionError(f"{label}: L2rel {rel:.3e} > {ACCURACY_GATE}")
    return dict(nodes=nodes, steps=steps, blocks=n, L=sh.L,
                l2rel_vs_anchor=rel, l2rel_single_vs_anchor=rel_single,
                **row)


def run_twin_f64(card):
    """(b) f64 identity, TWIN_F64_STEPS steps: KPP mesh 64 over 4 and 3
    blocks against the single-device path on the card (TWIN_ID_TOL) and on
    the CPU (F64_CARD_VS_CPU); Burgers mesh 50 over 4 blocks against its
    single-device run."""
    from conservation_fem_tpu_torch.models import burgers, kpp
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedStructuredKPP)

    out = {}
    mesh, counts = TWIN_F64_KPP
    cfg = kpp.KPPConfig(mesh_size=mesh, T=TWIN_F64_STEPS * 0.01)
    p = kpp.build(cfg)
    assert p.num_steps == TWIN_F64_STEPS, p.num_steps
    u_card = _no_launch("kpp f64 single device", lambda: p.solve().u)
    u_cpu = kpp.build(cfg, device="cpu").solve().u
    for n in counts:
        u = _no_launch(f"sharded twin kpp f64 x {n}", ShardedStructuredKPP(
            p, LocalBlocks(n, "cuda")).solve)
        e_card, e_cpu = max_err(u, u_card), max_err(u.cpu(), u_cpu)
        log(f"sharded twin kpp mesh {mesh} x {n} f64, {TWIN_F64_STEPS} "
            f"steps: max|sharded - single device| {e_card:.3e} on the card "
            f"(gate {TWIN_ID_TOL}), {e_cpu:.3e} against the CPU (gate "
            f"{F64_CARD_VS_CPU}) ({card})")
        if not (e_card <= TWIN_ID_TOL and e_cpu <= F64_CARD_VS_CPU):
            raise AssertionError(f"sharded twin kpp f64 x {n}: {e_card}, "
                                 f"{e_cpu}")
        out[f"kpp_mesh{mesh}_x{n}"] = dict(vs_single_card=e_card,
                                           vs_single_cpu=e_cpu)
    mesh, n = TWIN_F64_BURGERS
    q = _prefix(burgers.build(burgers.BurgersConfig(mesh_size=mesh)),
                TWIN_F64_STEPS)
    u_single = _no_launch("burgers f64 single device", lambda: q.solve().u)
    u = _no_launch(f"sharded twin burgers f64 x {n}",
                   ShardedStructuredKPP(q, LocalBlocks(n, "cuda")).solve)
    e = max_err(u, u_single)
    log(f"sharded twin burgers mesh {mesh} x {n} f64, {TWIN_F64_STEPS} "
        f"steps: max|sharded - single device| {e:.3e} (gate {TWIN_ID_TOL}) "
        f"({card})")
    if not e <= TWIN_ID_TOL:
        raise AssertionError(f"sharded twin burgers f64: {e}")
    out[f"burgers_mesh{mesh}_x{n}"] = dict(vs_single_card=e)
    return out


def run_twin_euler(card):
    """(c) Euler over LocalBlocks(TWIN_EULER_BLOCKS): the f32 cells of
    TWIN_EULER against phase 9's anchors (EULER_GATE), in turns with the
    single-device run; sod in f64 against its single-device run."""
    from conservation_fem_tpu_torch.models import euler
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedStructuredEuler)

    out, n = {}, TWIN_EULER_BLOCKS
    for prob, nx, turns in TWIN_EULER:
        ref = EULER_STOKES_REFERENCE["euler"][f"{prob}:{nx}"]
        p = euler.build(euler.EulerConfig(problem=prob, nx=nx,
                                          dtype="float32"))
        if (p.num_steps, p.dt) != (ref["steps"], ref["dt"]):
            raise AssertionError(f"euler {prob}:{nx}: {p.num_steps} steps, "
                                 f"dt {p.dt}; the JAX package's {ref}")
        sh = ShardedStructuredEuler(p, LocalBlocks(n, "cuda"))
        label = f"sharded twin euler {prob}:{nx} x {n} f32"
        fields, row, text = _twin_run(
            label, _rows_run(sh), lambda k: euler.solve(p, num_steps=k).U,
            p.num_steps, turns)
        a = np.load(os.path.join(REPO, "golden",
                                 f"euler_{prob}_anchor_nx{nx}.npy"))
        U = fields["sharded"].double().cpu().numpy()
        rel = _l2rel(U, a.astype(np.float64))
        rel_single = _l2rel(fields["single"].double().cpu().numpy(),
                            a.astype(np.float64))
        log(f"{label} ({U.shape[0]} nodes, L {sh.L}), {p.num_steps} steps: "
            f"{text}; L2rel against the anchor {rel:.4e} (gate "
            f"{EULER_GATE}), single device {rel_single:.4e} ({card})")
        if not (np.isfinite(U).all() and rel < EULER_GATE):
            raise AssertionError(f"{label}: L2rel {rel}")
        out[f"{prob}:{nx} f32"] = dict(
            nodes=int(U.shape[0]), steps=p.num_steps, blocks=n, L=sh.L,
            l2rel_vs_anchor=rel, l2rel_single_vs_anchor=rel_single, **row)
    p = euler.build(euler.EulerConfig(problem="sod", nx=100))
    U_single = _no_launch("euler sod f64 single device",
                          lambda: euler.solve(p).U)
    U = _no_launch(f"sharded twin euler sod f64 x {n}",
                   ShardedStructuredEuler(p, LocalBlocks(n, "cuda")).solve)
    e = max_err(U, U_single)
    log(f"sharded twin euler sod:100 x {n} f64, {p.num_steps} steps: "
        f"max|sharded - single device| {e:.3e} (gate {TWIN_ID_TOL}) "
        f"({card})")
    if not e <= TWIN_ID_TOL:
        raise AssertionError(f"sharded twin euler sod f64: {e}")
    out["sod:100 f64"] = dict(vs_single_card=e, steps=p.num_steps)
    return out


def run_twin_checkpoint(card):
    """(d) the sharded carry checkpoint, KPP f32 (TWIN_KPP) at TWIN_CKPT:
    solve_checkpointed every TWIN_CKPT_EVERY steps bit-equal to solve();
    a run stopped at half and resumed on TWIN_CKPT_RESUME_BLOCKS blocks
    from its snapshot bit-equal to the continuation from an in-memory
    transfer of the same carry; bytes and ms a save."""
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedStructuredKPP)

    mesh, T, n = TWIN_CKPT
    every, m = TWIN_CKPT_EVERY, TWIN_CKPT_RESUME_BLOCKS
    p = kpp.build(_twin_kpp_cfg(kpp, mesh, "float32", T=T))
    steps, half = p.num_steps, p.num_steps // 2
    sh = ShardedStructuredKPP(p, LocalBlocks(n, "cuda"))
    label = f"sharded twin kpp mesh {mesh} x {n} f32 adaptive"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "twin.npz")
        u_plain, us_plain = _no_launch(label, lambda: _timed(sh.solve,
                                                             steps))
        u_ck, us_ck = _no_launch(label, lambda: _timed(
            lambda: sh.solve_checkpointed(path, every), steps))
        if not torch.equal(u_ck, u_plain):
            raise AssertionError(f"{label}: checkpointed solve differs")
        # stopped at half: the carry and its snapshot
        c_half = _no_launch(label, lambda: sh.run_chunk(sh.init_carry(), 0,
                                                        half))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = sh.save_carry(path, half, c_half)
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(written)
        sm = ShardedStructuredKPP(p, LocalBlocks(m, "cuda"))
        u_res = _no_launch(label, lambda: sm.solve_checkpointed(
            path, every, resume=True))
        direct = tuple(sm._from_global(sh._to_global(x)) for x in c_half)
        u_direct = _no_launch(label, lambda: sm._to_global(
            sm.run_chunk(direct, half, steps - half)[0]))
    same = torch.equal(u_res, u_direct)
    log(f"{label}, {steps} steps: solve_checkpointed every {every} "
        f"bit-equal to solve() ({us_ck:.1f} against {us_plain:.1f} "
        f"us/step); stopped at step {half}, resumed on {m} blocks from the "
        f"snapshot: equal to the in-memory transfer bit for bit: {same}; a "
        f"save {nbytes} B, {save_ms:.3f} ms ({card})")
    if not same:
        raise AssertionError(f"{label}: resumed run differs from the "
                             "in-memory transfer")
    return dict(steps=steps, every=every, blocks=n, resume_blocks=m,
                us_per_step_plain=us_plain, us_per_step_checkpointed=us_ck,
                save_bytes=nbytes, save_ms=save_ms,
                max_resumed_vs_plain=max_err(u_res, u_plain))


def twins_phase(card):
    """Phase 12: the sharded twins (ROADMAP queue 1 item 15a) over
    LocalBlocks on the card; no hand-written kernel lies under them, and
    every run is held to zero launches. The smoke run starts it in a
    process of its own beside phases 7-9 (SIDE_RUNS). The one-rank NCCL
    run (e) is in run_process_group_path (phase 5)."""
    t_phase = time.perf_counter()
    out = dict(kpp=run_twin_kpp(card), f64=run_twin_f64(card),
               euler=run_twin_euler(card),
               checkpoint=run_twin_checkpoint(card))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"sharded twins phase: {out['seconds']:.0f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 13: the unstructured twins (ROADMAP queue 1 item 15b) over LocalBlocks
# ---------------------------------------------------------------------------

# (a) DistributedKPP on phase 10's RCM-ordered irr640 over UNS_KPP_BLOCKS
# blocks: the irr640 f32 config (IRR[640]: dt 0.0009, T 0.09, 100 steps)
# on the ELL backend with the fixed-count fields at their defaults (the
# distributed class runs adaptive solvers whatever they hold) and
# krylov_rtol 1e-5 (TWIN_KPP, the JAX package's multichip paths; f32
# cannot reach the default 1e-12, so every solve would run to maxiter),
# gated at IRR_GATE against its anchor, in turns with the single-device
# ELL gather run of the same config
UNS_KPP_NX = 640
UNS_KPP_BLOCKS = 4
# (b) f64 identity, UNS_F64_STEPS steps, against the single-device run on
# the card (TWIN_ID_TOL), KPP also against the CPU (F64_CARD_VS_CPU);
# a second solve of each bit-equal to the first
UNS_F64_STEPS = 5
UNS_F64_KPP = (140, (4, 3))             # irr nx, block counts
UNS_F64_BURGERS = (50, 4)               # unit square nx, blocks: SI, l = 4
UNS_F64_ADVECTION = (32, ("rv_cell", "rk4"), 4)   # mesh, runs, blocks
# (c) owner cells, shard_problem on the ELL backend: f64 irr140 over 4
# blocks (UNS_F64_STEPS steps, against the single-device run); f32 irr640
# over 4 blocks, the fixed irr config (IRR_FIXED), its first 20 steps in
# turns with the single-device run
UNS_OWNER_F64 = (140, 4)
# (d) the one-rank NCCL run's mesh: irregular_mesh nx 64 (RCM order)
UNS_PG_MESH = 64
UNS_OWNER_F32 = (640, 4, 20)


def _uns_identity(label, fn, ref, tol=TWIN_ID_TOL):
    """fn() twice without a hand-written launch, bit-equal, and within tol
    of ref: (max error, the solution)."""
    import torch

    u = _no_launch(label, fn)
    if not torch.equal(_no_launch(label, fn), u):
        raise AssertionError(f"{label}: a second solve differs")
    e = max_err(u, ref)
    if not e <= tol:
        raise AssertionError(f"{label}: {e} from the single-device run")
    return e, u


def run_uns_kpp(card, m):
    """(a) DistributedKPP f32 at irr640 over UNS_KPP_BLOCKS blocks against
    its anchor, in turns with the single-device ELL gather run; the host
    seconds of the two partition builds."""
    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.parallel import DistributedKPP, LocalBlocks

    nx, n = UNS_KPP_NX, UNS_KPP_BLOCKS
    dt, T = IRR[nx]
    p = kpp.build(kpp.KPPConfig(dtype="float32", dt=dt, T=T, backend="ell",
                                **TWIN_KPP), host_mesh=m)
    p._force_lazy_operators()
    t0 = time.perf_counter()
    d = DistributedKPP(p, LocalBlocks(n, "cuda"))
    init_s = time.perf_counter() - t0
    label = f"unstructured twin kpp irr{nx} x {n} f32 adaptive"
    fields, row, text = _twin_run(
        label, lambda k: d.solve(num_steps=k),
        lambda k: _prefix(p, k).solve().u, p.num_steps, TWIN_TURNS_LONG)
    rel, lo, hi, _, _ = _irr_gate(fields["sharded"], nx, label)
    rel_single = _irr_gate(fields["single"], nx, label + " single")[0]
    ps = d.partition_seconds
    log(f"{label} ({m.n_nodes} nodes, n_own {d.n_own}, halo {d.H}, shared "
        f"{d.S}), {p.num_steps} steps: {text}; L2rel against the anchor "
        f"{rel:.4e} (gate {IRR_GATE}), single device {rel_single:.4e}; "
        f"max|sharded - single| "
        f"{max_err(fields['sharded'], fields['single']):.3e}; u in "
        f"[{lo:.4f}, {hi:.4f}]; build_partition "
        f"{ps['build_partition']:.3f} s, build_cell_partition "
        f"{ps['build_cell_partition']:.3f} s on the host, the class "
        f"{init_s:.3f} s in all ({card})")
    return dict(nodes=m.n_nodes, steps=p.num_steps, blocks=n,
                n_own=d.n_own, halo=d.H, shared=d.S,
                partition_seconds=ps, init_seconds=init_s,
                l2rel_vs_anchor=rel, l2rel_single_vs_anchor=rel_single,
                **row)


def run_uns_f64(card, m140):
    """(b) f64 identity, UNS_F64_STEPS steps: DistributedKPP at irr140 over
    4 and 3 blocks (card and CPU), Burgers SI with smoothing on the unit
    square nx 50 over 4 blocks, advection rv_cell and rk4 at mesh 32 over
    4 blocks, each against its single-device run on the card."""
    from conservation_fem_tpu_torch.models import burgers, kpp
    from conservation_fem_tpu_torch.models import linear_advection as adv
    from conservation_fem_tpu_torch.ops.mesh import rectangle_mesh
    from conservation_fem_tpu_torch.parallel import (DistributedAdvection,
                                                     DistributedHyperbolic,
                                                     DistributedKPP,
                                                     LocalBlocks)

    out, steps = {}, UNS_F64_STEPS
    nx, counts = UNS_F64_KPP
    dt = IRR[nx][0]
    cfg = kpp.KPPConfig(dt=dt, T=steps * dt, backend="ell")
    p = kpp.build(cfg, host_mesh=m140)
    assert p.num_steps == steps, p.num_steps
    u_card = _no_launch("kpp f64 irr140 single device", lambda: p.solve().u)
    u_cpu = kpp.build(cfg, host_mesh=m140, device="cpu").solve().u
    for n in counts:
        label = f"unstructured twin kpp irr{nx} x {n} f64"
        e, u = _uns_identity(label, DistributedKPP(
            p, LocalBlocks(n, "cuda")).solve, u_card)
        e_cpu = max_err(u.cpu(), u_cpu)
        log(f"{label}, {steps} steps: max|distributed - single device| "
            f"{e:.3e} on the card (gate {TWIN_ID_TOL}), {e_cpu:.3e} against "
            f"the CPU (gate {F64_CARD_VS_CPU}); a second solve bit-equal "
            f"({card})")
        if not e_cpu <= F64_CARD_VS_CPU:
            raise AssertionError(f"{label}: {e_cpu} from the CPU")
        out[f"kpp_irr{nx}_x{n}"] = dict(vs_single_card=e, vs_single_cpu=e_cpu)
    nx, n = UNS_F64_BURGERS
    q = _prefix(burgers.build(
        burgers.BurgersConfig(mesh_size=nx, backend="ell", stabilization="si",
                              smooth_l=4.0),
        host_mesh=rectangle_mesh((0, 0), (1, 1), nx=nx)), steps)
    label = f"unstructured twin burgers si l4 nx {nx} x {n} f64"
    ref = _no_launch(label, lambda: q.solve().u)
    e, _ = _uns_identity(label, DistributedHyperbolic(
        q, LocalBlocks(n, "cuda")).solve, ref)
    log(f"{label}, {steps} steps: max|distributed - single device| {e:.3e} "
        f"(gate {TWIN_ID_TOL}); a second solve bit-equal ({card})")
    out[f"burgers_si_nx{nx}_x{n}"] = dict(vs_single_card=e)
    mesh, runs, n = UNS_F64_ADVECTION
    for stab in runs:
        a = adv.build(adv.AdvectionConfig(mesh_size=mesh, stabilization=stab,
                                          rv_cell_scatter="max"))
        a = dataclasses.replace(a, num_steps=steps)
        label = f"unstructured twin advection {stab} mesh {mesh} x {n} f64"
        ref = _no_launch(label, lambda: adv.solve(a).u)
        e, _ = _uns_identity(label, DistributedAdvection(
            a, LocalBlocks(n, "cuda")).solve, ref)
        log(f"{label}, {steps} steps: max|distributed - single device| "
            f"{e:.3e} (gate {TWIN_ID_TOL}); a second solve bit-equal "
            f"({card})")
        out[f"advection_{stab}_mesh{mesh}_x{n}"] = dict(vs_single_card=e)
    return out


def run_uns_owner(card, m140, m640):
    """(c) shard_problem (owner cells, replicated nodes) on the ELL
    backend: f64 irr140 against the single-device run; f32 irr640 with the
    fixed irr config, its first UNS_OWNER_F32[2] steps in turns with the
    single-device run."""
    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.parallel import LocalBlocks, shard_problem

    nx, n = UNS_OWNER_F64
    dt = IRR[nx][0]
    cfg = kpp.KPPConfig(dt=dt, T=UNS_F64_STEPS * dt, backend="ell")
    label = f"owner cells kpp irr{nx} x {n} f64"
    ref = _no_launch(label, lambda: kpp.build(cfg, host_mesh=m140).solve().u)
    p = shard_problem(kpp.build(cfg, host_mesh=m140), LocalBlocks(n, "cuda"))
    e, _ = _uns_identity(label, lambda: p.solve().u, ref)
    log(f"{label}, {UNS_F64_STEPS} steps: max|owner cells - single device| "
        f"{e:.3e} (gate {TWIN_ID_TOL}); a second solve bit-equal ({card})")
    out = dict(f64=dict(vs_single_card=e))
    nx, n, steps = UNS_OWNER_F32
    dt, T = IRR[nx]
    cfg = kpp.KPPConfig(dtype="float32", dt=dt, T=T, backend="ell",
                        **IRR_FIXED)
    single = kpp.build(cfg, host_mesh=m640)
    sh = shard_problem(kpp.build(cfg, host_mesh=m640), LocalBlocks(n, "cuda"))
    label = f"owner cells kpp irr{nx} x {n} f32 fixed"
    fields, row, text = _twin_run(
        label, lambda k: _prefix(sh, k).solve().u,
        lambda k: _prefix(single, k).solve().u, steps, TWIN_TURNS)
    if not bool(fields["sharded"].isfinite().all()):
        raise AssertionError(f"{label}: not finite")
    diff = max_err(fields["sharded"], fields["single"])
    log(f"{label}, the first {steps} of {single.num_steps} steps: {text}; "
        f"max|owner cells - single| {diff:.3e} ({card})")
    out["f32"] = dict(nodes=m640.n_nodes, steps=steps, blocks=n,
                      max_vs_single=diff, **row)
    return out


def unstructured_phase(card):
    """Phase 13: the unstructured twins (ROADMAP queue 1 item 15b) over
    LocalBlocks on the card; no hand-written kernel lies under them, and
    every run is held to zero launches. The smoke run runs it after phase
    12 in their process beside phases 7-9 (SIDE_RUNS). The one-rank
    NCCL run (d) is in run_process_group_path (phase 5)."""
    t_phase = time.perf_counter()
    m140, m640 = irr_mesh(140), irr_mesh(UNS_KPP_NX)
    out = dict(kpp=run_uns_kpp(card, m640), f64=run_uns_f64(card, m140),
               owner_cells=run_uns_owner(card, m140, m640))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"unstructured twins phase: {out['seconds']:.0f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 14: the blocked twins on the ELL kernels, the sharded f64-
# accumulated reductions and the sharded Stokes (ROADMAP queue 1 item 15c)
# ---------------------------------------------------------------------------

# (a), (b) DistributedBlocked on phase 10's RCM-ordered irr640 over
# BT_BLOCKS blocks, the KPP RV f32 bench config (_blocked_cfg: IRR[640],
# IRR_FIXED) on the blocked and blocked2d backends, gated at IRR_GATE
# against the anchor, its ELL launches a step at blocked_launches, in turns
# with the single-device blocked run (BT_TURNS)
BT_NX = 640
BT_BLOCKS = 4
BT_TURNS = ("twin", "single", "single", "twin")
# (c) the JAX dry run's path 12 (f32, fixed counts, BiCGStab dots,
# precise_reductions) against the single device at BT_PRECISE_TOL
BT_PATH12 = dict(mesh_size=8, dtype="float32", T=0.05, backend="ell",
                 ell_matvec_backend="blocked", modified_newton=True,
                 cg_iters=6, newton_iters=2, newton_linear_iters=4,
                 inner_solver="bicgstab", precise_reductions=True)
BT_PRECISE_TOL = 1e-5
# (d) f64 identities, BT_F64_STEPS steps, against the card's single-device
# runs (TWIN_ID_TOL), a second solve bit-equal
BT_F64_STEPS = 5
BT_F64_KPP = (140, (4, 3))
BT_F64_KPP_RUNS = {"rv": {}, "si_smooth": dict(stabilization="si",
                                                smooth_l=2.0),
                   "matrix_free": dict(blocked_matrix_free=True)}
BT_F64_PK = 32            # P2 SI Burgers (PK_BURGERS), mesh
BT_F64_ADV = 32           # advection rv_node, mesh
# (e) ShardedStokes over BT_BLOCKS blocks: STOKES_BENCH f32 at nx 64 in
# turns with the lattice run under phase 9's gate (STOKES_ADAPTIVE_GATE
# against the lattice run); STOKES_IDENTITY f64 against the lattice run;
# multigrid f64 at nx 32 against the lattice multigrid run; backend="grid"
# against the lattice backend (STOKES_IDENTITY_GATE)
BT_STOKES_NX = 64
BT_STOKES_MG = dict(nx=32, num_steps=10, T=0.2, backend="lattice",
                    multigrid=True)


def _bt_timed(label, twin, single, steps, want):
    """The twin's end state and the single device's, timed in BT_TURNS
    after two bit-equal solves of REPEAT_STEPS steps each; the twin's
    first solve counted against ``want`` (its hand-written launches) and
    the single device's against the same; kernels a step and idle share
    over the first 3 steps. twin(k), single(k): the end states after k
    steps."""
    import torch

    from conservation_fem_tpu_torch.ops import _build

    runs = dict(twin=twin, single=single)
    for name, fn in runs.items():
        _repeats(f"{label} {name}", lambda: fn(REPEAT_STEPS))
    fields, us, counts = {}, {k: [] for k in runs}, {}
    for name in BT_TURNS:
        _build.launches.clear()
        u, t = _timed(lambda: runs[name](steps), steps)
        us[name].append(t)
        if name not in fields:
            fields[name], counts[name] = u, dict(_build.launches)
        elif not torch.equal(u, fields[name]):
            raise AssertionError(f"{label} {name}: repeated solves differ")
    for name, c in counts.items():
        if c != want:
            raise AssertionError(f"{label} {name}: launched {c}, the code "
                                 f"predicts {want}")
    prof = {name: profiled(lambda: fn(3), 3) for name, fn in runs.items()}
    med = {k: float(np.median(v)) for k, v in us.items()}
    per_step = {k: v / steps for k, v in counts["twin"].items()}
    text = (f"{med['twin']:.1f} us/step against {med['single']:.1f} single "
            f"device in turns ({us['twin']} / {us['single']}; ratio "
            f"{med['twin'] / med['single']:.3f}); ELL launches a step "
            f"{per_step} on both (as predicted); kernels a step "
            f"{prof['twin']['kernels_per_step']:.1f} / "
            f"{prof['single']['kernels_per_step']:.1f} (ratio "
            f"{prof['twin']['kernels_per_step'] / prof['single']['kernels_per_step']:.3f}), "
            f"idle share {prof['twin']['profiled_idle']:.4f} / "
            f"{prof['single']['profiled_idle']:.4f} (first 3 steps)")
    row = dict(us_per_step=us, us_ratio=med["twin"] / med["single"],
               launches_per_step=per_step, profiled=prof,
               kernels_ratio=(prof["twin"]["kernels_per_step"]
                              / prof["single"]["kernels_per_step"]))
    return fields, row, text


def run_bt_kpp(card, m640, backend):
    """(a) / (b) DistributedBlocked on irr640 over BT_BLOCKS blocks, the
    blocked (or blocked2d: the mesh tiled) f32 bench config."""
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.ops.tiling import tile_mesh
    from conservation_fem_tpu_torch.parallel import (DistributedBlocked,
                                                     LocalBlocks)

    nx, n = BT_NX, BT_BLOCKS
    m, slot = m640, None
    if backend == "blocked2d":
        m, slot = tile_mesh(m640)
    p = kpp.build(_blocked_cfg(kpp, nx, backend), host_mesh=m)
    p._force_lazy_operators()
    t0 = time.perf_counter()
    d = DistributedBlocked(p, LocalBlocks(n, "cuda"))
    init_s = time.perf_counter() - t0
    label = f"blocked twin {backend} irr{nx} x {n} f32 bench config"
    fields, row, text = _bt_timed(
        label, lambda k: d.solve(num_steps=k),
        lambda k: _prefix(p, k).solve().u, p.num_steps,
        blocked_launches(p.cfg, p.num_steps))
    native = lambda u: (u if slot is None
                        else u[torch.as_tensor(slot, device=u.device)])
    rel, lo, hi, _, _ = _irr_gate(native(fields["twin"]), nx, label)
    rel_single = _irr_gate(native(fields["single"]), nx,
                           label + " single")[0]
    diff = max_err(fields["twin"], fields["single"])
    log(f"{label} ({m.n_nodes} rows, {d.L} a block, halo {d.H}, "
        f"{d.bp.mesh.cells.shape[0]} block cells for {m.n_cells}), "
        f"{p.num_steps} steps: {text}; L2rel against the anchor {rel:.4e} "
        f"(gate {IRR_GATE}), single device {rel_single:.4e}; max|twin - "
        f"single| {diff:.3e}; u in [{lo:.4f}, {hi:.4f}]; the class "
        f"{init_s:.2f} s on the host ({card})")
    return dict(rows=m.n_nodes, steps=p.num_steps, blocks=n, L=d.L,
                halo=d.H, block_cells=int(d.bp.mesh.cells.shape[0]),
                cells=m.n_cells, init_seconds=init_s, l2rel_vs_anchor=rel,
                l2rel_single_vs_anchor=rel_single, max_vs_single=diff,
                **row)


def run_bt_precise(card, m640):
    """(c) path 12's precise_reductions config over BT_BLOCKS blocks
    against the single device (BT_PRECISE_TOL); irr640 over BT_BLOCKS
    blocks with and without the flag, the twin against the single device
    printed."""
    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.parallel import (DistributedBlocked,
                                                     LocalBlocks)

    n = BT_BLOCKS
    cfg = kpp.KPPConfig(**BT_PATH12)
    single = kpp.build(cfg).solve().u
    twin = DistributedBlocked(kpp.build(cfg), LocalBlocks(n, "cuda")).solve()
    e = max_err(twin, single)
    log(f"blocked twin path-12 config (KPP mesh 8 f32, BiCGStab, "
        f"precise_reductions) x {n}: max|twin - single| {e:.3e} (gate "
        f"{BT_PRECISE_TOL}) ({card})")
    if not e <= BT_PRECISE_TOL:
        raise AssertionError(f"blocked twin path 12: {e}")
    out = dict(path12=dict(max_vs_single=e))
    for flag in (False, True):
        p = kpp.build(_blocked_cfg(kpp, BT_NX, "blocked",
                                   precise_reductions=flag), host_mesh=m640)
        u1 = p.solve().u
        u4 = DistributedBlocked(p, LocalBlocks(n, "cuda")).solve()
        rel = _l2rel(u4.double().cpu().numpy(), u1.double().cpu().numpy())
        log(f"blocked twin irr{BT_NX} x {n} f32, precise_reductions={flag}: "
            f"L2rel twin against single {rel:.4e} (printed, not gated) "
            f"({card})")
        out[f"irr{BT_NX}_precise_{flag}"] = dict(l2rel_vs_single=rel)
    return out


def _bt_identity(label, fn, ref, kernels):
    """fn() twice, bit-equal, each launching every one of ``kernels``,
    within TWIN_ID_TOL of ref: (max error, launch counts)."""
    import torch

    u, c = _some_launches(label, fn, kernels)
    if not torch.equal(_some_launches(label, fn, kernels)[0], u):
        raise AssertionError(f"{label}: a second solve differs")
    e = max_err(u, ref)
    if not e <= TWIN_ID_TOL:
        raise AssertionError(f"{label}: {e} from the single-device run")
    return e, c


def run_bt_f64(card, m140):
    """(d) f64, BT_F64_STEPS steps, against the card's single-device
    runs: KPP irr140 (rv; si with l = 2 smoothing; the matrix-free Newton)
    over 4 and 3 blocks, P2 SI Burgers and advection rv_node over
    BT_BLOCKS blocks; each twin solve launches what the single-device one
    launched."""
    from conservation_fem_tpu_torch.models import burgers, kpp
    from conservation_fem_tpu_torch.models import linear_advection as la
    from conservation_fem_tpu_torch.parallel import (
        DistributedBlocked, DistributedBlockedAdvection, DistributedBlockedPk,
        LocalBlocks)

    out, steps = {}, BT_F64_STEPS

    def one(label, single, twin):
        ref, c1 = _some_launches(label + " single", single, ())
        e, c = _bt_identity(label, twin, ref, tuple(c1))
        log(f"{label}, {steps} steps: max|twin - single device| {e:.3e} "
            f"(gate {TWIN_ID_TOL}); a second solve bit-equal; launches "
            f"{c}, single device {c1} ({card})")
        return dict(vs_single_card=e, launches=c, single_launches=c1)

    nx, counts = BT_F64_KPP
    dt = IRR[nx][0]
    for name, over in BT_F64_KPP_RUNS.items():
        p = kpp.build(kpp.KPPConfig(dt=dt, T=steps * dt, backend="ell",
                                    ell_matvec_backend="blocked", **over),
                      host_mesh=m140)
        assert p.num_steps == steps, p.num_steps
        for n in counts:
            out[f"kpp_{name}_irr{nx}_x{n}"] = one(
                f"blocked twin kpp {name} irr{nx} x {n} f64",
                lambda: p.solve().u,
                DistributedBlocked(p, LocalBlocks(n, "cuda")).solve)
    q = _prefix(burgers.build(burgers.BurgersConfig(
        mesh_size=BT_F64_PK, ell_matvec_backend="blocked", **PK_BURGERS)),
        steps)
    out[f"burgers_p2si_mesh{BT_F64_PK}_x{BT_BLOCKS}"] = one(
        f"blocked Pk twin burgers P2 SI mesh {BT_F64_PK} x {BT_BLOCKS} f64",
        lambda: q.solve().u,
        DistributedBlockedPk(q, LocalBlocks(BT_BLOCKS, "cuda")).solve)
    a = la.build(la.AdvectionConfig(mesh_size=BT_F64_ADV,
                                    stabilization="rv_node",
                                    ell_matvec_backend="blocked"))
    a = dataclasses.replace(a, num_steps=steps)
    out[f"advection_rv_node_mesh{BT_F64_ADV}_x{BT_BLOCKS}"] = one(
        f"blocked advection twin rv_node mesh {BT_F64_ADV} x {BT_BLOCKS} "
        "f64", lambda: la.solve(a).u,
        DistributedBlockedAdvection(a, LocalBlocks(BT_BLOCKS, "cuda")).solve)
    return out


def run_bt_stokes(card):
    """(e) ShardedStokes over BT_BLOCKS blocks, no hand-written launch:
    f32 nx BT_STOKES_NX in turns with the lattice run (gate
    STOKES_ADAPTIVE_GATE against it); f64 STOKES_IDENTITY and the
    multigrid BT_STOKES_MG against the lattice runs, backend="grid"
    against the lattice backend (STOKES_IDENTITY_GATE)."""
    import torch

    from conservation_fem_tpu_torch.models import stokes
    from conservation_fem_tpu_torch.parallel import LocalBlocks, ShardedStokes

    out, n = {}, BT_BLOCKS
    kw = dict(nx=BT_STOKES_NX, backend="lattice", **STOKES_BENCH)
    steps = kw["num_steps"]
    sh = ShardedStokes(*stokes.build(stokes.StokesConfig(**kw)),
                       LocalBlocks(n, "cuda"))
    _, run = _stokes_stepper(**kw)
    label = f"stokes twin nx {BT_STOKES_NX} f32 x {n}"
    fields, row, text = _twin_run(
        label, lambda k: sh.solve(num_steps=k)[0], lambda k: run(k)[0],
        steps, TWIN_TURNS_LONG)
    d = max_err(fields["sharded"], fields["single"])
    log(f"{label}, {steps} steps: {text}; Linf against the lattice run "
        f"{d:.3e} (gate {STOKES_ADAPTIVE_GATE}) ({card})")
    if not d <= STOKES_ADAPTIVE_GATE:
        raise AssertionError(f"{label}: Linf {d}")
    out[f"f32_nx{BT_STOKES_NX}"] = dict(linf_vs_lattice=d, **row)
    for name, cfg in (("f64_identity", dict(STOKES_IDENTITY,
                                            backend="lattice")),
                      ("f64_multigrid", BT_STOKES_MG)):
        tag = f"stokes twin {name} nx {cfg['nx']} x {n}"
        ref = _no_launch(tag, lambda: stokes.solve(
            cfg=stokes.StokesConfig(**cfg)))
        u, pr = _no_launch(tag, ShardedStokes(
            *stokes.build(stokes.StokesConfig(**cfg)),
            LocalBlocks(n, "cuda")).solve)
        e = max(max_err(u, ref.u), max_err(pr, ref.p))
        log(f"{tag}, {cfg['num_steps']} steps: max|twin - lattice| {e:.3e} "
            f"(gate {STOKES_IDENTITY_GATE}) ({card})")
        if not e <= STOKES_IDENTITY_GATE:
            raise AssertionError(f"{tag}: {e}")
        out[name] = dict(max_vs_lattice=e)
    cfg = dict(STOKES_IDENTITY)
    g = _no_launch("stokes grid", lambda: stokes.solve(
        cfg=stokes.StokesConfig(backend="grid", **cfg)))
    lt = stokes.solve(cfg=stokes.StokesConfig(backend="lattice", **cfg))
    e = max(max_err(g.u, lt.u), max_err(g.p, lt.p))
    log(f"stokes backend grid nx {cfg['nx']} f64, {cfg['num_steps']} steps: "
        f"max|grid - lattice| {e:.3e} (gate {STOKES_IDENTITY_GATE}); "
        f"Poiseuille L2 error {g.error_l2!r}, lattice {lt.error_l2!r} "
        f"({card})")
    if not (e <= STOKES_IDENTITY_GATE and torch.isfinite(g.u).all()):
        raise AssertionError(f"stokes grid: {e}")
    out["grid_vs_lattice"] = dict(max_vs_lattice=e, error_l2=g.error_l2)
    out["hand_written_launches"] = 0
    return out


def run_bt_fused_precise(card):
    """(g) ShardedFusedStructured with precise_reductions (read nowhere, as
    in the JAX class) at mesh 64 over BT_BLOCKS blocks, each block-mode
    kernel: the same launches and bits as without the flag."""
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedFusedStructured)

    out = {}
    for kernel in ("block", "tiled"):
        res = {}
        for flag in (False, True):
            cfg = _sharded_cfg(kpp, 64, "float32", T=0.05,
                               precise_reductions=flag)
            sh = ShardedFusedStructured(kpp.build(cfg),
                                        LocalBlocks(BT_BLOCKS, "cuda"),
                                        kernel=kernel)
            res[flag] = _some_launches(f"sharded fused {kernel}", sh.solve,
                                       ())
        same = torch.equal(res[False][0], res[True][0])
        log(f"sharded fused mesh 64 f32 x {BT_BLOCKS} ({kernel} kernel) "
            f"with precise_reductions: launches {res[True][1]}, without "
            f"{res[False][1]}; bit-equal: {same} ({card})")
        if not same or res[True][1] != res[False][1] or not res[True][1]:
            raise AssertionError(f"sharded fused {kernel}: the flag changed "
                                 "the run")
        out[kernel] = dict(launches=res[True][1], bit_equal=same)
    return out


def blocked_twins_phase(card):
    """Phase 14: the blocked twins on the ELL kernels over LocalBlocks,
    the sharded reductions, ShardedStokes and backend="grid", and the
    sharded fused path with precise_reductions (ROADMAP queue 1 item 15c).
    The smoke run starts it in a process of its own beside phases 7-9
    (SIDE_RUNS). The one-rank NCCL run (f) is in run_process_group_path
    (phase 5)."""
    t_phase = time.perf_counter()
    m140, m640 = irr_mesh(140), irr_mesh(BT_NX)
    out = dict(kpp_blocked=run_bt_kpp(card, m640, "blocked"),
               kpp_blocked2d=run_bt_kpp(card, m640, "blocked2d"),
               precise=run_bt_precise(card, m640),
               f64=run_bt_f64(card, m140), stokes=run_bt_stokes(card),
               fused_precise=run_bt_fused_precise(card))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"blocked twins phase: {out['seconds']:.0f} s ({card})")
    return out


# Phase 15, the example scripts at the JAX scripts' own sizes. The JAX
# package's numbers, printed on the CPU by
#   python3 scripts/examples_reference.py
# (which also writes its KPP mesh-16 u to scripts/examples_reference_kpp16.npy);
# make_figures' advection runs are ADVECTION_REFERENCE's sweep
EXAMPLES_REFERENCE = {
    "burgers60": {"l1": 0.03062670091817181, "l2": 0.1146828404034617,
                  "steps": 61},
    "gif": {"dt": 0.007033721219977391, "frames": 8,
            "max": 0.8151656120895284, "min": -0.015522761603720429},
    "kpp16": {"max": 11.10870837744607, "min": 0.6880508740068588,
              "steps": 100},
    "kpp8": {"converged": True, "max": 10.689062175211161,
             "min": 0.6863768580181415, "steps": 100},
    "mesh": {"boundary": 96, "cells": 1536, "nodes": 817},
    "poisson": {"iters": 49, "l2": 0.0009614028601883906},
    "sod200": {"dt": 0.0010564428184106232,
               "l1_density": 0.008736580434692508, "steps": 190}}
EXAMPLES_KPP16 = os.path.join("scripts", "examples_reference_kpp16.npy")
# the f64 examples against the JAX package's numbers (Poisson L2 and KPP
# min/max, relative and absolute), KPP mesh 16 L2rel, the sharded run's
# max |diff| from the single one (the twins' f64 standard)
EXAMPLES_F64_TOL = 1e-10
EXAMPLES_SOD_RTOL = 1e-8   # the L1 density error, relative
EXAMPLES_BLOCKS = 4        # the tutorial's --blocks default
# Burgers mesh 60, the f64 reference config, grows roundoff ~1e6-fold over
# its 61 steps: the JAX package's own scan solve and its step jitted and
# chained end with L2 errors 0.1146828404034617 and 0.11468284040369141
# against the exact solution (scripts/burgers_roundoff_growth.py 60, CPU
# f64); the port's is held to the first within SPREAD_FACTOR x this spread
EXAMPLES_BURGERS_SPREAD = abs(0.11468284040369141 - 0.1146828404034617)


def _example_section(label, fn):
    """(fn(), wall seconds), launching no hand-written kernel."""
    t0 = time.perf_counter()
    out = _no_launch(f"examples {label}", fn)
    return out, time.perf_counter() - t0


def _example_gate(label, ok, msg, card):
    log(f"examples {label}: {msg} ({card})")
    if not ok:
        raise AssertionError(f"examples {label}: {msg}")


def examples_phase(card, device="cuda"):
    """Phase 15: the port's example scripts (conservation_fem_tpu_torch/
    examples/) on ``device`` at the JAX scripts' own sizes, each section
    called by name as main() calls it, none drawing (matplotlib, PIL and
    h5py are not on the card's machine: the tutorial's section 5 and the
    figures run on the CPU, tests/test_torch_examples.py). The tutorial's
    sections 1-4 and 6 (over LocalBlocks(EXAMPLES_BLOCKS)) and
    make_figures' computations 1-6, each gated against the JAX package's
    numbers (EXAMPLES_REFERENCE, ADVECTION_REFERENCE) and launching no
    hand-written kernel. The smoke run starts it in a process of its own
    (SIDE_RUNS)."""
    import torch

    from conservation_fem_tpu_torch.examples import make_figures as mf
    from conservation_fem_tpu_torch.examples import tutorial as tu
    from conservation_fem_tpu_torch.models import burgers, euler

    t_phase = time.perf_counter()
    ref, tut, fig = EXAMPLES_REFERENCE, {}, {}

    (mesh, m), s = _example_section("meshes", lambda: tu.meshes(device))
    got = dict(nodes=mesh.n_nodes, cells=mesh.n_cells,
               boundary=int(mesh.boundary_mask.sum()))
    _example_gate("tutorial 1 meshes", got == ref["mesh"]
                  and m.points.device.type == torch.device(device).type,
                  f"{got} on {m.points.device} (the JAX package's "
                  f"{ref['mesh']})", card)
    tut["meshes"] = dict(got, seconds=s)

    (sol, err), s = _example_section("poisson", lambda: tu.poisson(m))
    got = dict(iters=int(sol.iters), l2=float(err))
    r = _rel(got["l2"], ref["poisson"]["l2"])
    _example_gate("tutorial 2 poisson",
                  got["iters"] == ref["poisson"]["iters"]
                  and r <= EXAMPLES_F64_TOL,
                  f"CG iters {got['iters']}, L2 {got['l2']!r}; the JAX "
                  f"package's {ref['poisson']} (relative {r:.3e}, gate "
                  f"{EXAMPLES_F64_TOL})", card)
    tut["poisson"] = dict(got, l2_rel_to_jax=r, seconds=s)

    (cfg, problem, result), s = _example_section(
        "stabilized run", lambda: tu.stabilized_run(device))
    u = result.u
    got = dict(steps=result.num_steps,
               converged=bool(result.metrics["newton_converged"].all()),
               min=float(u.min()), max=float(u.max()))
    d = max(abs(got[k] - ref["kpp8"][k]) for k in ("min", "max"))
    _example_gate("tutorial 3 KPP mesh 8",
                  (got["steps"], got["converged"]) == (100, True)
                  and d <= EXAMPLES_F64_TOL,
                  f"{got}; the JAX package's {ref['kpp8']} (|diff| {d:.3e}, "
                  f"gate {EXAMPLES_F64_TOL})", card)
    tut["kpp_mesh8"] = dict(got, diff_to_jax=d, seconds=s)

    with tempfile.TemporaryDirectory() as tmp:
        (r1, r2), s = _example_section(
            "checkpoint/resume", lambda: tu.checkpoint_resume(cfg, device,
                                                              tmp))
    same = bool(torch.equal(r1.u, u))
    log(f"examples tutorial 4 checkpoint/resume: the resumed run bit-equal "
        f"to the checkpointed one (checkpoint_resume raises otherwise); the "
        f"checkpointed run bit-equal to section 3's: {same} ({card})")
    tut["checkpoint_resume"] = dict(bit_exact=True,
                                    equal_to_section3=same, seconds=s)

    (u_sh, diff), s = _example_section(
        "sharded", lambda: tu.sharded_solve(cfg, u, device, EXAMPLES_BLOCKS))
    _example_gate(f"tutorial 6 sharded over {EXAMPLES_BLOCKS} blocks",
                  diff <= EXAMPLES_F64_TOL,
                  f"max |diff| vs single = {diff:.3e} (gate "
                  f"{EXAMPLES_F64_TOL})", card)
    tut["sharded"] = dict(blocks=EXAMPLES_BLOCKS, max_diff=diff, seconds=s)

    adv = ADVECTION_REFERENCE["sweep"]
    (p, res), s = _example_section("advection", lambda: mf.advection(device))
    err, k = float(res.error_l2), ADV_SWEEP.index(16)
    r = _rel(err, adv["rv_node"]["errors"][k])
    _example_gate("figures 1 advection rv_node mesh 16",
                  res.num_steps == adv["rv_node"]["steps"][k]
                  and r <= ADV_ERR_RTOL,
                  f"{res.num_steps} steps, L2 error {err!r}; the JAX "
                  f"package's {adv['rv_node']['errors'][k]!r} (relative "
                  f"{r:.3e}, gate {ADV_ERR_RTOL})", card)
    fig["advection"] = dict(steps=res.num_steps, error=err, rel_to_jax=r,
                            seconds=s)

    conv, s = _example_section("convergence", lambda: mf.convergence(device))
    want = adv["gfem"]["errors"][:3]
    r = max(_rel(a, b) for a, b in zip(conv.errors, want))
    _example_gate("figures 2 gfem convergence (4, 8, 16)",
                  r <= ADV_ERR_RTOL,
                  f"errors {[float(e) for e in conv.errors]}, slope "
                  f"{conv.slope:.4f}; the JAX package's {want} (relative "
                  f"{r:.3e}, gate {ADV_ERR_RTOL})", card)
    fig["convergence"] = dict(errors=[float(e) for e in conv.errors],
                              slope=conv.slope, rel_to_jax=r, seconds=s)

    (p, res), s = _example_section("kpp", lambda: mf.kpp_wave(device))
    uj = np.load(os.path.join(REPO, EXAMPLES_KPP16))
    r = _l2rel(res.u.cpu().numpy(), uj)
    _example_gate("figures 3 KPP mesh 16",
                  res.num_steps == ref["kpp16"]["steps"]
                  and r <= EXAMPLES_F64_TOL,
                  f"{res.num_steps} steps, L2rel against the JAX "
                  f"package's u {r:.3e} (gate {EXAMPLES_F64_TOL})", card)
    fig["kpp_mesh16"] = dict(steps=res.num_steps, l2rel_to_jax=r, seconds=s)

    (p, res, ex), s = _example_section(
        "burgers", lambda: mf.burgers_riemann(device))
    l2 = float(burgers.l2_error_vs_exact(p, res.u, 0.5))
    d = abs(l2 - ref["burgers60"]["l2"])
    gate = SPREAD_FACTOR * EXAMPLES_BURGERS_SPREAD
    _example_gate("figures 4 Burgers mesh 60",
                  p.num_steps == ref["burgers60"]["steps"] and d <= gate
                  and ex.shape == res.u.shape
                  and bool(torch.isfinite(ex).all()),
                  f"{p.num_steps} steps, L2 error against the exact "
                  f"solution {l2!r}; the JAX package's "
                  f"{ref['burgers60']['l2']!r} (|diff| {d:.3e}, gate "
                  f"{SPREAD_FACTOR} x its own spread "
                  f"{EXAMPLES_BURGERS_SPREAD:.3e})", card)
    fig["burgers_mesh60"] = dict(steps=p.num_steps, l2=l2, diff_to_jax=d,
                                 gate=gate, seconds=s)

    (p, res, x, t_end, rho_ex), s = _example_section(
        "sod", lambda: mf.sod(device))
    l1 = euler.sod_density_error(p, res.U, t_end)
    r = _rel(l1, ref["sod200"]["l1_density"])
    _example_gate("figures 5 Sod nx 200",
                  (res.num_steps, res.dt) == (ref["sod200"]["steps"],
                                              ref["sod200"]["dt"])
                  and r <= EXAMPLES_SOD_RTOL and rho_ex.shape == x.shape,
                  f"{res.num_steps} steps to t = {t_end!r}, L1 density "
                  f"error {l1!r}; the JAX package's "
                  f"{ref['sod200']['l1_density']!r} (relative {r:.3e}, gate "
                  f"{EXAMPLES_SOD_RTOL})", card)
    fig["sod_nx200"] = dict(steps=res.num_steps, l1_density=l1,
                            rel_to_jax=r, seconds=s)

    (p, us), s = _example_section("evolution", lambda: mf.evolution(device))
    got = dict(frames=len(us), dt=p.dt, min=float(us[-1].min()),
               max=float(us[-1].max()))
    d = max(abs(got[k] - ref["gif"][k]) for k in ("min", "max"))
    _example_gate("figures 6 evolution mesh 8",
                  (got["frames"], got["dt"]) == (ref["gif"]["frames"],
                                                 ref["gif"]["dt"])
                  and d <= EXAMPLES_F64_TOL,
                  f"{got}; the JAX package's {ref['gif']} (|diff| {d:.3e}, "
                  f"gate {EXAMPLES_F64_TOL})", card)
    fig["evolution"] = dict(got, diff_to_jax=d, seconds=s)

    out = dict(tutorial=tut, make_figures=fig, card=card,
               seconds=time.perf_counter() - t_phase)
    log(f"examples phase: {out['seconds']:.0f} s ({card})")
    return out


def main(argv):
    card = phase_device()
    import torch

    regs = phase_build()
    if argv[1:] == ["--ablate"]:
        log(card)
        log(json.dumps({"ablation": ablate(card)}))
    elif argv[1:2] == ["--against"] and (len(argv) == 3 or argv[3:] == [
            "--ell"]):
        log(json.dumps({"against": against(argv[2], card,
                                           ell_only=len(argv) == 4)}))
    elif argv[1:]:
        raise SystemExit(f"usage: {argv[0]} [--ablate | --against DIR "
                         "[--ell]]")
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
    check_tiled_bf16(summary, states, regs, card)
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
    bf16 = run_bf16_paths(card, counts, runs)
    # Burgers: each kernel's instance against its plain version and timed,
    # the f64 reference config, the fixed config's main paths, one sharded
    # run per block-mode kernel
    burgers_rows = check_burgers_kernels(regs)
    burgers_cg = run_burgers_reference()
    b_counts, b_runs = run_burgers_paths(card)
    sharded_counts, sharded_runs = run_burgers_sharded()
    b_counts.update(sharded_counts)
    b_runs.update(sharded_runs)
    # phases 7-9, 12, 13 and 15 launch no hand-written kernel: the ELL
    # backend and the stabilisation library (the JAX package runs them as
    # XLA gathers), linear advection and the Pk layer, compressible Euler
    # and Stokes/IPCS, the sharded and the unstructured twins, the example
    # scripts; phase 14, the
    # blocked twins, launches the ELL kernels in a process of its own (its
    # counts are its own, not the kernels line's); SIDE_RUNS run in
    # processes of their own beside the rest
    t_side = time.perf_counter()
    sides = [_side_start(names, card) for names in SIDE_RUNS]
    try:
        meshes = irr_meshes()
        ell = dict(irr=run_ell_paths(card, meshes),
                   irr140_f64=run_ell_f64(meshes),
                   kpp_si_mesh64=run_kpp_si(card))
        advection = dict(advection_f32=run_advection_f32(card),
                         pk_burgers=run_pk_burgers(card),
                         pk_burgers_timed=time_pk_burgers(card))
        log(f"phases 7 and 8 in this process: "
            f"{time.perf_counter() - t_side:.0f} s ({card})")
        side = {}
        for s in sides:
            side.update(_side_join(s))
    finally:
        for s in sides:
            _side_stop(s)
    ell["burgers"] = side["run_burgers_si"]
    advection.update(advection_f64=side["run_advection_f64"],
                     pk_advection=side["run_pk_advection"])
    euler_stokes = side["euler_stokes_phase"]
    twins = side["twins_phase"]
    unstructured = side["unstructured_phase"]
    blocked_twins = side["blocked_twins_phase"]
    examples = side["examples_phase"]
    log(f"phases 7, 8, 9, 12, 13, 14 and 15: "
        f"{time.perf_counter() - t_side:.0f} s ({card})")
    # the unstructured fast path on the hand-written ELL kernels, on phase
    # 7's meshes
    fast, ell_rows, ell_counts, irr640 = blocked_phase(card, meshes, regs)
    # the utilities and solve()'s checkpoint, resume and streaming through
    # the step kernels and the ELL kernels
    utilities = utilities_phase(card, meshes[640], irr640)
    del irr640
    meshes.clear()
    summary.update(ell_rows)
    for name in ELL_KERNELS:
        counts[name] = ell_counts.get(name, 0)
        runs[name] = "blocked irr640 f32 bench config (KPP RV), " \
                     "the unstructured main path"
    # name: (source, TPU kernel it replaces)
    sources = {
        "stencil_matvec": ("stencil.cu", "ops/pallas_stencil.py:40"),
        "cg_solve": ("stencil.cu", "ops/pallas_stencil.py:64"),
        "fused_rv_step": ("fused_step.cu", "ops/pallas_fused.py:416"),
        "split_setup": ("split_step.cu", "ops/pallas_fused.py:585"),
        "split_newton": ("split_step.cu", "ops/pallas_fused.py:634"),
        "tiled_rv_step": ("tiled_step.cu", "ops/pallas_tiled.py:120"),
        "tiled_rv_step_block": ("tiled_step.cu", "ops/pallas_tiled.py:135"),
        "tiled_rv_step_bf16": ("tiled_step_bf16.cu",
                               "ops/pallas_tiled.py:178"),
        "tiled_rv_step_block_bf16": ("tiled_step_bf16.cu",
                                     "ops/pallas_tiled.py:178"),
        "fused_rv_block_step": ("block_step.cu", "ops/pallas_fused.py:491"),
        **ELL_KERNELS,
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
    log(json.dumps({"ell": ell}))
    log(json.dumps({"advection": advection}))
    log(json.dumps({"euler_stokes": euler_stokes}))
    log(json.dumps({"unstructured_fast_path": fast}))
    log(json.dumps({"utilities": utilities}))
    log(json.dumps({"sharded_twins": twins}))
    log(json.dumps({"unstructured_twins": unstructured}))
    log(json.dumps({"blocked_twins": blocked_twins}))
    log(json.dumps({"bf16_planes": bf16}))
    log(json.dumps({"examples": examples}))
    log(card)
    log(json.dumps({"kernels": rows}))


if __name__ == "__main__":
    sys.exit(main(sys.argv))
