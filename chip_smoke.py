"""Drive the PyTorch + CUDA port (conservation_fem_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --ablate   # the step ablation and idle share

Phases of the smoke run, in order; any failure raises and the process
exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), TF32 flags;
     no CUDA device -> error;
  2. build: compile csrc/*.cu with nvcc (seconds printed);
  3. each hand-written kernel against its plain PyTorch version on the card,
     numpy-seeded inputs: stencil_matvec (257^2, 1025^2; f32, f64), cg_solve
     (mesh-64 mass stencil; rtol 1e-10 f64, 1e-5 f32), fused_rv_step from a
     mid-trajectory state (mesh 16 and 64: bicgstab and cheby, frozen and
     fresh Jacobian; mesh 256: the bench config; f32 at mesh 64 and 256).
     f64 is gated at 1e-11 (reduction order differs; the bound of the JAX
     package's own fused identity tests), f32 at 1e-4 (O(1-10) fields,
     single-precision rounding over a few hundred operations);
  4. the main path at mesh 64: the bench f32 config (fixed iterations,
     modified Newton 2 x BiCGStab(4), one fused_rv_step launch per step,
     T = 1.0, 100 steps) gated at L2rel <= 1e-2 against
     golden/kpp_rv_anchor_mesh64.npy; then, as a run of its own, 5 steps of
     the adaptive f64 config with kernels on (cg_solve mass solve), checked
     against the same steps without kernels. Launch counts are zeroed just
     before each of the two runs and read just after it. Times (CUDA events,
     after a warm-up) for the kernel path and the plain-torch composed path;
  5. mesh 256 f32 (dt 0.0025, 400 steps), same recipe, gated against
     golden/kpp_rv_anchor_mesh256.npy, timed the same way.
The second-to-last line is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.

The ablation (--ablate) times one fused_rv_step launch, f32 bench config,
from the mid-trajectory state at mesh 64 and 256, with one keyword
argument of the wrapper changed per variant (ABLATIONS; the kernel source
is the same for all), and reads the device's idle share over a 20-step
solve, with and without torch.profiler.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
F64_TOL = 1e-11          # kernel vs plain, f64
F32_TOL = 1e-4           # kernel vs plain, f32
ACCURACY_GATE = 1e-2     # L2rel vs the committed f64 anchor (bench.py)
ADAPTIVE_TOL = 1e-9      # adaptive f64 solves to 1e-12 in two reduction orders
ADAPTIVE_STEPS = 5

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
    from conservation_fem_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s")


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


def _gated(name, e, dtype_name, errs):
    """Record e under its dtype and raise if it exceeds that dtype's bound."""
    tol = F64_TOL if dtype_name == "f64" else F32_TOL
    errs[dtype_name] = max(errs.get(dtype_name, 0.0), e)
    if not e <= tol:
        raise AssertionError(f"{name} {dtype_name} error {e} > {tol}")


def check_stencil_matvec(summary):
    import torch

    from conservation_fem_tpu_torch.ops import stencil_kernels as sk

    errs, times = {}, None
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
            if n1 == 257 and dn == "f32":
                times = (cuda_ms(lambda: sk.stencil_matvec(coef, x), 200),
                         cuda_ms(lambda: sk.stencil_matvec_plain(coef, x),
                                 200))
    summary["stencil_matvec"] = dict(
        max_abs_err=errs["f64"], err_case="f64, 257x257 and 1025x1025",
        max_abs_err_f32=errs["f32"], f32_case="f32, 257x257 and 1025x1025",
        ms=times[0], plain_ms=times[1], timed_case="257x257 f32")


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
    summary["cg_solve"] = dict(
        max_abs_err=errs["f64"], err_case="mesh-64 mass solve f64 rtol 1e-10",
        max_abs_err_f32=errs["f32"],
        f32_case="mesh-64 mass solve f32 rtol 1e-5",
        ms=times[0], plain_ms=times[1],
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


def check_fused_step(summary):
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs

    errs, states = {}, {}
    for mesh in (16, 64, 256):
        p, u2, uo2, uoo2, g2 = states[mesh] = mid_trajectory_state(mesh)
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
        times[mesh] = (cuda_ms(lambda: fs.fused_rv_step(*f32, **kw), 20),
                       cuda_ms(lambda: fs.fused_rv_step_plain(*f32, **kw), 3))
        log(f"fused_rv_step mesh {mesh} f32 bench config: max|kernel-plain| "
            f"= {e:.3e}; one step {times[mesh][0]:.4f} ms, plain "
            f"{times[mesh][1]:.4f} ms")
    summary["fused_rv_step"] = dict(
        max_abs_err=errs["f64"],
        err_case="f64 one step: mesh 16 and 64 bicgstab/cheby x frozen/"
                 "fresh Jacobian, mesh 256 bench config",
        max_abs_err_f32=errs["f32"],
        f32_case="f32 one step, bench config, mesh 64 and 256",
        ms=times[64][0], plain_ms=times[64][1],
        timed_case="mesh-64 one step f32 bench config")


def _gate(u, mesh_size):
    ref = np.load(os.path.join(REPO, "golden",
                               f"kpp_rv_anchor_mesh{mesh_size}.npy"))
    u = u.double().cpu().numpy()
    if not np.isfinite(u).all() or u.min() < 0.5 or u.max() > 12.0:
        raise AssertionError(
            f"mesh {mesh_size}: solution outside the sanity range [0.5, 12]")
    rel = float(np.linalg.norm(u - ref) / np.linalg.norm(ref))
    if not rel <= ACCURACY_GATE:
        raise AssertionError(f"mesh {mesh_size}: L2rel {rel:.3e} > "
                             f"{ACCURACY_GATE}")
    return rel


def _timed_solve(p):
    """(solution, microseconds per step) of one p.solve() after a warm-up
    solve, CUDA events around the timed one."""
    import torch

    p.solve()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = p.solve()
    end.record()
    end.synchronize()
    return res.u, start.elapsed_time(end) * 1e3 / p.num_steps


def _counted_solve(p):
    """(solution, launch counts) of one p.solve(): the counts are zeroed
    just before it and read just after it."""
    import torch

    from conservation_fem_tpu_torch.ops import _build

    _build.launches.clear()
    u = p.solve().u
    torch.cuda.synchronize()
    return u, dict(_build.launches)


def run_main_path(mesh_size, card):
    """Kernel path of the bench config (gated, launch counts of its own
    run) and its plain-torch composed twin (gated, timed)."""
    import torch

    from conservation_fem_tpu_torch.models import kpp

    p = kpp.build(_bench_cfg(kpp, mesh_size, "float32", use_kernels=True),
                  device="cuda")
    n = int(p.u0.numel())
    u, counts = _counted_solve(p)
    log(f"main path mesh {mesh_size}, f32 bench config, {p.num_steps} "
        f"steps: launches {counts}")
    if counts.get("fused_rv_step", 0) != p.num_steps or any(
            v for k, v in counts.items() if k != "fused_rv_step"):
        raise AssertionError(f"bench path launched {counts} for "
                             f"{p.num_steps} steps")
    rel = _gate(u, mesh_size)
    u_again, us_kernel = _timed_solve(p)
    if not torch.equal(u_again, u):
        raise AssertionError(f"mesh {mesh_size}: repeated solves differ")
    log(f"mesh {mesh_size}: repeated kernel-path solves identical bit for "
        f"bit")
    q = kpp.build(_bench_cfg(kpp, mesh_size, "float32"), device="cuda")
    uq, us_plain = _timed_solve(q)
    rel_plain = _gate(uq, mesh_size)
    for name, us in (("kernel", us_kernel), ("plain-torch", us_plain)):
        log(f"mesh {mesh_size} f32 {name} path: {us:.1f} us/step, "
            f"{n / us * 1e6:.4g} DOF-steps/s ({card})")
    log(f"mesh {mesh_size}: L2rel vs anchor kernel {rel:.4e}, plain "
        f"{rel_plain:.4e}")
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


def _busy_us(events):
    """Microseconds covered by the union of the events' time ranges."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_share(mesh, step_ms):
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
    p.solve()
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
    return dict(profiled_wall_us=wall_us, profiled_device_busy_us=busy,
                profiled_idle=1.0 - busy / wall_us,
                device_kernels=len(kernels), solve_us_per_step=us_step,
                unprofiled_idle=1.0 - step_ms * 1e3 / us_step)


def ablate(card):
    import torch

    from conservation_fem_tpu_torch.ops import fused_step as fs

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = dict(card=card, clocks=clocks)
    for mesh in (64, 256):
        p, *fields = mid_trajectory_state(mesh)
        f32 = [v.float() for v in fields] + [p.sd.M_coef.float()]
        base = p.fused_step_kwargs()
        rows = {}
        for name, change in ABLATIONS:
            kw = dict(base, **change)
            rows[name] = cuda_ms(lambda: fs.fused_rv_step(*f32, **kw), 50)
        rows["n_substeps=10, per step"] = cuda_ms(
            lambda: fs.fused_rv_step(*f32, n_substeps=10, **base), 10) / 10
        torch.cuda.synchronize()
        for name, ms in rows.items():
            log(f"ablate mesh {mesh} {name}: {ms:.5f} ms "
                f"({ms / rows['full']:.1%} of full)")
        idle = idle_share(mesh, rows["full"])
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
    summary = {}
    check_stencil_matvec(summary)
    check_cg_solve(summary)
    check_fused_step(summary)
    bench_counts = run_main_path(64, card)
    adaptive_counts = run_adaptive_path(64)
    run_main_path(256, card)
    # name: (source, TPU kernel, launches of the main-path run, that run)
    sources = {
        "stencil_matvec": ("stencil.cu", "ops/pallas_stencil.py:40", 0,
                           "none: off the main path"),
        "cg_solve": ("stencil.cu", "ops/pallas_stencil.py:64",
                     adaptive_counts.get("cg_solve", 0),
                     f"mesh-64 adaptive f64 config, {ADAPTIVE_STEPS} steps"),
        "fused_rv_step": ("fused_step.cu", "ops/pallas_fused.py:416",
                          bench_counts.get("fused_rv_step", 0),
                          "mesh-64 f32 bench config, 100 steps"),
    }
    rows = []
    for name, (src, tpu, launches, run) in sources.items():
        rows.append(dict(
            name=name, route="cuda",
            source=f"conservation_fem_tpu_torch/csrc/{src}",
            replaces=f"conservation_fem_tpu/{tpu}", launches=launches,
            launches_run=run, **summary[name]))
    on_path = [r for r in rows if r["launches"] > 0]
    off_path = [r for r in rows if r["launches"] == 0]
    log(json.dumps({"off_path_kernels": off_path}))
    log(card)
    log(json.dumps({"kernels": on_path}))


if __name__ == "__main__":
    sys.exit(main(sys.argv))
