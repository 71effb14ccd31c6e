"""Times of the single and block step kernels, of cg_solve and of the ELL
kernels A-D (ell_spmv, ell_assemble, p1_newton_locals, ell_rv_epsilon) at
the shapes that launch them, to compare two trees in turns on one card.

    python3 scripts/torch_kernel_times.py run DIR INPUTS OUT [REPS] [--ell]

``run`` imports conservation_fem_tpu_torch from the tree in DIR (its
kernels build into that tree's own build directory), loads the inputs from
INPUTS or, where that file does not exist yet, makes them there on the
card (mid-trajectory states of the plain f64 paths), times each case with
CUDA events (the median of ROUNDS rounds of REPS launches after a
warm-up, 5 and 20) and saves {case: ms} to OUT. chip_smoke.py --against
DIR runs it for the other tree and this one in turns (other, this, this,
other, twice). The cases, f32 unless
stated: fused_rv_step at KPP mesh 64 (257 x 257, bench config) and Burgers
mesh 200 (201 x 201, fixed config); fused_rv_block_step on the interior
block of KPP mesh 64 x 4 (189 x 257, Chebyshev 10 / 2 x 16) and of Burgers
mesh 64 x 4 (141 x 65, the sharded Chebyshev config) in f32 and f64; and
off the main paths, beyond the single limit, fused_rv_step at KPP mesh 256
(1025 x 1025, bench config) and fused_rv_block_step on the interior block
of KPP mesh 512 x 4 (637 x 2049, Chebyshev 10 / 2 x 16); cg_solve, f64,
on the mass solve of the Burgers reference config (rtol 1e-12) halfway
through its run at mesh 50 (51 x 51, step 25) and 100 (101 x 101, step
50), and of the KPP adaptive config (use_kernels) at its third step at
mesh 64 (257 x 257), rtol 1e-10 and 1e-12, and off the driven paths at
its first step at mesh 256 (1025 x 1025, rtol 1e-10, and the same solve
in f32 at rtol 1e-5), each with its iterations (the plain solve's)
printed. The ELL cases (alone with --ell): the blocked KPP RV f32 bench
config's end state at irr640 (irregular_mesh nx 640, seed 1, RCM order;
N 410,881, K 11, 819,200 cells; made in the first process, the mesh's
tensors saved and each tree's own index copies built from them), A
constrained on the assembled Newton Jacobian, B on its locals (matrix
mode) and on the rhs locals (vector mode), C in Jacobian mode and D with
the residual N(u) as Rh, each on a CUDA graph of GRAPH_REPS calls warm
(one operand set) and L2-cold (rotating over COLD_SETS sets, beyond the
50 MB L2; the median of ROUNDS replays), per wrapper call back to back
(CUDA events), and the host's time a wrapper call (time.perf_counter over
HOST_ROUNDS rounds of HOST_CALLS calls with no synchronisation between
them, the device drained between rounds; the median round) beside two
controls whose code is torch's alone, the same in both trees
(torch.empty_like, entering the device), which show what the process
itself adds; and the same run's first PROFILE_STEPS steps under
torch.profiler after as many unprofiled: the device time a step of each
ELL kernel, of the other kernels, and of their union. Needs a CUDA device.
"""

import copy
import inspect
import os
import sys
import time

import numpy as np

BENCH = dict(cg_iters=6, newton_iters=2, newton_linear_iters=4,
             modified_newton=True, newton_final_residual=False)
BURGERS_FIXED = dict(stabilization="rv", cg_iters=10, newton_iters=2,
                     newton_linear_iters=8, modified_newton=True)
BURGERS_SHARDED = dict(inner_solver="cheby", newton_linear_iters=16)
BURGERS_STEPS = 30   # steps of the plain f64 path before a Burgers state
HALO = 62            # required_halo(10, 2, 16): the sharded path's D
ROUNDS = 5           # timed rounds per case; the median is kept
# cg_solve's right-hand sides: (tag, model, mesh, the step whose mass solve
# is taken); the rtols each is timed at
CG_STATES = (("burgers50", "burgers", 50, 25),
             ("burgers100", "burgers", 100, 50),
             ("kpp64", "kpp", 64, 3), ("kpp256", "kpp", 256, 0))
CG_RTOLS = {"burgers50": (1e-12,), "burgers100": (1e-12,),
            "kpp64": (1e-10, 1e-12), "kpp256": (1e-10,)}
# the solves also timed in f32, cast from the f64 arguments: their rtol
CG_F32 = {"kpp256": 1e-5}
# the ELL cases: the irr640 bench run (chip_smoke.py IRR, IRR_FIXED), calls
# on one CUDA graph, and the operand sets an L2-cold graph rotates over
# (A: ~40 MB a set, B ~65 MB in matrix mode and ~22 MB in vector mode, C
# ~75 MB, D ~14 MB)
ELL_NX, ELL_DT, ELL_T = 640, 0.0009, 0.09
ELL_FIXED = dict(modified_newton=True, cg_iters=10, newton_iters=3,
                 newton_linear_iters=8)
GRAPH_REPS = 100
COLD_SETS = {"ell_spmv": 3, "ell_assemble": 2, "ell_assemble vector": 5,
             "p1_newton_locals": 2, "ell_rv_epsilon": 8}
# the host's time a wrapper call: rounds of calls with no synchronisation,
# and the prefix of the controls' names (torch's code alone)
HOST_CALLS = 100
HOST_ROUNDS = 10
CONTROL = "control, the same code in both trees, host time a call:"
# the steps of the profiled run, and the ELL kernels' names in a profile
PROFILE_STEPS = 3
ELL_KERNELS = ("ell_spmv", "ell_assemble", "p1_newton_locals",
               "ell_rv_epsilon")
# the mesh fields that a tree derives from the others (the kernels' int32,
# int16 and uint8 index copies, ops/mesh.with_kernel_index): each tree
# builds its own, and an L2-cold set clones them
INDEX_COPIES = ("32", "16", "8")
CG_LABELS = {"burgers50": "burgers 51 x 51", "burgers100": "burgers 101 x 101",
             "kpp64": "kpp 257 x 257",
             "kpp256": "kpp 1025 x 1025 (off the driven paths)"}


def _kpp(kpp, dtype, mesh=64, **over):
    dt = 0.01 * min(1.0, 64 / mesh)
    return kpp.build(kpp.KPPConfig(mesh_size=mesh, dtype=dtype, T=4 * dt,
                                   dt=dt, **{**BENCH, **over}),
                     device="cuda")


def _burgers(burgers, mesh, dtype, **over):
    return burgers.build(burgers.BurgersConfig(
        mesh_size=mesh, dtype=dtype, **{**BURGERS_FIXED, **over}),
        device="cuda")


def make_inputs(kpp, burgers, torch):
    """{name: CPU tensor}: KPP mesh 64, 256 and 512 after 4 + 2 plain f64
    steps (kept in f32 beyond mesh 64), Burgers mesh 200 and 64 after
    BURGERS_STEPS steps, each with its Dirichlet data and mass planes."""
    out = {}
    for mesh in (64, 256, 512):
        tag = "kpp" if mesh == 64 else f"kpp{mesh}"
        p = _kpp(kpp, "float64", mesh)
        carry = (p.solve().u,) * 3
        for _ in range(2):
            carry, _ = p.step(carry, p.dt)
        keep = torch.float64 if mesh == 64 else torch.float32
        for name, v in zip(("u", "uo", "uoo"), carry):
            out[f"{tag}/{name}"] = v.reshape(p._shape2).to("cpu", keep)
        out[f"{tag}/g"] = torch.full_like(out[f"{tag}/u"], np.pi / 4)
        out[f"{tag}/Mc"] = p.sd.M_coef.to("cpu", keep)
        del p, carry
    for mesh in (200, 64):
        p = _burgers(burgers, mesh, "float64")
        carry = (p.u0,) * 3
        times = p.step_times()
        for t in times[:BURGERS_STEPS]:
            carry, _ = p.step(carry, t)
        for name, v in zip(("u", "uo", "uoo"), carry):
            out[f"burgers{mesh}/{name}"] = v.reshape(p._shape2).cpu()
        out[f"burgers{mesh}/g"] = p.bc_value(
            p.points, times[BURGERS_STEPS]).reshape(p._shape2).cpu()
        out[f"burgers{mesh}/Mc"] = p.sd.M_coef.cpu()
    return out


def mass_solves(kpp, burgers, sk, torch):
    """{name: CPU tensor}: the arguments of cg_solve at each state of
    CG_STATES, taken where the f64 reference path (use_kernels: its mass
    solve is cg_solve) calls it."""
    out, real = {}, sk.cg_solve
    for tag, model, mesh, step in CG_STATES:
        got = []

        def spy(coef, b, bc, diag, rtol=1e-5, maxiter=200):
            got.append((coef, b, bc, diag))
            return real(coef, b, bc, diag, rtol, maxiter)

        sk.cg_solve = spy
        try:
            if model == "burgers":
                p = burgers.build(burgers.BurgersConfig(
                    mesh_size=mesh, use_kernels=True), device="cuda")
                carry = (p.u0,) * 3
                for t in p.step_times()[:step + 1]:
                    carry, _ = p.step(carry, t)
            else:
                dt = 0.01 * min(1.0, 64 / mesh)
                kpp.build(kpp.KPPConfig(mesh_size=mesh, dtype="float64",
                                        T=(step + 1) * dt, dt=dt,
                                        use_kernels=True),
                          device="cuda").solve()
        finally:
            sk.cg_solve = real
        for name, v in zip(("coef", "b", "bc", "diag"), got[step]):
            out[f"cg/{tag}/{name}"] = v.cpu()
    return out


def _interior_block(fields, torch):
    """(row0, fields of block 1 of 4 with HALO rows of each neighbour)."""
    n1x = fields[0].shape[-2]
    L = -(-n1x // 4)
    pad = (0, 0, HALO, 4 * L - n1x + HALO)
    ext = [torch.nn.functional.pad(a, pad) for a in fields]
    return L - HALO, [a[..., L:2 * L + 2 * HALO, :].contiguous()
                      for a in ext]


def cg_cases(sk, inputs):
    """{case: (zero-argument launch, its plain solve)} of cg_solve."""
    out = {}
    for tag, _, _, step in CG_STATES:
        args = [inputs[f"cg/{tag}/{k}"].to("cuda")
                for k in ("coef", "b", "bc", "diag")]
        runs = [("f64", args, rtol) for rtol in CG_RTOLS[tag]]
        if tag in CG_F32:
            runs.append(("f32", [a.float() if a.is_floating_point() else a
                                 for a in args], CG_F32[tag]))
        for dn, a, rtol in runs:
            out[f"cg_solve {CG_LABELS[tag]} {dn} rtol {rtol:g} (the mass "
                f"solve of step {step})"] = (
                lambda a=a, r=rtol: sk.cg_solve(*a, rtol=r),
                lambda a=a, r=rtol: sk.cg_solve_plain(*a, rtol=r))
    return out


def plain_iterations(sk, plain):
    """Iterations of a plain cg solve: its matvecs - 1."""
    calls, mv = [], sk.stencil_matvec_plain
    sk.stencil_matvec_plain = lambda *a: calls.append(1) or mv(*a)
    try:
        plain()
    finally:
        sk.stencil_matvec_plain = mv
    return len(calls) - 1


def cases(kpp, burgers, fs, torch, inputs):
    """{case: zero-argument launch} of the timed step kernels."""
    def fields(tag, dtype):
        return [inputs[f"{tag}/{k}"].to("cuda", dtype)
                for k in ("u", "uo", "uoo", "g", "Mc")]

    def block(f, kw):
        row0, ext = _interior_block(f, torch)
        n1x, n1y = f[0].shape
        abs_term = (f[0] - f[0].mean()).abs().max().reshape(1)
        bkw = {k: v for k, v in kw.items() if k not in ("nx", "ny")}
        return lambda: fs.fused_rv_block_step(*ext, row0, abs_term,
                                              n_rows=n1x, n_cols=n1y, **bkw)

    f32, f64 = torch.float32, torch.float64
    out = {}
    f, kw = fields("kpp", f32), _kpp(kpp, "float32").fused_step_kwargs()
    out["fused_rv_step kpp mesh 64 f32 (257 x 257, bench config)"] = (
        lambda: fs.fused_rv_step(*f, **kw))
    kwc = _kpp(kpp, "float32", inner_solver="cheby", cg_iters=10,
               newton_linear_iters=16).fused_step_kwargs()
    out["fused_rv_block_step kpp 64 x 4 f32 (189 x 257, interior, "
        "Chebyshev 10 / 2 x 16)"] = block(f, kwc)
    fb = fields("burgers200", f32)
    kwb = _burgers(burgers, 200, "float32").fused_step_kwargs()
    out["fused_rv_step burgers mesh 200 f32 (201 x 201, fixed config)"] = (
        lambda: fs.fused_rv_step(*fb, **kwb))
    for dtype, dn in ((f32, "f32"), (f64, "f64")):
        kws = _burgers(burgers, 64, str(dtype).split(".")[-1],
                       **BURGERS_SHARDED).fused_step_kwargs()
        out[f"fused_rv_block_step burgers 64 x 4 {dn} (141 x 65, interior, "
            "Chebyshev 10 / 2 x 16)"] = block(fields("burgers64", dtype),
                                              kws)
    # off the main paths: beyond the single limit
    f256 = fields("kpp256", f32)
    kw256 = _kpp(kpp, "float32", 256).fused_step_kwargs()
    out["fused_rv_step kpp mesh 256 f32 (1025 x 1025, bench config, "
        "beyond the single limit)"] = lambda: fs.fused_rv_step(*f256,
                                                               **kw256)
    kw512 = _kpp(kpp, "float32", 512, inner_solver="cheby", cg_iters=10,
                 newton_linear_iters=16).fused_step_kwargs()
    out["fused_rv_block_step kpp 512 x 4 f32 (637 x 2049, interior, "
        "Chebyshev 10 / 2 x 16)"] = block(fields("kpp512", f32), kw512)
    return out


def _ell_problem(kpp, host):
    return kpp.build(kpp.KPPConfig(dtype="float32", dt=ELL_DT, T=ELL_T,
                                   backend="ell",
                                   ell_matvec_backend="blocked",
                                   **ELL_FIXED), host_mesh=host)


def ell_inputs(kpp, torch):
    """{name: CPU tensor}: the blocked irr640 f32 bench run's end state u,
    the residual N(u), h, the RV eps, the Newton locals (rhs and Jacobian)
    and the assembled Jacobian at it (this tree's kernels), the fields of
    its mesh arrays but the index copies (each tree builds its own), and
    the host mesh's points and cells."""
    from conservation_fem_tpu_torch.ops import blocked
    from conservation_fem_tpu_torch.ops import ell_kernels as ek
    from conservation_fem_tpu_torch.ops import mesh as tmesh

    host = tmesh.irregular_mesh((-2, -2), (2, 2), nx=ELL_NX, seed=1)
    host = tmesh.reorder_mesh(host, tmesh.rcm_permutation(host))
    p = _ell_problem(kpp, host)
    u = p.solve().u
    m, flux = p.mesh, kpp.FLUX
    rh = blocked.conv_rhs_components(p.plan, u, flux)
    eps = ek.ell_rv_epsilon(m, 0.5, 4.0, u, rh, u, p.h_cg,
                            (u - u.mean()).abs().max(), flux)
    rhs, jac = ek.p1_newton_locals(m, u, eps, 0.5 * p.dt, flux, True)
    out = {f"ell/mesh/{f}": getattr(m, f).cpu()
           for f in tmesh.MeshArrays._fields
           if not f.endswith(INDEX_COPIES) and getattr(m, f) is not None}
    out.update({"ell/u": u.cpu(), "ell/eps": eps.cpu(), "ell/jac": jac.cpu(),
                "ell/rhs": rhs.cpu(), "ell/rh": rh.cpu(),
                "ell/h": p.h_cg.cpu(),
                "ell/J": ek.assemble_matrix(m, jac).cpu(),
                "ell/half_dt": torch.tensor(0.5 * p.dt),
                "ell/host/points": torch.as_tensor(host.points),
                "ell/host/cells": torch.as_tensor(host.cells)})
    return out


def ell_step_profile(kpp, torch, inputs):
    """{name: device ms a step}: the blocked irr640 f32 bench run's first
    PROFILE_STEPS steps under torch.profiler, after as many unprofiled:
    each ELL kernel's summed spans, the other kernels', and the union of
    all (the device's busy time)."""
    from torch.profiler import ProfilerActivity, profile

    from conservation_fem_tpu_torch.ops import mesh as tmesh

    host = tmesh.mesh_from_arrays(inputs["ell/host/points"].numpy(),
                                  inputs["ell/host/cells"].numpy())
    p = copy.copy(_ell_problem(kpp, host))
    p.num_steps = PROFILE_STEPS
    p.solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p.solve()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    us = dict.fromkeys(ELL_KERNELS + ("other kernels",), 0.0)
    busy, end = 0.0, float("-inf")
    for s, e, name in spans:
        key = next((k for k in ELL_KERNELS if f"{k}_kernel" in name),
                   "other kernels")
        us[key] += e - s
        if e > end:
            busy += e - max(s, end)
            end = e
    us["all kernels (busy)"] = busy
    return {f"blocked irr{ELL_NX} f32 step, device ms a step ({k}; "
            f"torch.profiler, first {PROFILE_STEPS} steps)":
            v / PROFILE_STEPS / 1e3 for k, v in us.items()}


def host_ms(fn, torch):
    """Host ms a call of fn: the median of HOST_ROUNDS rounds of
    HOST_CALLS calls with no synchronisation between them, after a
    warm-up; the device drained between rounds."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(HOST_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        out.append((time.perf_counter() - t0) / HOST_CALLS * 1e3)
        torch.cuda.synchronize()
    return sorted(out)[HOST_ROUNDS // 2]


def ell_cases(kpp, torch, inputs):
    """{case: (fn of an operand set, operand sets)} of A-D: set 0 the
    inputs, the others copies of every tensor a call reads (each case
    rotates over the first COLD_SETS of them)."""
    from conservation_fem_tpu_torch.ops import ell_kernels as ek
    from conservation_fem_tpu_torch.ops import mesh as tmesh

    fields = {k.split("/")[-1]: v.to("cuda") for k, v in inputs.items()
              if k.startswith("ell/mesh/")
              and k.split("/")[-1] in tmesh.MeshArrays._fields}
    m = tmesh.with_kernel_index(tmesh.MeshArrays(**fields))
    names = ("u", "eps", "J", "jac", "rhs", "rh", "h")
    t = {k: inputs[f"ell/{k}"].to("cuda") for k in names}
    t["abs_term"] = (t["u"] - t["u"].mean()).abs().max()
    half = float(inputs["ell/half_dt"])
    flux = kpp.FLUX

    def copy():
        idx = {f: getattr(m, f).clone() for f in m._fields
               if f.endswith(INDEX_COPIES) or f in ("area", "grads",
                                                     "boundary_mask")
               if getattr(m, f) is not None}
        return dict(m=m._replace(**idx),
                    **{k: v.clone() for k, v in t.items()})

    sets = [dict(m=m, **t)] + [copy() for _ in
                               range(max(COLD_SETS.values()) - 1)]
    label = (f"irr{ELL_NX} f32 (N {t['J'].shape[0]}, K {t['J'].shape[1]}, "
             f"{m.cells.shape[0]} cells, the blocked bench run's end state)")
    if "constrained" in inspect.signature(ek.ell_spmv).parameters:
        spmv = lambda s: ek.ell_spmv(s["m"], s["J"], s["u"], constrained=True)
    else:  # a tree whose ell_spmv takes the mask itself
        spmv = lambda s: ek.ell_spmv(s["m"], s["J"], s["u"],
                                     s["m"].boundary_mask)
    cases = {
        "ell_spmv": (f"ell_spmv {label}, constrained", spmv),
        "ell_assemble": (f"ell_assemble {label}, matrix mode",
                         lambda s: ek.assemble_matrix(s["m"], s["jac"])),
        "ell_assemble vector": (
            f"ell_assemble {label}, vector mode",
            lambda s: ek.assemble_vector(s["m"], s["rhs"])),
        "p1_newton_locals": (
            f"p1_newton_locals {label}, Jacobian mode",
            lambda s: ek.p1_newton_locals(s["m"], s["u"], s["eps"], half,
                                          flux, True)),
        "ell_rv_epsilon": (
            f"ell_rv_epsilon {label}",
            lambda s: ek.ell_rv_epsilon(s["m"], 0.5, 4.0, s["u"], s["rh"],
                                        s["u"], s["h"], s["abs_term"],
                                        flux)),
    }
    return {name: (fn, sets[:COLD_SETS[key]])
            for key, (name, fn) in cases.items()}


def graph_replays_ms(fn, torch, reps=GRAPH_REPS):
    """ms per call of each of ROUNDS replays of a CUDA graph of reps calls
    of fn (device time, without the host's per-call cost)."""
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
    out = []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def run(repo, inputs_path, out_path, reps=20, ell_only=False):
    sys.path.insert(0, os.path.abspath(repo))
    import itertools

    import torch

    from conservation_fem_tpu_torch.models import burgers, kpp
    from conservation_fem_tpu_torch.ops import fused_step as fs
    from conservation_fem_tpu_torch.ops import stencil_kernels as sk

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times.py needs a CUDA device")
    if os.path.exists(inputs_path):
        inputs = torch.load(inputs_path)
    else:
        inputs = {} if ell_only else make_inputs(kpp, burgers, torch)
        if not ell_only:
            inputs.update(mass_solves(kpp, burgers, sk, torch))
        inputs.update(ell_inputs(kpp, torch))
        torch.save(inputs, inputs_path)
    timed = {} if ell_only else cases(kpp, burgers, fs, torch, inputs)
    if not ell_only:
        for name, (fn, plain) in cg_cases(sk, inputs).items():
            timed[name] = fn
            print(f"{name}: {plain_iterations(sk, plain)} iterations",
                  flush=True)
    graphed, hosted = {}, {}
    for name, (fn, sets) in ell_cases(kpp, torch, inputs).items():
        turn = itertools.cycle(sets)
        graphed[f"{name}, warm on a CUDA graph"] = lambda f=fn, s=sets: f(
            s[0])
        graphed[f"{name}, L2-cold on a CUDA graph ({len(sets)} sets)"] = (
            lambda f=fn, t=turn: f(next(t)))
        timed[f"{name}, per wrapper call"] = lambda f=fn, s=sets: f(s[0])
        hosted[f"{name}, host time a wrapper call"] = (
            lambda f=fn, s=sets: f(s[0]))
    if ell_only:
        u = inputs["ell/u"].to("cuda")
        dev = u.device

        def enter():
            with torch.cuda.device(dev):
                pass

        hosted[f"{CONTROL} torch.empty_like"] = lambda: torch.empty_like(u)
        hosted[f"{CONTROL} entering the device"] = enter
    out = {}
    for name, fn in hosted.items():
        out[name] = host_ms(fn, torch)
        print(f"{name}: {out[name] * 1e3:.3f} us ({repo})", flush=True)
    if ell_only:
        for name, ms in ell_step_profile(kpp, torch, inputs).items():
            out[name] = ms
            print(f"{name}: {ms:.5f} ms ({repo})", flush=True)
    for name, fn in graphed.items():
        times = graph_replays_ms(fn, torch)
        out[name] = sorted(times)[ROUNDS // 2]
        print(f"{name}: {out[name]:.5f} ms, rounds {min(times):.5f} to "
              f"{max(times):.5f} ({repo})", flush=True)
    for name, fn in timed.items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(ROUNDS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(int(reps)):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / int(reps))
        out[name] = sorted(times)[ROUNDS // 2]
        print(f"{name}: {out[name]:.5f} ms, rounds {min(times):.5f} to "
              f"{max(times):.5f} ({repo})", flush=True)
    torch.save(out, out_path)


def main(argv):
    ell_only = "--ell" in argv
    argv = [a for a in argv if a != "--ell"]
    if len(argv) in (5, 6) and argv[1] == "run":
        run(*argv[2:], ell_only=ell_only)
        return 0
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
