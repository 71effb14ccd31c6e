"""Times of the single and block step kernels and of cg_solve at the shapes
that launch them, to compare two trees in turns on one card.

    python3 scripts/torch_kernel_times.py run DIR INPUTS OUT [REPS]

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
printed. Needs a CUDA device.
"""

import os
import sys

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


def run(repo, inputs_path, out_path, reps=20):
    sys.path.insert(0, os.path.abspath(repo))
    import torch

    from conservation_fem_tpu_torch.models import burgers, kpp
    from conservation_fem_tpu_torch.ops import fused_step as fs
    from conservation_fem_tpu_torch.ops import stencil_kernels as sk

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times.py needs a CUDA device")
    if os.path.exists(inputs_path):
        inputs = torch.load(inputs_path)
    else:
        inputs = make_inputs(kpp, burgers, torch)
        inputs.update(mass_solves(kpp, burgers, sk, torch))
        torch.save(inputs, inputs_path)
    timed = cases(kpp, burgers, fs, torch, inputs)
    for name, (fn, plain) in cg_cases(sk, inputs).items():
        timed[name] = fn
        print(f"{name}: {plain_iterations(sk, plain)} iterations",
              flush=True)
    out = {}
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
    if len(argv) in (5, 6) and argv[1] == "run":
        run(*argv[2:])
        return 0
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
