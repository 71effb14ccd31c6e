"""Times of the single and block step kernels at their main-path shapes, to
compare two trees in turns on one card.

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
of KPP mesh 512 x 4 (637 x 2049, Chebyshev 10 / 2 x 16). Needs a CUDA
device.
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


def _interior_block(fields, torch):
    """(row0, fields of block 1 of 4 with HALO rows of each neighbour)."""
    n1x = fields[0].shape[-2]
    L = -(-n1x // 4)
    pad = (0, 0, HALO, 4 * L - n1x + HALO)
    ext = [torch.nn.functional.pad(a, pad) for a in fields]
    return L - HALO, [a[..., L:2 * L + 2 * HALO, :].contiguous()
                      for a in ext]


def cases(kpp, burgers, fs, torch, inputs):
    """{case: zero-argument launch} of the timed kernels."""
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

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times.py needs a CUDA device")
    if os.path.exists(inputs_path):
        inputs = torch.load(inputs_path)
    else:
        inputs = make_inputs(kpp, burgers, torch)
        torch.save(inputs, inputs_path)
    out = {}
    for name, fn in cases(kpp, burgers, fs, torch, inputs).items():
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
