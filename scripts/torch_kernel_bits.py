"""Outputs of the port's CUDA kernels on fixed inputs, to hold a change that
must not alter a kernel's arithmetic to the bits of an earlier tree on the
same card.

    python3 scripts/torch_kernel_bits.py run DIR INPUTS OUT
    python3 scripts/torch_kernel_bits.py compare OUT_A OUT_B [--common]

``run`` imports conservation_fem_tpu_torch from the tree in DIR (its
kernels build into that tree's own build directory), loads the inputs
from INPUTS or, where that file does not exist yet, makes them there (f64
mid-trajectory states from the plain path on the CPU, and seeded random
stencils), and saves every kernel output to OUT. ``compare`` prints each
output's largest difference and exits non-zero unless all are equal bit
for bit; with --common it compares the cases both runs have and lists the
others (a tree from before a kernel instance existed has none of its
cases). The cases: the single kernel (fused_rv_step), the tiled kernel
whole grid and in block mode (tiled_rv_step), the block kernel
(fused_rv_block_step) and stencil_matvec, in f32 and f64, at fixed tile
rows so that a change of the default plan does not change the case; and,
where the tree has the Burgers instances of the step kernels, each of
them (the single, split, tiled whole grid, block and tiled block-mode
kernels) from a Burgers state with its shocks formed. Needs a CUDA device.
"""

import os
import sys

import numpy as np

# (mesh, steps of the plain f64 path before the state is taken)
STATES = ((16, 10), (64, 4), (128, 0))
BENCH = dict(cg_iters=6, newton_iters=2, newton_linear_iters=4,
             modified_newton=True, newton_final_residual=False)


def _problem(kpp, mesh, steps, device):
    dt = 0.01 * min(1.0, 64.0 / mesh)
    return kpp.build(kpp.KPPConfig(mesh_size=mesh, dtype="float64",
                                   T=steps * dt, dt=dt, **BENCH),
                     device=device)


# the Burgers state: (mesh, steps of the plain f64 path of the fixed
# config before it); the step kernels' Burgers instances read it
BURGERS_STATE = (16, 8)
BURGERS_FIXED = dict(stabilization="rv", cg_iters=10, newton_iters=2,
                     newton_linear_iters=8, modified_newton=True)


def _burgers_problem(burgers, device, **over):
    mesh = BURGERS_STATE[0]
    return burgers.build(burgers.BurgersConfig(
        mesh_size=mesh, **{**BURGERS_FIXED, **over}), device=device)


def make_burgers_inputs(burgers):
    """{name: CPU tensor} of the Burgers state and its Dirichlet data."""
    p = _burgers_problem(burgers, "cpu")
    carry = (p.u0,) * 3
    times = p.step_times()
    steps = BURGERS_STATE[1]
    for t in times[:steps]:
        carry, _ = p.step(carry, t)
    out = {f"burgers/{name}": v.reshape(p._shape2).clone()
           for name, v in zip(("u", "uo", "uoo"), carry)}
    out["burgers/g"] = p.bc_value(p.points, times[steps]).reshape(
        p._shape2).clone()
    out["burgers/Mc"] = p.sd.M_coef.clone()
    return out


def burgers_cases(burgers, fs, ts, torch, inputs, dtype, dn):
    """{case: output} of the step kernels' Burgers instances."""
    out = {}
    p = _burgers_problem(burgers, "cpu")
    f = [inputs[f"burgers/{k}"].to("cuda", dtype)
         for k in ("u", "uo", "uoo", "g", "Mc")]
    base = p.fused_step_kwargs()
    cheby = dict(base, inner_solver="cheby", lin_iters=16,
                 freeze_jacobian=False)
    for solver, kw in (("bicgstab", base), ("cheby", cheby)):
        tag = f"burgers mesh 16 {dn} {solver}"
        out[f"fused_rv_step {tag}"] = fs.fused_rv_step(*f, **kw)[0]
        out[f"fused_rv_step_split {tag} 8-row tiles"] = (
            fs.fused_rv_step_split(*f, tile_rows=8, **kw))
        out[f"tiled_rv_step {tag} 8-row tiles"] = ts.tiled_rv_step(
            *f, tile_rows=8, **kw)
    kw = {k: v for k, v in dict(cheby, cg_iters=4, lin_iters=4).items()
          if k not in ("nx", "ny")}
    D = fs.required_halo(4, 2, 4)
    n1x, n1y = f[0].shape
    abs_term = (f[0] - f[0].mean()).abs().max().reshape(1)
    for d, (row0, ext) in enumerate(_blocks(f, 3, D, torch)):
        tag = f"burgers mesh 16 {dn} block {d} of 3"
        out[f"fused_rv_block_step {tag}"] = fs.fused_rv_block_step(
            *ext, row0, abs_term, n_rows=n1x, n_cols=n1y, **kw)
        out[f"tiled_rv_step block mode {tag}"] = ts.tiled_rv_step(
            *ext, row0_base=row0, n_rows=n1x, abs_term=abs_term,
            tile_rows=8, **kw)
    return out


def make_inputs(kpp, torch):
    """{name: CPU tensor} of the states and stencils the cases read."""
    out = {}
    for mesh, steps in STATES:
        p = _problem(kpp, mesh, steps, "cpu")
        u = p.solve().u if steps else p.u0
        carry = (u, u, u)
        if steps:
            for _ in range(2):
                carry, _ = p.step(carry, p.dt)
        for name, v in zip(("u", "uo", "uoo"), carry):
            out[f"{mesh}/{name}"] = v.reshape(p._shape2).clone()
        out[f"{mesh}/Mc"] = p.sd.M_coef.clone()
    rng = np.random.default_rng(257)
    out["stencil/coef"] = torch.tensor(rng.normal(size=(7, 257, 257)))
    out["stencil/x"] = torch.tensor(rng.normal(size=(257, 257)))
    return out


def _blocks(fields, n_blocks, D, torch):
    """[(row0, extended fields)] of a split of the rows into n_blocks."""
    n1x = fields[0].shape[0]
    L = -(-n1x // n_blocks)
    pad = (0, 0, D, L * n_blocks - n1x + D)
    ext = [torch.nn.functional.pad(a, pad) for a in fields]
    return [(d * L - D, [a[..., d * L:d * L + L + 2 * D, :].contiguous()
                         for a in ext]) for d in range(n_blocks)]


def run(repo, inputs_path, out_path):
    sys.path.insert(0, os.path.abspath(repo))
    import torch

    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.ops import fused_step as fs
    from conservation_fem_tpu_torch.ops import stencil_kernels as sk
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_bits.py needs a CUDA device")
    try:   # the Burgers instances, where the tree has them
        from conservation_fem_tpu_torch.models import burgers
    except ImportError:
        burgers = None
    inputs = (torch.load(inputs_path) if os.path.exists(inputs_path)
              else make_inputs(kpp, torch))
    if burgers is not None and "burgers/u" not in inputs:
        inputs.update(make_burgers_inputs(burgers))
    torch.save(inputs, inputs_path)
    out = {}
    for dtype, dn in ((torch.float64, "f64"), (torch.float32, "f32")):
        if burgers is not None:
            out.update(burgers_cases(burgers, fs, ts, torch, inputs, dtype,
                                     dn))
        coef, x = (inputs[f"stencil/{k}"].to("cuda", dtype)
                   for k in ("coef", "x"))
        out[f"stencil_matvec {dn}"] = sk.stencil_matvec(coef, x)
        for mesh, _ in STATES:
            p = _problem(kpp, mesh, 0, "cpu")
            f = [inputs[f"{mesh}/{k}"].to("cuda", dtype)
                 for k in ("u", "uo", "uoo")]
            f.append(torch.full_like(f[0], np.pi / 4))
            f.append(inputs[f"{mesh}/Mc"].to("cuda", dtype))
            base = p.fused_step_kwargs()
            cheby = dict(base, inner_solver="cheby", cg_iters=10,
                         lin_iters=16, freeze_jacobian=False)
            for solver, kw in (("bicgstab", base), ("cheby", cheby)):
                tag = f"mesh {mesh} {dn} {solver}"
                if mesh < 128:
                    out[f"fused_rv_step {tag}"] = fs.fused_rv_step(*f,
                                                                   **kw)[0]
                rows = 8 if mesh == 16 else 16
                out[f"tiled_rv_step {tag} {rows}-row tiles"] = (
                    ts.tiled_rv_step(*f, tile_rows=rows, **kw))
            if mesh != 64:
                continue
            # block mode and the block kernel: 4 blocks, Chebyshev
            kw = {k: v for k, v in dict(cheby, cg_iters=4, lin_iters=4,
                                        newton_iters=2).items()
                  if k not in ("nx", "ny")}
            D = fs.required_halo(4, 2, 4)
            n1x, n1y = f[0].shape
            abs_term = (f[0] - f[0].mean()).abs().max().reshape(1)
            for d, (row0, ext) in enumerate(_blocks(f, 4, D, torch)):
                if d == 2:
                    continue
                tag = f"mesh 64 {dn} block {d} of 4"
                out[f"fused_rv_block_step {tag}"] = fs.fused_rv_block_step(
                    *ext, row0, abs_term, n_rows=n1x, n_cols=n1y, **kw)
                out[f"tiled_rv_step block mode {tag}"] = ts.tiled_rv_step(
                    *ext, row0_base=row0, n_rows=n1x, abs_term=abs_term,
                    tile_rows=8, **kw)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, out_path)
    print(f"{len(out)} outputs of the tree in {repo} -> {out_path}")


def compare(a_path, b_path, common=False):
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    if set(a) != set(b):
        only = sorted(set(a) ^ set(b))
        if not common:
            raise SystemExit(f"the two runs have different cases: {only}")
        print(f"{len(only)} cases in one run only, not compared: {only}")
        a = {k: v for k, v in a.items() if k in b}
    same = 0
    for name in sorted(a):
        eq = torch.equal(a[name], b[name])
        same += eq
        diff = float((a[name].double() - b[name].double()).abs().max())
        print(f"{name}: {'equal' if eq else 'DIFFERS'} (max diff {diff:.3e})")
    print(f"{same} of {len(a)} outputs equal bit for bit")
    return 0 if same == len(a) else 1


def main(argv):
    if len(argv) == 5 and argv[1] == "run":
        run(*argv[2:])
        return 0
    if len(argv) in (4, 5) and argv[1] == "compare" and argv[4:] in (
            [], ["--common"]):
        return compare(*argv[2:4], common=argv[4:] == ["--common"])
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
