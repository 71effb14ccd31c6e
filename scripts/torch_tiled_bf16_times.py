"""The tiled kernel's bf16-plane instance against its f32-plane instance on
the card, by configuration, shape, part of the step and tile rows.

    python3 scripts/torch_tiled_bf16_times.py

Builds the kernels, takes chip_smoke.py's mid-trajectory f32 state at mesh
256 and times, in turns (bf16, f32, f32, bf16; CUDA events, 10 launches
each), ops/tiled_step.tiled_rv_step with and without bf16_planes (the bf16
mass planes made once, as the main paths make them): the bench config
(BiCGStab) and the sharded path's Chebyshev 10/2x16 on the whole grid, the
Chebyshev config on the interior block of 4 (381 x 1025), each in full and
without the mass solve (cg_iters=0), the inner solves (lin_iters=0) or
Newton (newton_iters=0), at the default tile rows and at 8, 16 and 32. Prints
one line a case and a JSON line of all of them. Needs a CUDA device.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

VARIANTS = (("full", {}), ("cg_iters=0", dict(cg_iters=0)),
            ("lin_iters=0", dict(lin_iters=0)),
            ("newton_iters=0", dict(newton_iters=0)))
TILE_ROWS = (None, 8, 16, 32)


def main():
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    card = cs.phase_device()
    cs.phase_build()
    p, *f64 = cs.mid_trajectory_state(256)
    f32 = [v.float() for v in f64] + [p.sd.M_coef.float()]
    u2 = f32[0]
    n1x = u2.shape[0]
    abs_term = (u2 - u2.mean()).abs().max().reshape(1)
    blocks, _ = cs._deep_halo_blocks(f32[:4], f32[4], 4, 62)
    row0, ext = blocks[1]
    bench = p.fused_step_kwargs()
    cheby = dict(bench, inner_solver="cheby", cg_iters=10, lin_iters=16,
                 newton_iters=2)
    out = {}
    for cname, shape, kw in (("bench", "whole", bench),
                             ("cheby", "whole", cheby),
                             ("cheby", "block", cheby)):
        for vname, over in VARIANTS:
            for rows in TILE_ROWS:
                k = dict(kw, **over)
                if shape == "whole":
                    fields, extra = f32, {}
                else:
                    fields = ext
                    k = {a: b for a, b in k.items() if a not in ("nx", "ny")}
                    extra = dict(row0_base=row0, n_rows=n1x,
                                 abs_term=abs_term)
                mc16 = ts.bf16_planes_of(fields[4])
                t = cs._alternated({
                    "bf16": lambda: ts.tiled_rv_step(
                        *fields, tile_rows=rows, bf16_planes=True, mc16=mc16,
                        **extra, **k),
                    "f32": lambda: ts.tiled_rv_step(
                        *fields, tile_rows=rows, **extra, **k)}, 10)
                key = f"{cname} {shape} {vname} rows={rows}"
                out[key] = dict(t, ratio=t["bf16"] / t["f32"])
                cs.log(f"{key}: bf16 {t['bf16']:.5f} ms, f32 {t['f32']:.5f}"
                       f" ms, ratio {t['bf16'] / t['f32']:.4f}")
    cs.log(card)
    cs.log(json.dumps(out))


if __name__ == "__main__":
    main()
