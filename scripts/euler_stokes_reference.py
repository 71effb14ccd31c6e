"""The JAX package's readings that chip_smoke.py's Euler and Stokes phase
gates the port against, on the CPU in f64 (the card's machine has no JAX):

  * Euler: the step count of each cell of scripts/bench_euler.py (sod nx
    100, riemann2d nx 128, 256, 512; the config of
    scripts/make_anchor.py:euler_problem, from the JAX package's build in
    f32 and f64); for sod 100 and riemann2d 128 the f64 run's L2rel
    against its golden/euler_*_anchor_nx*.npy (stored in f32), unrounded
    and rounded to f32, and the JAX package's own noise: the largest L2rel
    between its f64 end state and that of runs from ulp-level changes of
    the initial state (U0 (1 + 4e-16 xi), xi ~ N(0, 1), three seeds);
  * Stokes: the Poiseuille L2 error of the reference config (nx 10, 500
    steps to T = 10, ell backend, adaptive to 1e-11) and how far the same
    solve moves it under changes at the roundoff level: the JAX package's
    run on the lattice backend (the same arithmetic summed in other
    orders), from u0 + 1e-16 xi and with every operator times (1 + 2.2e-16
    xi) (STOKES_SEEDS seeds each). The error, ~6e-8, is a small
    difference of O(1) fields, so roundoff moves it by ~1e-8 relative;
    the largest of these moves is the noise spread.

    python3 scripts/euler_stokes_reference.py

Prints one JSON line (a few minutes on the CPU); paste it into
chip_smoke.py as EULER_STOKES_REFERENCE when a gated JAX run changes.
Needs jax and the JAX package (conservation_fem_tpu).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from conservation_fem_tpu.models import euler, stokes  # noqa: E402

CELLS = (("sod", 100), ("riemann2d", 128), ("riemann2d", 256),
         ("riemann2d", 512))
F64_GATED = (("sod", 100), ("riemann2d", 128))
STOKES_SEEDS = 10


def l2rel(U, anchor):
    return float(np.linalg.norm(U - anchor) / np.linalg.norm(anchor))


def main():
    out = {"euler": {}, "stokes": {}}
    for prob, nx in CELLS:
        steps = {}
        for dtype in ("float32", "float64"):
            p = euler.build(euler.EulerConfig(problem=prob, nx=nx,
                                              dtype=dtype, backend="ell"))
            steps[dtype] = (p.num_steps, p.dt, int(p.U0.shape[0]))
        assert steps["float32"] == steps["float64"], steps
        n_steps, dt, nodes = steps["float64"]
        out["euler"][f"{prob}:{nx}"] = dict(steps=n_steps, dt=dt,
                                            nodes=nodes)
        print(f"{prob}:{nx}: {nodes} nodes, {n_steps} steps, dt {dt!r}",
              flush=True)
    for prob, nx in F64_GATED:
        anchor = np.load(os.path.join(
            REPO, "golden", f"euler_{prob}_anchor_nx{nx}.npy")).astype(
                np.float64)
        p = euler.build(euler.EulerConfig(problem=prob, nx=nx))
        U = np.asarray(euler.solve(p).U)
        spread = 0.0
        for seed in range(3):
            xi = np.random.default_rng(seed).standard_normal(p.U0.shape)
            q = p._replace(U0=p.U0 * (1.0 + 4e-16 * jnp.asarray(xi)))
            spread = max(spread, l2rel(np.asarray(euler.solve(q).U), U))
        row = out["euler"][f"{prob}:{nx}"]
        row.update(f64_l2rel=l2rel(U, anchor),
                   f64_l2rel_f32_rounded=l2rel(
                       U.astype(np.float32).astype(np.float64), anchor),
                   f64_noise_spread=spread)
        print(f"{prob}:{nx} f64: " + json.dumps(row), flush=True)
    p, fd = stokes.build(stokes.StokesConfig())
    r = stokes.solve((p, fd))
    others = {"lattice": stokes.solve(stokes.build(stokes.StokesConfig(
        backend="lattice"))).error_l2}
    for seed in range(STOKES_SEEDS):
        rng = np.random.default_rng(seed)
        xi = lambda a: jnp.asarray(rng.standard_normal(a.shape))
        others[f"u0 seed {seed}"] = stokes.solve((p._replace(
            u0=p.u0 + 1e-16 * xi(p.u0)), fd)).error_l2
        pert = lambda a: a * (1.0 + 2.2e-16 * xi(a))
        others[f"operators seed {seed}"] = stokes.solve((p._replace(
            M2=pert(p.M2), visc=pert(p.visc), edge=pert(p.edge),
            K1=pert(p.K1)), fd)).error_l2
    rel = {k: abs(e - r.error_l2) / r.error_l2 for k, e in others.items()}
    out["stokes"].update(reference_error_l2=r.error_l2,
                         noise_spread=max(rel.values()), spreads=rel)
    print(f"stokes reference config: L2 error {r.error_l2!r}; relative "
          f"spreads {json.dumps(rel)}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
