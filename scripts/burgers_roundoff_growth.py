"""How far two evaluation orders of the same Burgers trajectory drift apart,
on the CPU in f64: the JAX package's scan solve, the JAX package's own
step jitted alone and chained from u0, and the port's plain path, all with
the JAX package's dt (the port's differs in its last bits), at one mesh of
the f64 reference config (adaptive solvers, exact Newton, T 0.5).

    python3 scripts/burgers_roundoff_growth.py [MESH]     # default 100

Prints the largest difference of the port's chain from the JAX chain
every 10 steps, each end state's distance from the scan solve, and each
one's L1 and L2 errors against the exact solution at t = 0.5. The spread
of the JAX package's own two orders bounds how closely any port can hold
these errors to the JAX package's (chip_smoke.py BURGERS_ERR_RTOL).
Needs jax and the JAX package (conservation_fem_tpu).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from conservation_fem_tpu.models import burgers as jb  # noqa: E402
from conservation_fem_tpu_torch.models import burgers as tb  # noqa: E402


def main(mesh):
    pj = jb.build(jb.BurgersConfig(mesh_size=mesh))
    u_scan = pj.solve().u
    pt = tb.build(tb.BurgersConfig(mesh_size=mesh), device="cpu")
    print(f"mesh {mesh}: {pj.num_steps} steps; dt JAX {pj.dt!r}, port "
          f"{pt.dt!r} (the port runs with JAX's here)")
    pt.dt = pj.dt
    step = jax.jit(pj.step)
    cj, ct = (pj.u0,) * 3, (pt.u0,) * 3
    for k in range(pj.num_steps):
        t = (k + 1.0) * pj.dt
        cj, _ = step(cj, jnp.asarray(t))
        ct, _ = pt.step(ct, t)
        if k % 10 == 0 or k + 1 == pj.num_steps:
            d = np.abs(ct[0].numpy() - np.asarray(cj[0])).max()
            print(f"step {k + 1}: max|port - JAX step chain| = {d:.3e}")
    ends = {"JAX scan solve": u_scan, "JAX step chain": cj[0],
            "port": jnp.asarray(ct[0].numpy())}
    for name, u in ends.items():
        print(f"{name}: max|u - JAX scan solve| = "
              f"{float(jnp.abs(u - u_scan).max()):.3e}; L1 "
              f"{float(jb.l1_error_vs_exact(pj, u, 0.5))!r}, L2 "
              f"{float(jb.l2_error_vs_exact(pj, u, 0.5))!r}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 100)
