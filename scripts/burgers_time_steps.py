"""Burgers' time step and step count, the JAX package's against the port's,
on the CPU: dt = CFL min(h_CG), h_CG the CG projection of the cells' sizes
onto P1 (JAX: ops/helpers.get_nodal_h on the ELL mass, as
burgers.build calls it; the port: models/burgers.time_step on the lean
mesh with every cell's size, as burgers.build takes them), and
ceil(T / dt) steps, T = 0.5.

    python3 scripts/burgers_time_steps.py [N ...] [--dtype float32]

Default N: 8 12 16 20 50 100 200 400 800, f64. Prints one line per N:
both dts, their relative difference and both step counts. Needs jax and
the JAX package (conservation_fem_tpu).
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

from conservation_fem_tpu.ops.helpers import get_nodal_h  # noqa: E402
from conservation_fem_tpu.ops.mesh import rectangle_mesh  # noqa: E402
from conservation_fem_tpu_torch.models import burgers  # noqa: E402
from conservation_fem_tpu_torch.ops.mesh import (  # noqa: E402
    rectangle_cell_sizes, rectangle_mesh_lean)


def main(argv):
    dtype = "float64"
    if "--dtype" in argv:
        k = argv.index("--dtype")
        dtype = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    sizes = [int(a) for a in argv] or [8, 12, 16, 20, 50, 100, 200, 400,
                                       800]
    for N in sizes:
        m = rectangle_mesh((0, 0), (1, 1), nx=N).device_arrays(
            jnp.dtype(dtype))
        dt_jax = 0.5 * float(get_nodal_h(m).min())
        dt, steps = burgers.time_step(
            rectangle_mesh_lean((0, 0), (1, 1), nx=N),
            burgers.BurgersConfig(mesh_size=N, dtype=dtype),
            rectangle_cell_sizes((0, 0), (1, 1), nx=N))
        print(f"N {N} {dtype}: dt JAX {dt_jax!r}, port {dt!r} (relative "
              f"{(dt - dt_jax) / dt_jax:.2e}); steps JAX "
              f"{int(np.ceil(0.5 / dt_jax))}, port {steps}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
