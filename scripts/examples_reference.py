"""The JAX package's numbers that chip_smoke.py's examples phase (phase
15) holds the port's example scripts to, f64 on the CPU, at the sizes of
the JAX package's examples/tutorial.py and examples/make_figures.py.

    python3 scripts/examples_reference.py

Prints one Python literal, ``EXAMPLES_REFERENCE = {...}``, every float to
all its digits:
  * "mesh", "poisson": the tutorial's sections 1 and 2 (disk_mesh(1/16):
    nodes, cells, boundary nodes; the Poisson solve's CG iterations and L2
    error against x^2 - y^2);
  * "kpp8": the tutorial's section 3 (KPP mesh 8 with metrics): steps,
    whether Newton converged every step, min and max of u;
  * "kpp16": make_figures' KPP mesh 16: steps, min and max of u; the u
    itself goes to scripts/examples_reference_kpp16.npy;
  * "burgers60": make_figures' Burgers mesh 60 (the f64 reference
    config): steps, L1 and L2 errors against the exact solution at
    t = 0.5;
  * "sod200": make_figures' Sod tube at nx 200: steps, dt and the L1
    density error against the exact Riemann solution at t_end;
  * "gif": make_figures' 8 node-RV advection steps at mesh 8 (T = 0.2)
    from (u0, u0): dt, min and max of the last frame.
The advection runs of make_figures (rv_node at mesh 16, gfem at 4, 8, 16)
are chip_smoke.py's ADVECTION_REFERENCE sweep
(scripts/advection_reference_errors.py). Needs jax and the JAX package
(conservation_fem_tpu); about a minute.
"""

import os
import pprint
import sys

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from conservation_fem_tpu.models import burgers, euler, kpp  # noqa: E402
from conservation_fem_tpu.models import \
    linear_advection as la  # noqa: E402
from conservation_fem_tpu.ops import assembly  # noqa: E402
from conservation_fem_tpu.ops.bc import (constrained_operator,  # noqa: E402
                                         lift_rhs)
from conservation_fem_tpu.ops.krylov import cg  # noqa: E402
from conservation_fem_tpu.ops.mesh import disk_mesh  # noqa: E402

KPP16_NPY = os.path.join(REPO, "scripts", "examples_reference_kpp16.npy")


def main():
    ref = {}
    mesh = disk_mesh(hmax=1 / 16)
    ref["mesh"] = dict(nodes=mesh.n_nodes, cells=mesh.n_cells,
                       boundary=int(mesh.boundary_mask.sum()))
    m = mesh.device_arrays(jnp.float64)
    K = assembly.assemble_stiffness(m)
    g = m.points[:, 0] ** 2 - m.points[:, 1] ** 2
    b = lift_rhs(m, K, jnp.zeros(mesh.n_nodes), g, m.boundary_mask)
    sol = cg(constrained_operator(m, K, m.boundary_mask), b, rtol=1e-12)
    err = assembly.l2_error_vs_function(m, sol.x, lambda x, y: x * x - y * y)
    ref["poisson"] = dict(iters=int(sol.iters), l2=float(err))

    r = kpp.build(kpp.KPPConfig(mesh_size=8, record_metrics=True)).solve()
    ref["kpp8"] = dict(steps=int(r.num_steps),
                       converged=bool(r.metrics["newton_converged"].all()),
                       min=float(r.u.min()), max=float(r.u.max()))

    r = kpp.build(kpp.KPPConfig(mesh_size=16)).solve()
    u16 = np.asarray(r.u)
    np.save(KPP16_NPY, u16)
    ref["kpp16"] = dict(steps=int(r.num_steps), min=float(u16.min()),
                        max=float(u16.max()))

    p = burgers.build(burgers.BurgersConfig(mesh_size=60))
    r = p.solve()
    ref["burgers60"] = dict(
        steps=int(p.num_steps),
        l1=float(burgers.l1_error_vs_exact(p, r.u, 0.5)),
        l2=float(burgers.l2_error_vs_exact(p, r.u, 0.5)))

    p = euler.build(problem="sod", nx=200)
    r = euler.solve(p)
    ref["sod200"] = dict(
        steps=int(r.num_steps), dt=float(r.dt),
        l1_density=euler.sod_density_error(p, r.U, r.num_steps * r.dt))

    p = la.build(la.AdvectionConfig(mesh_size=8, stabilization="rv_node",
                                    T=0.2))
    carry = (p.u0, p.u0)
    for _ in range(8):
        carry, _ = la._step_rv_node(p, carry, None)
    ref["gif"] = dict(frames=8, dt=float(p.dt), min=float(carry[0].min()),
                      max=float(carry[0].max()))
    print("EXAMPLES_REFERENCE = " + pprint.pformat(ref, width=72))
    print(f"wrote {os.path.relpath(KPP16_NPY, REPO)} ({u16.size} values)")


if __name__ == "__main__":
    main()
