"""The JAX package's errors of the runs that chip_smoke.py's advection and
Pk phase gates against, f64 on the CPU.

    python3 scripts/advection_reference_errors.py

Prints one Python literal, ``ADVECTION_REFERENCE = {...}``, every float
to all its digits:
  * "sweep": linear advection (models/linear_advection.py), the f64
    reference config (AdvectionConfig defaults: disk, T = 1, CFL 0.5,
    adaptive solvers to 1e-12), gfem and rv_node at mesh 4, 8, 16, 32:
    steps, L2 errors against the IC's interpolant and the least-squares
    slope (utils/convergence.run_convergence);
  * "mesh16": rv_cell (last-cell-wins), rv_node_simple, si and rk4 at
    mesh 16, the same config;
  * "ho": advection_ho's P2 gfem at mesh 8 and 16, straight and with the
    curved boundary, the degree sweep 1, 2, 3 of gfem at mesh 8, and P3
    rv_simple at mesh 4 (T = 1, CFL 0.5); for P3 rv_simple also
    "noise_spread", the largest relative change of its error when u0 is
    perturbed by 4e-16 N(0, 1) noise (numpy seeds 0-7): that run is
    chaotic, so its error holds to the JAX package's only within this;
  * "burgers_p2si": P2 SI Burgers at mesh 32, T = 0.25, the f64 default
    config: dofs, steps, dt, the L1 and L2 errors against the exact
    solution at t = steps * dt, and the L2rel against
    golden/burgers_p2si_anchor_mesh32.npy; beside them the same run with
    the dofs renumbered by spaces.rcm_dof_permutation ("rcm_*": the same
    arithmetic summed in another order, the JAX package's own spread,
    which bounds how closely another code can hold these errors).
Needs jax and the JAX package (conservation_fem_tpu); takes minutes.
"""

import dataclasses
import os
import pprint
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from conservation_fem_tpu.models import advection_ho as ho  # noqa: E402
from conservation_fem_tpu.models import burgers  # noqa: E402
from conservation_fem_tpu.models import linear_advection as la  # noqa: E402
from conservation_fem_tpu.models.pk_hyperbolic import \
    PkHyperbolicProblem  # noqa: E402
from conservation_fem_tpu.ops import spaces  # noqa: E402
from conservation_fem_tpu.utils.convergence import \
    run_convergence  # noqa: E402

SWEEP = (4, 8, 16, 32)


def renumbered(p, perm):
    """p's Pk Burgers problem on its space with the dofs renumbered by
    perm (old -> new); its solution back in p's numbering."""
    class Renumbered(PkHyperbolicProblem):
        def _make_space(self, host_mesh, degree):
            return spaces.permute_dofs(spaces.build_space(host_mesh, degree),
                                       perm)

    q = Renumbered(p.cfg, p.host_mesh, p.degree,
                   flux_prime=burgers.flux_prime,
                   flux_prime_norm=burgers.flux_prime_norm,
                   bc_value=lambda pts, t: burgers.exact_solution(
                       pts[:, 0], pts[:, 1], t),
                   u0_fn=burgers.initial_condition, dt=p.dt,
                   num_steps=p.num_steps)
    return np.asarray(q.solve().u)[perm]


def main():
    out = {"sweep": {}, "mesh16": {}, "ho": {}}
    for stab in ("gfem", "rv_node"):
        steps = {}

        def err(n):
            r = la.run(mesh_size=n, stabilization=stab)
            steps[n] = r.num_steps
            return float(r.error_l2)

        c = run_convergence(err, SWEEP)
        out["sweep"][stab] = dict(steps=[steps[n] for n in SWEEP],
                                  errors=[float(e) for e in c.errors],
                                  slope=c.slope)
        print(stab, out["sweep"][stab], flush=True, file=sys.stderr)
    for stab in ("rv_cell", "rv_node_simple", "si", "rk4"):
        r = la.run(mesh_size=16, stabilization=stab)
        out["mesh16"][stab] = dict(steps=r.num_steps,
                                   error=float(r.error_l2))
        print(stab, out["mesh16"][stab], flush=True, file=sys.stderr)
    ho_runs = {"p2_gfem_mesh8": dict(mesh_size=8, degree=2),
               "p2_gfem_mesh16": dict(mesh_size=16, degree=2),
               "p2_gfem_mesh8_curved": dict(mesh_size=8, degree=2,
                                            curved_boundary=True),
               "p2_gfem_mesh16_curved": dict(mesh_size=16, degree=2,
                                             curved_boundary=True),
               "p1_gfem_mesh8": dict(mesh_size=8, degree=1),
               "p3_gfem_mesh8": dict(mesh_size=8, degree=3),
               "p3_rv_simple_mesh4": dict(mesh_size=4, degree=3,
                                          stabilization="rv_simple")}
    for name, kw in ho_runs.items():
        p, _, e = ho.run(**kw)
        out["ho"][name] = dict(steps=p.num_steps, dofs=int(p.u0.shape[0]),
                               error=float(e))
        print(name, out["ho"][name], flush=True, file=sys.stderr)
    p, _, e = ho.run(**ho_runs["p3_rv_simple_mesh4"])
    spread = []
    for seed in range(8):
        noise = 4e-16 * np.random.default_rng(seed).standard_normal(
            p.u0.shape)
        q = dataclasses.replace(p, u0=p.u0 + noise)
        spread.append(abs(float(ho._run("rv_simple", q)[1]) - e) / e)
    out["ho"]["p3_rv_simple_mesh4"]["noise_spread"] = max(spread)
    p = burgers.build(burgers.BurgersConfig(mesh_size=32, degree=2,
                                            stabilization="si", T=0.25))
    r = p.solve()
    t = r.num_steps * r.dt
    u = np.asarray(r.u)
    ref = np.load(os.path.join(REPO, "golden",
                               "burgers_p2si_anchor_mesh32.npy"))
    out["burgers_p2si"] = dict(
        dofs=int(u.shape[0]), steps=r.num_steps, dt=r.dt,
        l1=float(burgers.l1_error_vs_exact(p, r.u, t)),
        l2=float(burgers.l2_error_vs_exact(p, r.u, t)),
        anchor_l2rel=float(np.linalg.norm(u - ref) / np.linalg.norm(ref)))
    v = renumbered(p, spaces.rcm_dof_permutation(p.space))
    out["burgers_p2si"].update(
        rcm_max_abs=float(np.abs(v - u).max()),
        rcm_l1=float(burgers.l1_error_vs_exact(p, v, t)),
        rcm_l2=float(burgers.l2_error_vs_exact(p, v, t)))
    print("ADVECTION_REFERENCE = " + pprint.pformat(out, width=76))


if __name__ == "__main__":
    main()
