"""CLI: ``python -m conservation_fem_tpu_torch WORKLOAD [--key value ...]``.

WORKLOAD is kpp, burgers, advection, advection_ho, convergence, euler or
stokes. Runs a workload of the port with overrides of its config
(KPPConfig, BurgersConfig, AdvectionConfig, HOAdvectionConfig,
EulerConfig, StokesConfig), e.g.::

    python -m conservation_fem_tpu_torch kpp --mesh_size 8 --device cpu
    python -m conservation_fem_tpu_torch kpp --mesh_size 64 --dtype float32 \\
        --cg_iters 6 --newton_iters 2 --newton_linear_iters 4 \\
        --modified_newton true --device cuda
    python -m conservation_fem_tpu_torch burgers --mesh_size 8 --device cpu
    python -m conservation_fem_tpu_torch burgers --mesh_size 200 \\
        --dtype float32 --cg_iters 10 --newton_iters 2 \\
        --modified_newton true --use_kernels true
    python -m conservation_fem_tpu_torch kpp --stabilization si --Cm 0.5 \\
        --mesh_size 8 --device cpu
    python -m conservation_fem_tpu_torch kpp --backend ell --mesh_size 8 \\
        --device cpu
    python -m conservation_fem_tpu_torch kpp --mesh_source golden/kpp_rv8.h5 \\
        --T 0.05 --device cpu
    python -m conservation_fem_tpu_torch kpp --backend ell \\
        --ell_matvec_backend blocked --mesh_size 8 --T 0.05 --device cpu
    python -m conservation_fem_tpu_torch kpp --backend ell \\
        --ell_matvec_backend blocked2d --mesh_size 32 --T 0.02 --device cpu
    python -m conservation_fem_tpu_torch burgers --degree 2 \\
        --ell_matvec_backend blocked --mesh_size 8 --T 0.1 --device cpu
    python -m conservation_fem_tpu_torch burgers --stabilization si \\
        --smooth_l 4 --backend ell --mesh_size 12 --device cpu
    python -m conservation_fem_tpu_torch burgers --degree 2 \\
        --stabilization si --mesh_size 8 --T 0.1 --device cpu
    python -m conservation_fem_tpu_torch advection --mesh_size 8 --device cpu
    python -m conservation_fem_tpu_torch advection --stabilization rv_node \\
        --mesh_size 8 --device cpu
    python -m conservation_fem_tpu_torch advection_ho --degree 2 \\
        --mesh_size 4 --device cpu
    python -m conservation_fem_tpu_torch convergence \\
        --stabilization rv_node --device cpu
    python -m conservation_fem_tpu_torch euler --problem sod --nx 16 \\
        --device cpu
    python -m conservation_fem_tpu_torch stokes --nx 4 --num_steps 10 \\
        --device cpu

Runs on the card unless ``--device cpu`` is given. ``--backend ell``
runs the ELL step on the structured mesh; ``--ell_matvec_backend``
(gather, lattice, banded, blocked, blocked2d; advection: gather, banded,
blocked; advection_ho: gather, blocked) picks how it applies and
assembles its operators (banded and blocked RCM-order a mesh built here,
blocked2d tiles it; the hand-written ELL kernels on the card);
``--mesh_source`` reads a
DOLFINx .h5 mesh (KPP, the ELL backend, needs h5py). Other meshes
(ops/mesh.irregular_mesh, disk_mesh) go to ``kpp.build`` or
``burgers.build`` as ``host_mesh=``. Prints a one-line JSON result. As in
the JAX package's CLI, kpp records per-step metrics, so its run takes the
composed step (the fused kernel records none); burgers reports the L2
error against the exact solution (at t = 0.5 for T = 0.5); advection and
advection_ho the L2 error against the IC's interpolant after T;
convergence the errors of linear advection at mesh 4, 8, 16 and 32 (T =
1, the config's defaults but --stabilization), their least-squares slope
in log-log and the pairwise rates; euler the step count (and for sod the
L1 density error against the exact Riemann solution); stokes the L2
error against the Poiseuille profile.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

_CASTERS = {"int": int, "float": float, "str": str,
            "bool": lambda s: s in ("1", "true", "True"),
            "float | None": float, "int | None": int,
            "bool | None": lambda s: s in ("1", "true", "True")}


def _parse(cfg_cls, workload, args_list):
    """--key value pairs against a dataclass config's fields, plus
    --device (default: the card)."""
    parser = argparse.ArgumentParser(
        prog=f"conservation_fem_tpu_torch {workload}")
    parser.add_argument("--device", default="cuda")
    for f in dataclasses.fields(cfg_cls):
        parser.add_argument(f"--{f.name}", default=None,
                            type=_CASTERS.get(str(f.type), str))
    ns = vars(parser.parse_args(args_list))
    device = ns.pop("device")
    return cfg_cls(**{k: v for k, v in ns.items() if v is not None}), device


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("kpp", "burgers", "advection",
                                   "advection_ho", "convergence", "euler",
                                   "stokes"):
        print(__doc__)
        return 2
    t0 = time.perf_counter()
    if argv[0] == "kpp":
        from conservation_fem_tpu_torch.models import kpp

        cfg, device = _parse(kpp.KPPConfig, "kpp", argv[1:])
        cfg = dataclasses.replace(cfg, record_metrics=True)
        res = kpp.run(cfg, device=device)
        u = res.u.double().cpu()
        ell = cfg.backend == "ell" or cfg.mesh_source != "structured"
        out = {"workload": "kpp", "stabilization": cfg.stabilization,
               "backend": "ell" if ell else "stencil",
               "ell_matvec_backend": cfg.ell_matvec_backend,
               "n_nodes": int(u.numel()),
               "mesh_size": cfg.mesh_size, "num_steps": res.num_steps,
               "device": device, "u_min": float(u.min()),
               "u_max": float(u.max()),
               "newton_all_converged":
                   bool(res.metrics["newton_converged"].all())}
    elif argv[0] == "burgers":
        from conservation_fem_tpu_torch.models import burgers

        cfg, device = _parse(burgers.BurgersConfig, "burgers", argv[1:])
        res, err = burgers.run(cfg, device=device)
        ell = cfg.backend == "ell" or cfg.degree > 1
        out = {"workload": "burgers", "stabilization": cfg.stabilization,
               "backend": "ell" if ell else "stencil",
               "mesh_size": cfg.mesh_size, "num_steps": res.num_steps,
               "L2_error_vs_exact": err, "device": device}
    elif argv[0] == "advection":
        from conservation_fem_tpu_torch.models import linear_advection as la

        cfg, device = _parse(la.AdvectionConfig, "advection", argv[1:])
        res = la.run(cfg, device=device)
        out = {"workload": "advection", "stabilization": cfg.stabilization,
               "mesh_size": cfg.mesh_size, "num_steps": res.num_steps,
               "L2_error_vs_ic": float(res.error_l2), "device": device}
    elif argv[0] == "advection_ho":
        from conservation_fem_tpu_torch.models import advection_ho as ho

        cfg, device = _parse(ho.HOAdvectionConfig, "advection_ho", argv[1:])
        _, _, err = ho.run(cfg, device=device)
        out = {"workload": "advection_ho", "degree": cfg.degree,
               "stabilization": cfg.stabilization, "L2_error_vs_ic": err,
               "device": device}
    elif argv[0] == "euler":
        from conservation_fem_tpu_torch.models import euler

        cfg, device = _parse(euler.EulerConfig, "euler", argv[1:])
        p = euler.build(cfg, device=device)
        res = euler.solve(p)
        out = {"workload": "euler", "problem": cfg.problem, "nx": cfg.nx,
               "num_steps": res.num_steps, "device": device}
        if cfg.problem == "sod":
            out["L1_rho_error"] = euler.sod_density_error(
                p, res.U, res.num_steps * res.dt)
    elif argv[0] == "stokes":
        from conservation_fem_tpu_torch.models import stokes

        cfg, device = _parse(stokes.StokesConfig, "stokes", argv[1:])
        res = stokes.solve(stokes.build(cfg, device=device))
        out = {"workload": "stokes", "num_steps": res.num_steps,
               "L2_error_vs_poiseuille": res.error_l2, "device": device}
    else:
        from conservation_fem_tpu_torch.models import linear_advection as la
        from conservation_fem_tpu_torch.utils.convergence import \
            run_convergence

        parser = argparse.ArgumentParser(
            prog="conservation_fem_tpu_torch convergence")
        parser.add_argument("--device", default="cuda")
        parser.add_argument("--stabilization", default="gfem")
        ns = parser.parse_args(argv[1:])
        res = run_convergence(
            lambda n: la.run(mesh_size=n, stabilization=ns.stabilization,
                             device=ns.device).error_l2, (4, 8, 16, 32))
        out = {"workload": "convergence", "stabilization": ns.stabilization,
               "errors": [float(e) for e in res.errors],
               "slope": res.slope, "rates": res.rates().tolist(),
               "device": ns.device}
    out["wall_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
