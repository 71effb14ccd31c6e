"""CLI: ``python -m conservation_fem_tpu_torch kpp [--key value ...]``.

Runs the KPP workload of the port with KPPConfig overrides, e.g.::

    python -m conservation_fem_tpu_torch kpp --mesh_size 8 --device cpu
    python -m conservation_fem_tpu_torch kpp --mesh_size 64 --dtype float32 \\
        --cg_iters 6 --newton_iters 2 --newton_linear_iters 4 \\
        --modified_newton true --device cuda

Prints a one-line JSON result. Per-step metrics are recorded, as in the
JAX package's CLI, so the run takes the composed step (the fused kernel
records none).
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


def _parse(cfg_cls, args_list):
    """--key value pairs against a dataclass config's fields, plus
    --device."""
    parser = argparse.ArgumentParser(prog="conservation_fem_tpu_torch kpp")
    parser.add_argument("--device", default="cpu")
    for f in dataclasses.fields(cfg_cls):
        parser.add_argument(f"--{f.name}", default=None,
                            type=_CASTERS.get(str(f.type), str))
    ns = vars(parser.parse_args(args_list))
    device = ns.pop("device")
    return cfg_cls(**{k: v for k, v in ns.items() if v is not None}), device


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "kpp":
        print(__doc__)
        return 2
    from conservation_fem_tpu_torch.models import kpp

    t0 = time.perf_counter()
    cfg, device = _parse(kpp.KPPConfig, argv[1:])
    cfg = dataclasses.replace(cfg, record_metrics=True)
    res = kpp.run(cfg, device=device)
    u = res.u.double().cpu()
    out = {"workload": "kpp", "stabilization": cfg.stabilization,
           "mesh_size": cfg.mesh_size, "num_steps": res.num_steps,
           "device": device, "u_min": float(u.min()), "u_max": float(u.max()),
           "newton_all_converged":
               bool(res.metrics["newton_converged"].all()),
           "wall_s": round(time.perf_counter() - t0, 2)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
