"""Tutorial: the port's API end to end, section for section the JAX
package's examples/tutorial.py: meshing, assembly, a boundary-value
solve, a stabilized time-dependent solve with metrics, checkpoint/resume,
error measurement, plotting and I/O, and the same solve over row blocks.
Runs on the card unless told otherwise:

    python -m conservation_fem_tpu_torch.examples.tutorial [--device cuda|cpu] [--blocks N]

Each section is a function that returns its numbers and tensors; main()
calls them in order and prints one line each. Section 5 draws with
matplotlib and writes XDMF with h5py, which it imports where it uses them.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.models import kpp
from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.ops.bc import constrained_operator, lift_rhs
from conservation_fem_tpu_torch.ops.krylov import cg
from conservation_fem_tpu_torch.ops.mesh import disk_mesh
from conservation_fem_tpu_torch.parallel.comm import LocalBlocks
from conservation_fem_tpu_torch.parallel.structured_sharded import \
    shard_structured
from conservation_fem_tpu_torch.utils import plotting
from conservation_fem_tpu_torch.utils.io import XDMFWriter, read_h5_series


def meshes(device=None, hmax=1 / 16):
    """1. Meshes are arrays: the deterministic unit disk on the host, and
    its tensors on ``device`` (None: the card) for the kernels."""
    mesh = disk_mesh(hmax=hmax)
    return mesh, mesh.device_arrays(torch.float64, device)


def poisson(m):
    """2. Assembly and a Poisson solve on the mesh tensors ``m``: -lap u = 0
    with u = x^2 - y^2 on the boundary (harmonic, so the exact solution).
    Returns the CG result and the L2 error against the exact solution
    (O(h^2))."""
    K = assembly.assemble_stiffness(m)              # ELL sparse (N, K_patch)
    g = m.points[:, 0] ** 2 - m.points[:, 1] ** 2   # harmonic boundary data
    b = lift_rhs(m, K, torch.zeros_like(g), g, m.boundary_mask)
    sol = cg(constrained_operator(m, K, m.boundary_mask), b, rtol=1e-12)
    err = assembly.l2_error_vs_function(m, sol.x, lambda x, y: x * x - y * y)
    return sol, err


def stabilized_run(device=None, mesh_size=8, T=1.0):
    """3. A stabilized conservation-law run: KPP with residual viscosity
    on the structured mesh (the stencil backend), recording the per-step
    metrics (so the composed step runs, as in the JAX package). Returns
    (cfg, problem, result)."""
    cfg = kpp.KPPConfig(mesh_size=mesh_size, T=T, record_metrics=True)
    problem = kpp.build(cfg, device=device)
    return cfg, problem, problem.solve()


def checkpoint_resume(cfg, device=None, directory=None):
    """4. Checkpoint every 25 steps to ``kpp.npz`` in ``directory`` (None:
    a new temporary one), then resume from that file: the second solve
    starts at the stored last step. Returns both results; raises unless
    they are equal bit for bit."""
    ck = os.path.join(directory or tempfile.mkdtemp(), "kpp.npz")
    r1 = kpp.build(cfg, device=device).solve(checkpoint_path=ck,
                                             checkpoint_every=25)
    r2 = kpp.build(cfg, device=device).solve(checkpoint_path=ck,
                                             checkpoint_every=25,
                                             resume=True)
    if not torch.equal(r1.u, r2.u):
        raise AssertionError("checkpoint/resume is not bit-exact")
    return r1, r2


def plots_and_io(problem, result, out=None):
    """5. A snapshot of section 3's field (matplotlib) and an XDMF series of
    it written and read back (h5py), in ``out`` (None: a new temporary
    directory). Returns (times, values, out)."""
    out = out or tempfile.mkdtemp()
    plotting.plot_field(problem.host_mesh, result.u, "KPP RV", "kpp", out)
    with XDMFWriter(os.path.join(out, "kpp.xdmf"), problem.host_mesh) as w:
        w.write_function(result.u, result.num_steps * result.dt)
    times, vals = read_h5_series(os.path.join(out, "kpp.h5"), "uh")
    return times, vals, out


def sharded_solve(cfg, u_single, device=None, n_blocks=4):
    """6. Section 3's run over ``n_blocks`` row blocks of one device
    (LocalBlocks, the counterpart of the JAX package's device mesh; over
    the ranks of a process group: parallel/comm.ProcessGroupBlocks).
    Returns the flat global solution and its largest distance from
    ``u_single``."""
    u_sh = shard_structured(kpp.build(cfg, device=device),
                            LocalBlocks(n_blocks, device)).solve()
    return u_sh, float((u_sh - u_single).abs().max())


def main(device="cuda", n_blocks=4, hmax=1 / 16, mesh_size=8, T=1.0):
    device = get_device(device)
    mesh, m = meshes(device, hmax)
    print(f"mesh: {mesh.n_nodes} nodes, {mesh.n_cells} cells, "
          f"{int(mesh.boundary_mask.sum())} boundary nodes")

    sol, err = poisson(m)
    print(f"Poisson: CG iters={int(sol.iters)}, L2 error vs exact "
          f"{float(err):.2e} (O(h^2) discretization)")

    cfg, problem, result = stabilized_run(device, mesh_size, T)
    mets = result.metrics
    print(f"KPP RV: {result.num_steps} steps, Newton converged every step: "
          f"{bool(mets['newton_converged'].all())}, "
          f"u in [{float(result.u.min()):.2f}, {float(result.u.max()):.2f}]")

    checkpoint_resume(cfg, device)
    print("checkpoint/resume: bit-exact")

    times, _, out = plots_and_io(problem, result)
    print(f"wrote + re-read XDMF series: {len(times)} snapshot(s) -> {out}")

    _, diff = sharded_solve(cfg, result.u, device, n_blocks)
    print(f"sharded solve on {n_blocks} block(s): max |diff| vs single = "
          f"{diff:.2e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        description="The port's API end to end (the JAX package's "
                    "examples/tutorial.py).")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--blocks", type=int, default=4,
                    help="row blocks of the sharded solve (section 6)")
    args = ap.parse_args()
    main(args.device, args.blocks)
