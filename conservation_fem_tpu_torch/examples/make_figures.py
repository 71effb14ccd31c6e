"""The demo figure gallery, section for section the JAX package's
examples/make_figures.py (parity with the reference's per-method
Figures/ directories, ref Code/*/Figures/*): field snapshots, a
convergence plot, the Sod density profile against the exact Riemann
solution, and an evolution GIF. Computes on the card unless told
otherwise:

    python -m conservation_fem_tpu_torch.examples.make_figures [outdir] [--device cuda|cpu]

Each section's computation is a function that returns its numbers and
tensors; main() calls them in order and draws what they return
(matplotlib, and PIL for the GIF, imported where they are used).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from conservation_fem_tpu_torch import get_device
from conservation_fem_tpu_torch.models import burgers, euler, kpp
from conservation_fem_tpu_torch.models import linear_advection as la
from conservation_fem_tpu_torch.utils import plotting
from conservation_fem_tpu_torch.utils.convergence import run_convergence
from conservation_fem_tpu_torch.utils.riemann_exact import sod_exact


def advection(device=None, mesh_size=16):
    """1. Linear advection with node RV after one rotation (t = 1).
    Returns (problem, result)."""
    p = la.build(la.AdvectionConfig(mesh_size=mesh_size,
                                    stabilization="rv_node"), device=device)
    return p, la.solve(p)


def convergence(device=None, mesh_sizes=(4, 8, 16)):
    """2. GFEM advection's L2 errors at h = 1 / mesh_sizes and their
    least-squares slope (utils/convergence.ConvergenceResult)."""
    return run_convergence(
        lambda n: la.run(mesh_size=n, stabilization="gfem",
                         device=device).error_l2, mesh_sizes)


def kpp_wave(device=None, mesh_size=16):
    """3. The KPP rotating wave to t = 1. Returns (problem, result)."""
    p = kpp.build(kpp.KPPConfig(mesh_size=mesh_size), device=device)
    return p, p.solve()


def burgers_riemann(device=None, mesh_size=60):
    """4. Burgers' Riemann problem to t = 0.5 and the exact solution at the
    nodes. Returns (problem, result, exact)."""
    p = burgers.build(burgers.BurgersConfig(mesh_size=mesh_size),
                      device=device)
    r = p.solve()
    pts = torch.as_tensor(p.host_mesh.points, dtype=r.u.dtype,
                          device=r.u.device)
    return p, r, burgers.exact_solution(pts[:, 0], pts[:, 1], 0.5)


def sod(device=None, nx=200):
    """5. The Sod shock tube to its end time t_end and the exact density
    there. Returns (problem, result, x, t_end, rho_exact): x the nodes'
    abscissae on the host, rho_exact at np.sort(x)."""
    p = euler.build(problem="sod", nx=nx, device=device)
    r = euler.solve(p)
    x = p.mesh.points[:, 0].cpu().numpy()
    t_end = r.num_steps * r.dt
    rho_ex, _, _ = sod_exact(np.sort(x), t_end)
    return p, r, x, t_end, rho_ex


def evolution(device=None, mesh_size=8, frames=8):
    """6. The first ``frames`` steps of node-RV advection (T = 0.2) from
    (u0, u0), each step's u kept. Returns (problem, [u after step 1, ...])."""
    p = la.build(la.AdvectionConfig(mesh_size=mesh_size,
                                    stabilization="rv_node", T=0.2),
                 device=device)
    u_n = u_old = p.u0
    us = []
    for _ in range(frames):
        u_n, u_old = la._step_rv_node(p, u_n, u_old), u_n
        us.append(u_n)
    return p, us


def main(outdir="figures", device="cuda", adv_mesh=16,
         conv_meshes=(4, 8, 16), kpp_mesh=16, burgers_mesh=60, sod_nx=200,
         gif_mesh=8, gif_frames=8):
    device = get_device(device)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # 1. linear advection: solution after one rotation (RV)
    p, res = advection(device, adv_mesh)
    plotting.plot_field(p.host_mesh, res.u, "Advection RV, t=1",
                        "adv_rv_sol", outdir)
    plotting.plot_field(p.host_mesh, res.u, "Advection RV (3D)",
                        "adv_rv_3d", outdir, three_d=True)
    print("advection figures done")

    # 2. convergence plot with slope annotation (ref
    # PDE_plot.plot_convergence)
    conv = convergence(device, conv_meshes)
    plotting.plot_convergence(conv.errors, list(conv_meshes),
                              "GFEM advection", "adv_gfem_conv", outdir)
    print(f"convergence figure done (slope {conv.slope:.2f})")

    # 3. KPP rotating wave
    pk_, rk = kpp_wave(device, kpp_mesh)
    plotting.plot_field(pk_.host_mesh, rk.u, "KPP RV, t=1", "kpp_rv_sol",
                        outdir)
    print("kpp figure done")

    # 4. Burgers Riemann solution vs exact
    pb, rb, ex = burgers_riemann(device, burgers_mesh)
    plotting.plot_field(pb.host_mesh, rb.u, "Burgers RV, t=0.5",
                        "burgers_rv_sol", outdir)
    plotting.plot_field(pb.host_mesh, ex, "Burgers exact, t=0.5",
                        "burgers_exact", outdir)
    print("burgers figures done")

    # 5. Sod shock tube profile vs exact Riemann solution
    pe, re, x, t_end, rho_ex = sod(device, sod_nx)
    order = np.argsort(x)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(x[order], re.U[:, 0].cpu().numpy()[order], ".", ms=2,
            label="FEM+RV")
    ax.plot(np.sort(x), rho_ex, "k-", lw=1, label="exact")
    ax.set_xlabel("x"); ax.set_ylabel("rho"); ax.legend()
    ax.set_title(f"Sod shock tube, t={t_end:.3f}")
    fig.savefig(f"{outdir}/sod_profile.png", dpi=130, bbox_inches="tight")
    plt.close(fig)
    print("sod figure done")

    # 6. short evolution GIF (ref PDE_realtime_plot)
    p, us = evolution(device, gif_mesh, gif_frames)
    rp = plotting.RealtimePlot(p.host_mesh, outdir, "advection.gif", fps=5)
    for k, u in enumerate(us):
        rp.add_frame(u, t=(k + 1) * p.dt)
    rp.close()
    print("gif done")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        description="The demo figure gallery (the JAX package's "
                    "examples/make_figures.py).")
    ap.add_argument("outdir", nargs="?", default="figures")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(args.outdir, args.device)
