"""Whole stabilised time step: the Hopper kernel (csrc/fused_step.cu) and
its plain PyTorch version.

Port of conservation_fem_tpu/ops/pallas_fused.fused_rv_step. One step is
the BDF1/BDF2 residual projection (fixed CG or Chebyshev mass solve), the
RV epsilon, the eps-stiffness planes and a CN Newton solve with a frozen
or fresh Jacobian (fixed BiCGStab or Chebyshev). ``fused_rv_step`` runs
``n_substeps`` such steps and returns the last three states.

The plain version is a transcription of the JAX ``_step_body`` on whole
grids, built from the port's stencil ops and fixed-iteration solvers. The
wrapper runs it for CPU tensors and launches the CUDA kernel for CUDA
tensors. The kernel compiles the flux in: it knows KPP only, and any
other flux raises on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops import structured as st
from conservation_fem_tpu_torch.ops.krylov import (cg_fixed,
                                                   chebyshev_fixed,
                                                   jacobi_preconditioner)
from conservation_fem_tpu_torch.ops.newton import newton_fixed

N_WORK_FIELDS = 31   # csrc/fused_step.cu Field::N_FIELDS


def _frame(n1x, n1y, device):
    bc = torch.zeros((n1x, n1y), dtype=torch.bool, device=device)
    bc[0, :] = bc[-1, :] = True
    bc[:, 0] = bc[:, -1] = True
    return bc


def _step_body_plain(sd, u, uo, uoo, g, *, dt, Cvel, CRV, flux, cg_iters,
                     newton_iters, lin_iters, freeze_jacobian,
                     residual_scheme, stabilization, inner_solver,
                     mass_bounds, lin_bounds):
    """One stabilised step on whole (n1x, n1y) grids (JAX _step_body)."""
    bc, Mc = sd.bc2, sd.M_coef
    cheby = inner_solver == "cheby"

    # 1. residual projection
    if residual_scheme == "bdf1":
        du = (u - uo) / dt
    else:
        du = (3.0 * u - 4.0 * uo + uoo) / (2.0 * dt)
    N_un = st.nonlinear_rhs(sd, u, flux)
    rhs = torch.where(bc, 0.0, st.matvec(sd, Mc, du) + N_un)
    mass_op = lambda v: st.constrained_matvec(sd, Mc, v)
    pre = jacobi_preconditioner(torch.where(bc, 1.0, Mc[0]))
    if cheby:
        RH = chebyshev_fixed(mass_op, rhs, iters=cg_iters, lmin=mass_bounds[0],
                             lmax=mass_bounds[1], precond=pre).x
    else:
        RH = cg_fixed(mass_op, rhs, iters=cg_iters, precond=pre).x

    # 2. RV epsilon
    if stabilization == "rv":
        eps = st.rv_epsilon(sd, Cvel, CRV, u, RH, flux.fprime_norm)
    else:
        eps = torch.zeros_like(u)

    # 3. CN Newton
    Kc = st.keps_coef(sd, eps)
    K_un = st.matvec(sd, Kc, u)

    def residual(v):
        F = (st.matvec(sd, Mc, v - u)
             + 0.5 * dt * (st.nonlinear_rhs(sd, v, flux) + N_un)
             + 0.5 * dt * (st.matvec(sd, Kc, v) + K_un))
        return torch.where(bc, v - g, F)

    def linearize(w):
        J = Mc + 0.5 * dt * (Kc + st.flux_jacobian_coef(sd, w, flux))
        return ((lambda v: st.constrained_matvec(sd, J, v)),
                jacobi_preconditioner(torch.where(bc, 1.0, J[0])))

    return newton_fixed(residual, torch.where(bc, g, u), iters=newton_iters,
                        linear_iters=lin_iters, jacobian_fn=linearize,
                        freeze_jacobian=freeze_jacobian,
                        linear_solver=inner_solver, cheby_bounds=lin_bounds,
                        final_residual=False).u


def fused_rv_step_plain(u2, uo2, uoo2, g2, Mc2, *, nx, ny, dt, area, h,
                        grads, phi, qw, Cvel, CRV, flux, cg_iters,
                        newton_iters, lin_iters, freeze_jacobian,
                        residual_scheme="bdf2", stabilization="rv",
                        n_substeps=1, inner_solver="bicgstab",
                        mass_bounds=(0.5, 2.0), lin_bounds=(0.4, 2.2)):
    """``n_substeps`` stabilised steps in plain PyTorch; returns
    (u_K, u_{K-1}, u_{K-2})."""
    dtype, dev = u2.dtype, u2.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=dev)
    sd = st.StructuredData(
        nx=nx, ny=ny, grads=t(grads), area=t(area),
        bc2=_frame(nx + 1, ny + 1, dev), phi=t(phi), qw=t(qw), M_coef=Mc2,
        h_cg2=torch.full((nx + 1, ny + 1), float(h), dtype=dtype,
                         device=dev),
        diagM2=Mc2[0])
    u, uo, uoo = u2, uo2, uoo2
    for _ in range(n_substeps):
        uh = _step_body_plain(
            sd, u, uo, uoo, g2, dt=dt, Cvel=Cvel, CRV=CRV, flux=flux,
            cg_iters=cg_iters, newton_iters=newton_iters,
            lin_iters=lin_iters, freeze_jacobian=freeze_jacobian,
            residual_scheme=residual_scheme, stabilization=stabilization,
            inner_solver=inner_solver, mass_bounds=mass_bounds,
            lin_bounds=lin_bounds)
        u, uo, uoo = uh, u, uo
    return u, uo, uoo


def _step_constants(dtype, dt, area, h, grads, phi, qw, Cvel, CRV,
                    mass_bounds, lin_bounds):
    """The f64 constant table of csrc/fused_step.cu (enum ConstIdx). Every
    product is formed in f64 and cast once, as the JAX kernel's statics."""
    grads = np.asarray(grads, np.float64)
    phi = np.asarray(phi, np.float64)
    qw = np.asarray(qw, np.float64)
    gg = np.einsum("tad,tbd->tab", grads, grads)

    def cheb(lo, hi):
        theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
        sigma1 = theta / delta
        return [theta, delta, 2.0 * sigma1, 1.0 / sigma1]

    head = ([dt, 2.0 * dt, 0.5 * dt, 2.0 * area, Cvel * h, CRV * h * h,
             st.tiny_of(dtype)] + cheb(*mass_bounds) + cheb(*lin_bounds))
    table = np.concatenate([np.asarray(head, np.float64), grads.ravel(),
                            phi.ravel(), (qw[:, None] * phi).ravel(),
                            (area * gg).ravel()])
    assert table.shape == (81,)
    return table


@functools.lru_cache(maxsize=16)
def _constants_on(device, table_bytes):
    """The constant table as a device tensor, copied to the card once per
    configuration rather than once per launch."""
    return torch.tensor(np.frombuffer(table_bytes, np.float64),
                        device=device)


def _check_kernel_options(flux, residual_scheme, stabilization,
                          inner_solver):
    """Raise for what the CUDA step does not compile in."""
    if flux.name != "kpp":
        raise NotImplementedError(
            f"fused_rv_step: the CUDA step compiles in the KPP flux only, "
            f"not {flux.name!r}")
    if residual_scheme not in ("bdf1", "bdf2"):
        raise ValueError(f"residual_scheme {residual_scheme!r}")
    if stabilization not in ("rv", "gfem"):
        raise ValueError(f"stabilization {stabilization!r}")
    if inner_solver not in ("bicgstab", "cheby"):
        raise ValueError(f"inner_solver {inner_solver!r}")


def fused_rv_step(u2, uo2, uoo2, g2, Mc2, *, nx, ny, dt, area, h, grads,
                  phi, qw, Cvel, CRV, flux, cg_iters, newton_iters,
                  lin_iters, freeze_jacobian, residual_scheme="bdf2",
                  stabilization="rv", n_substeps=1, inner_solver="bicgstab",
                  mass_bounds=(0.5, 2.0), lin_bounds=(0.4, 2.2)):
    """``n_substeps`` stabilised steps; replaces pallas_fused.fused_rv_step.

    u2/uo2/uoo2: (n1x, n1y) history; g2: Dirichlet data (time-independent
    when n_substeps > 1); Mc2: (7, n1x, n1y) mass stencil. On the card the
    whole call is one cooperative kernel launch."""
    if _build.on_cpu("fused_rv_step", u2, uo2, uoo2, g2, Mc2):
        return fused_rv_step_plain(
            u2, uo2, uoo2, g2, Mc2, nx=nx, ny=ny, dt=dt, area=area, h=h,
            grads=grads, phi=phi, qw=qw, Cvel=Cvel, CRV=CRV, flux=flux,
            cg_iters=cg_iters, newton_iters=newton_iters,
            lin_iters=lin_iters, freeze_jacobian=freeze_jacobian,
            residual_scheme=residual_scheme, stabilization=stabilization,
            n_substeps=n_substeps, inner_solver=inner_solver,
            mass_bounds=mass_bounds, lin_bounds=lin_bounds)
    _check_kernel_options(flux, residual_scheme, stabilization,
                          inner_solver)
    n1x, n1y = nx + 1, ny + 1
    dtype = _build.check_cuda_args(
        "fused_rv_step", u2, uo2, uoo2, g2, Mc2,
        shapes=[(n1x, n1y)] * 4 + [(7, n1x, n1y)])
    dev = u2.device
    table = _step_constants(dtype, float(dt), float(area), float(h), grads,
                            phi, qw, float(Cvel), float(CRV), mass_bounds,
                            lin_bounds)
    consts = _constants_on(dev, table.tobytes())
    ring = torch.empty((4, n1x, n1y), dtype=dtype, device=dev)
    work = torch.empty((N_WORK_FIELDS, n1x, n1y), dtype=dtype, device=dev)
    part = torch.empty(_build.PART_SIZE, dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        code = _build.entry("cft_fused_rv_step", dtype)(
            u2.data_ptr(), uo2.data_ptr(), uoo2.data_ptr(), g2.data_ptr(),
            Mc2.data_ptr(), ring.data_ptr(), work.data_ptr(),
            part.data_ptr(), consts.data_ptr(), n1x, n1y, int(n_substeps),
            int(cg_iters), int(newton_iters), int(lin_iters),
            int(residual_scheme == "bdf2"), int(stabilization == "rv"),
            int(bool(freeze_jacobian)), int(inner_solver == "cheby"),
            _build.stream_ptr(u2))
    _build.launches["fused_rv_step"] += 1
    _build.check(code, "fused_rv_step")
    K = int(n_substeps)
    return ring[(K + 2) % 4], ring[(K + 1) % 4], ring[K % 4]
