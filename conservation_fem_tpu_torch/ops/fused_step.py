"""Whole stabilised time step: the Hopper kernels (csrc/fused_step.cu,
csrc/split_step.cu, csrc/block_step.cu) and their plain PyTorch versions.
The split kernels run the tiled kernel's tile pipeline, with its tile plan
from ops/tiled_step.

Port of conservation_fem_tpu/ops/pallas_fused.fused_rv_step,
fused_rv_step_split and fused_rv_block_step. One step is the BDF1/BDF2 residual projection (fixed
CG or Chebyshev mass solve), the RV epsilon, the eps-stiffness planes and
a CN Newton solve with a frozen or fresh Jacobian (fixed BiCGStab or
Chebyshev). ``fused_rv_step`` runs ``n_substeps`` such steps in one
launch and returns the last three states; ``fused_rv_step_split`` runs one
step as a setup launch (``split_setup``) and one launch per Newton
iteration (``split_newton``) and returns the new state;
``fused_rv_block_step`` runs one Chebyshev step on a deep-halo row block
of a taller grid (the sharded path, parallel/structured_fused_sharded.py)
and returns the block.

The plain versions are a transcription of the JAX ``_step_body`` (and of
the split kernels' two stages) on whole grids, built from the port's
stencil ops and fixed-iteration solvers. The wrappers run them for CPU
tensors and launch the CUDA kernels for CUDA tensors. The kernels compile
the flux in, one instance per flux of ``_build.FLUXES`` (KPP, Burgers),
which the wrappers pick by ``flux.name``; any other flux raises on the
card. The plain versions take any ``structured.Flux``.

The step's keyword arguments (``step`` below) are those of
``fused_rv_step`` without ``n_substeps``: nx, ny, dt, area, h, grads,
phi, qw, Cvel, CRV, flux, cg_iters, newton_iters, lin_iters,
freeze_jacobian, and optionally residual_scheme, stabilization,
inner_solver, mass_bounds, lin_bounds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops import structured as st
from conservation_fem_tpu_torch.ops.krylov import (bicgstab_fixed, cg_fixed,
                                                   chebyshev_fixed,
                                                   jacobi_preconditioner)
from conservation_fem_tpu_torch.ops.newton import newton_fixed

N_WORK_FIELDS = 29   # csrc/fused_step.cuh Field::N_FIELDS

_GEOMETRY = ("nx", "ny", "area", "h", "grads", "phi", "qw")
_REQUIRED = _GEOMETRY + ("dt", "Cvel", "CRV", "flux", "cg_iters",
                         "newton_iters", "lin_iters", "freeze_jacobian")
_DEFAULTS = dict(residual_scheme="bdf2", stabilization="rv",
                 inner_solver="bicgstab", mass_bounds=(0.5, 2.0),
                 lin_bounds=(0.4, 2.2))


def step_args(name, step, **defaults):
    """The step's keyword arguments with the defaults filled in (``defaults``
    override the module's); raises TypeError for a missing or unknown one."""
    out = {**_DEFAULTS, **defaults, **step}
    missing = [k for k in _REQUIRED if k not in out]
    unknown = [k for k in out if k not in _REQUIRED and k not in _DEFAULTS]
    if missing or unknown:
        raise TypeError(f"{name}: missing arguments {missing}, unknown "
                        f"arguments {unknown}")
    return out


def _body_kw(s):
    """The step arguments other than the geometry (which goes into sd)."""
    return {k: v for k, v in s.items() if k not in _GEOMETRY}


def _frame(n1x, n1y, device):
    bc = torch.zeros((n1x, n1y), dtype=torch.bool, device=device)
    bc[0, :] = bc[-1, :] = True
    bc[:, 0] = bc[:, -1] = True
    return bc


def _plain_data(u2, Mc2, s, bc2=None):
    """StructuredData of the plain versions from the step's geometry; bc2:
    the Dirichlet mask (None: the frame of the grid)."""
    dtype, dev = u2.dtype, u2.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=dev)
    nx, ny = s["nx"], s["ny"]
    return st.StructuredData(
        nx=nx, ny=ny, grads=t(s["grads"]), area=t(s["area"]),
        bc2=_frame(nx + 1, ny + 1, dev) if bc2 is None else bc2,
        phi=t(s["phi"]), qw=t(s["qw"]),
        M_coef=Mc2,
        h_cg2=torch.full((nx + 1, ny + 1), float(s["h"]), dtype=dtype,
                         device=dev),
        diagM2=Mc2[0])


def _projection_plain(sd, u, uo, uoo, N_un, *, dt, cg_iters,
                      residual_scheme, inner_solver, mass_bounds):
    """RH with M RH = where(bc, 0, M du + N(u)), fixed CG or Chebyshev."""
    bc, Mc = sd.bc2, sd.M_coef
    if residual_scheme == "bdf1":
        du = (u - uo) / dt
    else:
        du = (3.0 * u - 4.0 * uo + uoo) / (2.0 * dt)
    rhs = torch.where(bc, 0.0, st.matvec(sd, Mc, du) + N_un)
    mass_op = lambda v: st.constrained_matvec(sd, Mc, v)
    pre = jacobi_preconditioner(torch.where(bc, 1.0, Mc[0]))
    if inner_solver == "cheby":
        return chebyshev_fixed(mass_op, rhs, iters=cg_iters,
                               lmin=mass_bounds[0], lmax=mass_bounds[1],
                               precond=pre).x
    return cg_fixed(mass_op, rhs, iters=cg_iters, precond=pre).x


def _eps_plain(sd, u, RH, *, Cvel, CRV, flux, stabilization, abs_term=None):
    if stabilization == "rv":
        return st.rv_epsilon(sd, Cvel, CRV, u, RH, flux.fprime_norm,
                             abs_term=abs_term)
    return torch.zeros_like(u)


def _residual_plain(sd, v, u, g, Kc, N_un, K_un, *, dt, flux):
    """CN residual F(v), v - g on the frame."""
    F = (st.matvec(sd, sd.M_coef, v - u)
         + 0.5 * dt * (st.nonlinear_rhs(sd, v, flux) + N_un)
         + 0.5 * dt * (st.matvec(sd, Kc, v) + K_un))
    return torch.where(sd.bc2, v - g, F)


def _linearize_plain(sd, Kc, w, *, dt, flux):
    """(pinned J matvec, Jacobi preconditioner) of J = M + dt/2 (K + C(w))."""
    J = sd.M_coef + 0.5 * dt * (Kc + st.flux_jacobian_coef(sd, w, flux))
    return ((lambda v: st.constrained_matvec(sd, J, v)),
            jacobi_preconditioner(torch.where(sd.bc2, 1.0, J[0])))


def _frozen_terms_plain(sd, u, uo, uoo, *, dt, Cvel, CRV, flux, cg_iters,
                        residual_scheme, stabilization, inner_solver,
                        mass_bounds, abs_term=None, **_newton):
    """(Kc, N(u), K u) of a step: projection, RV epsilon (abs_term: see
    structured.rv_epsilon), eps planes."""
    N_un = st.nonlinear_rhs(sd, u, flux)
    RH = _projection_plain(sd, u, uo, uoo, N_un, dt=dt, cg_iters=cg_iters,
                           residual_scheme=residual_scheme,
                           inner_solver=inner_solver,
                           mass_bounds=mass_bounds)
    eps = _eps_plain(sd, u, RH, Cvel=Cvel, CRV=CRV, flux=flux,
                     stabilization=stabilization, abs_term=abs_term)
    Kc = st.keps_coef(sd, eps)
    return Kc, N_un, st.matvec(sd, Kc, u)


def _step_body_plain(sd, u, uo, uoo, g, **kw):
    """One stabilised step on whole (n1x, n1y) grids (JAX _step_body);
    ``kw``: the step arguments other than the geometry, and optionally
    abs_term."""
    dt, flux = kw["dt"], kw["flux"]
    Kc, N_un, K_un = _frozen_terms_plain(sd, u, uo, uoo, **kw)
    return newton_fixed(
        lambda v: _residual_plain(sd, v, u, g, Kc, N_un, K_un, dt=dt,
                                  flux=flux),
        torch.where(sd.bc2, g, u), iters=kw["newton_iters"],
        linear_iters=kw["lin_iters"],
        jacobian_fn=lambda w: _linearize_plain(sd, Kc, w, dt=dt, flux=flux),
        freeze_jacobian=kw["freeze_jacobian"],
        linear_solver=kw["inner_solver"], cheby_bounds=kw["lin_bounds"],
        final_residual=False).u


def _split_setup_plain(sd, u, uo, uoo, g, **kw):
    """The split setup stage: (Kc (7, n1x, n1y), aux = (N(u), K u)
    (2, n1x, n1y), uk0 = where(bc, g, u), F(uk0))."""
    Kc, N_un, K_un = _frozen_terms_plain(sd, u, uo, uoo, **kw)
    uk = torch.where(sd.bc2, g, u)
    F = _residual_plain(sd, uk, u, g, Kc, N_un, K_un, dt=kw["dt"],
                        flux=kw["flux"])
    return Kc, torch.stack([N_un, K_un]), uk, F


def _split_newton_plain(sd, uk, F, u, g, Kc, aux, w, *, relinearize=True,
                        residual=True, **kw):
    """One split Newton stage: the Jacobian at w, the fixed inner solve of
    J dx = -F, uk + dx and its residual; returns (uk', F(uk')), or (uk',
    None) for residual=False. relinearize=False stands for the Jacobian a
    stage at the same w left behind (the kernel reads it from its scratch):
    it is formed at w here, which gives the same values."""
    dt, flux = kw["dt"], kw["flux"]
    jmv, pre = _linearize_plain(sd, Kc, w, dt=dt, flux=flux)
    if kw["inner_solver"] == "cheby":
        lo, hi = kw["lin_bounds"]
        du = chebyshev_fixed(jmv, -F, iters=kw["lin_iters"], lmin=lo,
                             lmax=hi, precond=pre).x
    else:
        du = bicgstab_fixed(jmv, -F, iters=kw["lin_iters"], precond=pre).x
    uk = uk + du
    if not residual:
        return uk, None
    return uk, _residual_plain(sd, uk, u, g, Kc, aux[0], aux[1], dt=dt,
                               flux=flux)


def fused_rv_step_plain(u2, uo2, uoo2, g2, Mc2, *, n_substeps=1, **step):
    """``n_substeps`` stabilised steps in plain PyTorch; returns
    (u_K, u_{K-1}, u_{K-2})."""
    s = step_args("fused_rv_step", step)
    sd = _plain_data(u2, Mc2, s)
    u, uo, uoo = u2, uo2, uoo2
    for _ in range(n_substeps):
        uh = _step_body_plain(sd, u, uo, uoo, g2, **_body_kw(s))
        u, uo, uoo = uh, u, uo
    return u, uo, uoo


def fused_rv_step_split_plain(u2, uo2, uoo2, g2, Mc2, **step):
    """One stabilised step through the split stages in plain PyTorch;
    returns u_{n+1}. The linearisation point is uk0 for a frozen Jacobian
    and the current iterate otherwise."""
    s = step_args("fused_rv_step_split", step)
    sd, kw = _plain_data(u2, Mc2, s), _body_kw(s)
    Kc, aux, uk, F = _split_setup_plain(sd, u2, uo2, uoo2, g2, **kw)
    w0 = uk
    for _ in range(s["newton_iters"]):
        w = w0 if s["freeze_jacobian"] else uk
        uk, F = _split_newton_plain(sd, uk, F, u2, g2, Kc, aux, w, **kw)
    return uk


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
    """Raise for what the CUDA step kernels do not compile in."""
    if flux.name not in _build.FLUXES:
        raise NotImplementedError(
            f"the CUDA step kernels compile in the fluxes "
            f"{sorted(_build.FLUXES)} (ops/structured.Flux.name), not "
            f"{flux.name!r}")
    if residual_scheme not in ("bdf1", "bdf2"):
        raise ValueError(f"residual_scheme {residual_scheme!r}")
    if stabilization not in ("rv", "gfem"):
        raise ValueError(f"stabilization {stabilization!r}")
    if inner_solver not in ("bicgstab", "cheby"):
        raise ValueError(f"inner_solver {inner_solver!r}")


def _launch_prep(name, s, tensors, shapes):
    """Checks and the device constant table of a step-kernel launch;
    returns (dtype, consts)."""
    _check_kernel_options(s["flux"], s["residual_scheme"],
                          s["stabilization"], s["inner_solver"])
    dtype = _build.check_cuda_args(name, *tensors, shapes=shapes)
    table = _step_constants(dtype, float(s["dt"]), float(s["area"]),
                            float(s["h"]), s["grads"], s["phi"], s["qw"],
                            float(s["Cvel"]), float(s["CRV"]),
                            s["mass_bounds"], s["lin_bounds"])
    return dtype, _constants_on(tensors[0].device, table.tobytes())


def new_scratch(dtype, device, n1x, n1y):
    """(work fields, reduction partials) of a step-kernel launch."""
    return (torch.empty((N_WORK_FIELDS, n1x, n1y), dtype=dtype,
                        device=device),
            torch.empty(_build.PART_SIZE, dtype=dtype, device=device))


def _flags(s):
    """(bdf2, rv, freeze, cheby) as the kernels' int flags."""
    return (int(s["residual_scheme"] == "bdf2"),
            int(s["stabilization"] == "rv"),
            int(bool(s["freeze_jacobian"])),
            int(s["inner_solver"] == "cheby"))


def fused_rv_step(u2, uo2, uoo2, g2, Mc2, *, n_substeps=1, **step):
    """``n_substeps`` stabilised steps; replaces pallas_fused.fused_rv_step.

    u2/uo2/uoo2: (n1x, n1y) history; g2: Dirichlet data (time-independent
    when n_substeps > 1); Mc2: (7, n1x, n1y) mass stencil. On the card the
    whole call is one cooperative kernel launch."""
    if _build.on_cpu("fused_rv_step", u2, uo2, uoo2, g2, Mc2):
        return fused_rv_step_plain(u2, uo2, uoo2, g2, Mc2,
                                   n_substeps=n_substeps, **step)
    s = step_args("fused_rv_step", step)
    n1x, n1y = s["nx"] + 1, s["ny"] + 1
    dtype, consts = _launch_prep("fused_rv_step", s,
                                 [u2, uo2, uoo2, g2, Mc2],
                                 [(n1x, n1y)] * 4 + [(7, n1x, n1y)])
    dev = u2.device
    ring = torch.empty((4, n1x, n1y), dtype=dtype, device=dev)
    work, part = new_scratch(dtype, dev, n1x, n1y)
    bdf2, rv, freeze, cheby = _flags(s)
    with torch.cuda.device(dev):
        code = _build.entry("cft_fused_rv_step", dtype, s["flux"].name)(
            u2.data_ptr(), uo2.data_ptr(), uoo2.data_ptr(), g2.data_ptr(),
            Mc2.data_ptr(), ring.data_ptr(), work.data_ptr(),
            part.data_ptr(), consts.data_ptr(), n1x, n1y, int(n_substeps),
            int(s["cg_iters"]), int(s["newton_iters"]), int(s["lin_iters"]),
            bdf2, rv, freeze, cheby, _build.stream_ptr(u2))
    _build.launches[_build.launch_key("fused_rv_step", s["flux"].name)] += 1
    _build.check(code, "fused_rv_step")
    K = int(n_substeps)
    return ring[(K + 2) % 4], ring[(K + 1) % 4], ring[K % 4]


def _split_plan(u2, s, dtype, tile_rows, kernel):
    """(rows, cols) of the tile plan of a split launch on the card
    (ops/tiled_step.card_plan with ``kernel``'s occupancy)."""
    # imported here: ops/tiled_step imports this module
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    plan = ts.card_plan(s["nx"] + 1, s["ny"] + 1, dtype, tile_rows,
                        ts.device_index(u2), kernel, s["flux"].name)
    return plan["rows"], plan["cols"]


def split_setup(u2, uo2, uoo2, g2, Mc2, *, scratch=None, tile_rows=None,
                **step):
    """The setup launch of the split step (pallas_fused.fused_rv_step_split
    setup_kernel): returns (Kc (7, n1x, n1y), aux = (N(u), K u)
    (2, n1x, n1y), uk0, F(uk0)). scratch: (work, partials) from
    ``new_scratch`` (None: new ones); tile_rows: rows per tile of the
    kernel's tile pipeline (None: ops/tiled_step.default_tile_rows), not
    used on the CPU."""
    s = step_args("split_setup", step)
    if _build.on_cpu("split_setup", u2, uo2, uoo2, g2, Mc2):
        return _split_setup_plain(_plain_data(u2, Mc2, s), u2, uo2, uoo2,
                                  g2, **_body_kw(s))
    n1x, n1y = s["nx"] + 1, s["ny"] + 1
    dtype, consts = _launch_prep("split_setup", s, [u2, uo2, uoo2, g2, Mc2],
                                 [(n1x, n1y)] * 4 + [(7, n1x, n1y)])
    rows, cols = _split_plan(u2, s, dtype, tile_rows, "split_setup")
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=u2.device)
    Kc, aux = new(7, n1x, n1y), new(2, n1x, n1y)
    uk, F = new(n1x, n1y), new(n1x, n1y)
    work, part = scratch or new_scratch(dtype, u2.device, n1x, n1y)
    bdf2, rv, _, cheby = _flags(s)
    with torch.cuda.device(u2.device):
        code = _build.entry("cft_split_setup", dtype, s["flux"].name)(
            u2.data_ptr(), uo2.data_ptr(), uoo2.data_ptr(), g2.data_ptr(),
            Mc2.data_ptr(), Kc.data_ptr(), aux.data_ptr(), uk.data_ptr(),
            F.data_ptr(), work.data_ptr(), part.data_ptr(),
            consts.data_ptr(), n1x, n1y, rows, cols, int(s["cg_iters"]),
            bdf2, rv, cheby, _build.stream_ptr(u2))
    _build.launches[_build.launch_key("split_setup", s["flux"].name)] += 1
    _build.check(code, "split_setup")
    return Kc, aux, uk, F


def split_newton(uk, F, u2, g2, Mc2, Kc, aux, w, *, scratch=None,
                 tile_rows=None, relinearize=True, residual=True, **step):
    """One Newton launch of the split step (pallas_fused.fused_rv_step_split
    newton_kernel): the Jacobian at w, the inner solve, uk + dx; returns
    (uk', F(uk')). scratch, tile_rows: as for split_setup.

    relinearize=False: the Jacobian planes and their preconditioner are
    the ones a launch at the same w left in ``scratch`` (which must be
    given), and the launch re-initialises the inner solver from F alone
    (a frozen Jacobian after the first iteration). residual=False: the
    launch writes uk + dx and no F(uk'), and returns (uk', None) (the last
    iteration). The defaults are the TPU kernel's contract."""
    s = step_args("split_newton", step)
    if not relinearize and scratch is None:
        raise ValueError("split_newton: relinearize=False takes the "
                         "Jacobian a launch at the same w left in its "
                         "scratch; pass that scratch")
    if _build.on_cpu("split_newton", uk, F, u2, g2, Mc2, Kc, aux, w):
        return _split_newton_plain(_plain_data(u2, Mc2, s), uk, F, u2, g2,
                                   Kc, aux, w, relinearize=relinearize,
                                   residual=residual, **_body_kw(s))
    n1x, n1y = s["nx"] + 1, s["ny"] + 1
    fld = (n1x, n1y)
    dtype, consts = _launch_prep(
        "split_newton", s, [uk, F, u2, g2, Mc2, Kc, aux, w],
        [fld] * 4 + [(7, n1x, n1y), (7, n1x, n1y), (2, n1x, n1y), fld])
    rows, cols = _split_plan(u2, s, dtype, tile_rows, "split_newton")
    uk_out = torch.empty(fld, dtype=dtype, device=u2.device)
    F_out = (torch.empty(fld, dtype=dtype, device=u2.device) if residual
             else None)
    work, part = scratch or new_scratch(dtype, u2.device, n1x, n1y)
    *_, cheby = _flags(s)
    with torch.cuda.device(u2.device):
        code = _build.entry("cft_split_newton", dtype, s["flux"].name)(
            uk.data_ptr(), F.data_ptr(), u2.data_ptr(), g2.data_ptr(),
            Mc2.data_ptr(), Kc.data_ptr(), aux.data_ptr(), w.data_ptr(),
            uk_out.data_ptr(), F_out.data_ptr() if residual else 0,
            work.data_ptr(), part.data_ptr(), consts.data_ptr(), n1x, n1y,
            rows, cols, int(s["lin_iters"]), cheby, int(bool(relinearize)),
            int(bool(residual)), _build.stream_ptr(u2))
    _build.launches[_build.launch_key("split_newton", s["flux"].name)] += 1
    _build.check(code, "split_newton")
    return uk_out, F_out


def fused_rv_step_split(u2, uo2, uoo2, g2, Mc2, *, tile_rows=None, **step):
    """One stabilised step in 1 + newton_iters launches; replaces
    pallas_fused.fused_rv_step_split. Returns u_{n+1} (n1x, n1y).

    The launches share one scratch and one tile plan (tile_rows None: the
    default for the Newton kernel, launched newton_iters times). They run
    the single step's passes: with a frozen Jacobian only the first Newton
    launch linearises, and the last one writes uk + dx without a residual.
    """
    s = step_args("fused_rv_step_split", step)
    if _build.on_cpu("fused_rv_step_split", u2, uo2, uoo2, g2, Mc2):
        return fused_rv_step_split_plain(u2, uo2, uoo2, g2, Mc2, **s)
    # before the plan, which asks the flux's instance for its occupancy
    _check_kernel_options(s["flux"], s["residual_scheme"],
                          s["stabilization"], s["inner_solver"])
    if tile_rows is None:
        tile_rows = _split_plan(u2, s, u2.dtype, None, "split_newton")[0]
    scr = new_scratch(u2.dtype, u2.device, s["nx"] + 1, s["ny"] + 1)
    Kc, aux, uk, F = split_setup(u2, uo2, uoo2, g2, Mc2, scratch=scr,
                                 tile_rows=tile_rows, **s)
    w0, frozen, iters = uk, s["freeze_jacobian"], s["newton_iters"]
    for it in range(iters):
        uk, F = split_newton(uk, F, u2, g2, Mc2, Kc, aux,
                             w0 if frozen else uk, scratch=scr,
                             tile_rows=tile_rows,
                             relinearize=not (frozen and it > 0),
                             residual=it + 1 < iters, **s)
    return uk


# ---------------------------------------------------------------------------
# block mode: one step on a deep-halo row block of a taller grid
# ---------------------------------------------------------------------------


def required_halo(cg_iters, newton_iters, lin_iters):
    """Rows of each neighbour a block needs so that one whole step can run
    on it alone (pallas_fused.required_halo): every pass of the step reads
    neighbours one row away, so an error at the block's edge moves in one
    row per pass. Counted: rhs 2 + cg_iters mass-Chebyshev passes + the
    eps / Kc chain 4 + per Newton iteration lin_iters Chebyshev passes and
    the Jacobian and residual 4 + slack 6."""
    return cg_iters + newton_iters * (lin_iters + 4) + 12


def block_rows(B, row0, n_rows):
    """(lo, hi): the rows of a B-row block starting at global row row0 that
    lie inside the (n_rows)-row grid."""
    lo, hi = max(0, -row0), min(B, n_rows - row0)
    if hi - lo < 2:
        raise ValueError(f"block of {B} rows at global row {row0} holds "
                         f"fewer than 2 rows of the {n_rows}-row grid")
    return lo, hi


def block_step_args(name, u2, n_cols, step, **defaults):
    """``step_args`` of a block-mode call: the geometry nx, ny is the
    block's own, (B - 1, n1y - 1), whatever the caller's says."""
    B, n1y = u2.shape
    if n_cols != n1y:
        raise ValueError(f"{name}: n_cols {n_cols} != the block's {n1y} "
                         "columns (the TPU kernel's lane padding has no "
                         "counterpart)")
    return step_args(name, {**step, "nx": B - 1, "ny": n1y - 1}, **defaults)


def block_step_plain(u2, uo2, uoo2, g2, Mc2, row0, abs_term, n_rows, s):
    """The plain version of both block-mode kernels: ``_step_body_plain`` on
    the block cropped to its rows inside the grid, the Dirichlet mask taken
    from global rows (a crop edge that is a block edge is no Dirichlet row:
    the nodes beyond it are missing, as for the kernels), abs_term passed
    in; pasted back into a zero block. s: block_step_args."""
    B, n1y = u2.shape
    row0 = int(row0)
    lo, hi = block_rows(B, row0, n_rows)
    rows = torch.arange(row0 + lo, row0 + hi, device=u2.device)[:, None]
    cols = torch.arange(n1y, device=u2.device)[None, :]
    bc2 = ((rows == 0) | (rows == n_rows - 1) | (cols == 0)
           | (cols == n1y - 1))
    crop = lambda a: a[..., lo:hi, :]
    sd = _plain_data(crop(u2), crop(Mc2), {**s, "nx": hi - lo - 1}, bc2=bc2)
    kw = _body_kw(s)
    if s["stabilization"] == "rv":
        kw["abs_term"] = torch.as_tensor(abs_term, dtype=u2.dtype,
                                         device=u2.device).reshape(())
    out = torch.zeros_like(u2)
    out[lo:hi] = _step_body_plain(sd, crop(u2), crop(uo2), crop(uoo2),
                                  crop(g2), **kw)
    return out


def check_block_options(name, s, abs_term):
    """The refusals of block mode (pallas_fused.fused_rv_block_step,
    pallas_tiled.tiled_rv_step): Chebyshev only — CG and BiCGStab take dot
    products over the whole grid, which a block cannot — and abs_term for
    rv."""
    if s["inner_solver"] != "cheby":
        raise NotImplementedError(
            f"{name}: block mode takes its global reductions outside the "
            "kernel; the CG / BiCGStab dots are single-device only — use "
            "inner_solver='cheby' for the sharded block path")
    if s["stabilization"] == "rv" and abs_term is None:
        raise ValueError(f"{name}: block mode needs the abs_term scalar, "
                         "max|u - mean u| over the whole grid")


def abs_term_ptr(abs_term, s, dtype, device):
    """(tensor kept alive, pointer) of abs_term as one element on the
    device; a null pointer for gfem, which never reads it."""
    if s["stabilization"] != "rv":
        return None, 0
    t = torch.as_tensor(abs_term, dtype=dtype, device=device).reshape(1)
    return t, t.data_ptr()


def fused_rv_block_step_plain(u2, uo2, uoo2, g2, Mc2, row0, abs_term, *,
                              n_rows, n_cols, **step):
    """One Chebyshev step on a deep-halo block in plain PyTorch; returns the
    (B, n1y) block, zero on rows outside the grid."""
    s = block_step_args("fused_rv_block_step", u2, n_cols, step,
                        inner_solver="cheby")
    check_block_options("fused_rv_block_step", s, abs_term)
    return block_step_plain(u2, uo2, uoo2, g2, Mc2, row0, abs_term, n_rows,
                            s)


def fused_rv_block_step(u2, uo2, uoo2, g2, Mc2, row0, abs_term, *, n_rows,
                        n_cols, **step):
    """One stabilised step on a deep-halo row block of an (n_rows, n_cols)
    grid, one launch; replaces pallas_fused.fused_rv_block_step.

    u2/uo2/uoo2/g2: (B, n1y) block, owned rows plus at least
    ``required_halo`` rows of each neighbour; Mc2: (7, B, n1y) mass planes
    of the same rows; row0: global row of block row 0 (an int, negative
    above the grid); abs_term: max|u - mean u| over the whole grid, a
    one-element tensor (read on the device, never by the host) or a float;
    ``step``: as fused_rv_step, with inner_solver="cheby" (the default
    here, and the only one); nx, ny, if given, give way to the block's. Returns the whole block; only
    the owned rows equal the whole-grid step's, rows outside the grid are
    zero."""
    s = block_step_args("fused_rv_block_step", u2, n_cols, step,
                        inner_solver="cheby")
    check_block_options("fused_rv_block_step", s, abs_term)
    if _build.on_cpu("fused_rv_block_step", u2, uo2, uoo2, g2, Mc2):
        return block_step_plain(u2, uo2, uoo2, g2, Mc2, row0, abs_term,
                                n_rows, s)
    B, n1y = u2.shape
    block_rows(B, int(row0), n_rows)
    dtype, consts = _launch_prep("fused_rv_block_step", s,
                                 [u2, uo2, uoo2, g2, Mc2],
                                 [(B, n1y)] * 4 + [(7, B, n1y)])
    dev = u2.device
    out = torch.empty((B, n1y), dtype=dtype, device=dev)
    work = torch.empty((N_WORK_FIELDS, B, n1y), dtype=dtype, device=dev)
    keep, abs_ptr = abs_term_ptr(abs_term, s, dtype, dev)
    bdf2, rv, freeze, _ = _flags(s)
    with torch.cuda.device(dev):
        code = _build.entry("cft_fused_rv_block_step", dtype,
                            s["flux"].name)(
            u2.data_ptr(), uo2.data_ptr(), uoo2.data_ptr(), g2.data_ptr(),
            Mc2.data_ptr(), out.data_ptr(), work.data_ptr(), abs_ptr,
            consts.data_ptr(), B, n1y, int(row0), int(n_rows),
            int(s["cg_iters"]), int(s["newton_iters"]), int(s["lin_iters"]),
            bdf2, rv, freeze, _build.stream_ptr(u2))
    _build.launches[_build.launch_key("fused_rv_block_step",
                                      s["flux"].name)] += 1
    _build.check(code, "fused_rv_block_step")
    return out
