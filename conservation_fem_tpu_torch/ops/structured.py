"""Structured-grid (stencil) backend, ported from
conservation_fem_tpu/ops/structured.py.

On the structured rectangle triangulation every node neighbour sits at a
fixed (di, dj) grid offset, so every sparse operator is a 7-plane stencil
and every gather/scatter a statically shifted slice. Fields are handled
as 2D (nx+1, ny+1) tensors; node id = i * (ny+1) + j.

Triangles per quad (i,j):
  L: (c00, c10, c11)   U: (c00, c11, c01)
Neighbour offsets (self + 6): (0,0),(1,0),(-1,0),(0,1),(0,-1),(1,1),(-1,-1).

Where the JAX package differentiates the flux with ``jax.jvp``, the port
takes explicit derivative callables (``Flux.fprime2_xy``).
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from conservation_fem_tpu_torch.ops.assembly import _DUN4_W, _quad_basis
from conservation_fem_tpu_torch.ops.mesh import Mesh

OFFSETS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1))
_PLANE = {o: k for k, o in enumerate(OFFSETS)}
CORNERS = (((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1)))  # L, U


class Flux(NamedTuple):
    """Pointwise flux derivatives of a scalar law u_t + div f(u) = 0.

    ``name`` selects the flux compiled into the CUDA step kernels: "kpp"
    or "burgers" (``ops/_build.FLUXES``; csrc/fused_step.cuh Kpp,
    Burgers). The plain versions run any flux; the kernels raise on the
    card for another name."""
    name: str
    fprime_xy: tuple          # (f'_x, f'_y): u -> tensor
    fprime2_xy: tuple         # (f''_x, f''_y)
    fprime_norm: Callable     # u -> |f'(u)|


class StructuredData(NamedTuple):
    nx: int
    ny: int
    grads: torch.Tensor      # (2,3,2) per-type P1 gradients
    area: torch.Tensor       # () cell area
    bc2: torch.Tensor        # (nx+1, ny+1) bool boundary mask
    phi: torch.Tensor        # (Q,3) quad basis
    qw: torch.Tensor         # (Q,)
    M_coef: torch.Tensor     # (7, nx+1, ny+1) mass stencil
    h_cg2: torch.Tensor      # (nx+1, ny+1) nodal h
    diagM2: torch.Tensor     # (nx+1, ny+1) mass diagonal


def tiny_of(dtype) -> float:
    """Breakdown guard of the fixed solvers and the RV n_i floor."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def build_structured(host_mesh: Mesh, nx: int, ny: int, dtype, device):
    """Precompute stencil data for a rectangle_mesh(nx, ny)."""
    n1x, n1y = nx + 1, ny + 1
    if host_mesh.n_nodes != n1x * n1y or host_mesh.n_cells != 2 * nx * ny:
        raise ValueError("host_mesh is not an (nx, ny) rectangle mesh")
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    # exemplar geometry: cell 0 is the first lower triangle, cell nx*ny the
    # first upper one
    grads = t(np.stack([host_mesh.grads[0], host_mesh.grads[nx * ny]]))
    area = t(host_mesh.area[0])
    bc2 = torch.as_tensor(host_mesh.boundary_mask.reshape(n1x, n1y),
                          device=device)
    sd = StructuredData(nx=nx, ny=ny, grads=grads, area=area, bc2=bc2,
                        phi=t(_quad_basis()), qw=t(_DUN4_W * 0.5),
                        M_coef=None, h_cg2=None, diagM2=None)
    eye = torch.eye(3, dtype=dtype, device=device)
    mloc = area * (torch.ones_like(eye) + eye) / 12.0
    M_coef = local_to_stencil(sd, mloc.expand(2, nx, ny, 3, 3))
    # uniform mesh: the nodal h projection of a constant is exact
    h = torch.full((n1x, n1y), float(host_mesh.h_cell[0]), dtype=dtype,
                   device=device)
    return sd._replace(M_coef=M_coef, diagM2=M_coef[0], h_cg2=h)


def structured_data_from_numpy(d: Mapping, device, dtype):
    """StructuredData from the JAX package's StructuredData fields given as
    numpy arrays (``{name: np.asarray(field)}``) — carries a JAX-built
    operator set into the port unchanged."""
    t = lambda k: torch.as_tensor(np.array(d[k]), dtype=dtype,
                                  device=device)
    return StructuredData(
        nx=int(d["nx"]), ny=int(d["ny"]), grads=t("grads"), area=t("area"),
        bc2=torch.as_tensor(np.array(d["bc2"], bool), device=device),
        phi=t("phi"), qw=t("qw"), M_coef=t("M_coef"), h_cg2=t("h_cg2"),
        diagM2=t("diagM2"))


# ---------------------------------------------------------------------------
# core primitives
# ---------------------------------------------------------------------------


def _shifted(xp, di, dj, n1x, n1y):
    return xp[..., 1 + di:1 + di + n1x, 1 + dj:1 + dj + n1y]


def matvec(sd: StructuredData, coef, x2):
    """y = A x for a 7-plane stencil operator (zero-padded boundary); x2
    (..., nx+1, ny+1): leading dimensions are fields that share the
    operator (Euler's four components), each formed as its own product
    would be."""
    n1x, n1y = x2.shape[-2:]
    xp = F.pad(x2, (1, 1, 1, 1))
    out = coef[0] * x2
    for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
        out = out + coef[k] * _shifted(xp, di, dj, n1x, n1y)
    return out


def cell_gather(sd: StructuredData, x2):
    """x at triangle corners: (2, nx, ny, 3) via static slices."""
    nx, ny = sd.nx, sd.ny
    return torch.stack([
        torch.stack([x2[di:di + nx, dj:dj + ny] for (di, dj) in CORNERS[t]],
                    dim=-1)
        for t in range(2)])


def node_scatter(sd: StructuredData, vals):
    """(2, nx, ny, 3) per-corner cell values -> (nx+1, ny+1) nodal sums."""
    nx, ny = sd.nx, sd.ny
    out = torch.zeros((nx + 1, ny + 1), dtype=vals.dtype, device=vals.device)
    for t in range(2):
        for a, (di, dj) in enumerate(CORNERS[t]):
            out[di:di + nx, dj:dj + ny] += vals[t, :, :, a]
    return out


def local_to_stencil(sd: StructuredData, loc):
    """(2, nx, ny, 3, 3) local matrices -> (7, nx+1, ny+1) stencil planes."""
    nx, ny = sd.nx, sd.ny
    coef = torch.zeros((len(OFFSETS), nx + 1, ny + 1), dtype=loc.dtype,
                       device=loc.device)
    for t in range(2):
        cs = CORNERS[t]
        for a in range(3):
            dai, daj = cs[a]
            for b in range(3):
                p = _PLANE[(cs[b][0] - dai, cs[b][1] - daj)]
                coef[p, dai:dai + nx, daj:daj + ny] += loc[t, :, :, a, b]
    return coef


def sweep_form(coef, enable: bool):
    """The operator planes a fixed-iteration solver sweep reads: a bfloat16
    copy of f32 ``coef`` when ``enable``, else ``coef`` itself (f64 and
    ``enable`` False leave it alone).

    ``matvec`` on a bf16 copy promotes each plane to f32 before its product
    (a bf16 tensor times an f32 tensor is f32 in PyTorch), so the sums stay
    f32 and only the planes carry bf16 rounding (~4e-3 relative). The
    residuals, quadratures and Jacobi diagonals keep the exact planes, so
    the rounding perturbs the solve directions, not the Newton fixed
    point. The composed step's ``xla_bf16_planes``; the tiled kernel's
    ``bf16_planes`` streams such copies from device memory (ops/
    tiled_step.py)."""
    if enable and coef.dtype == torch.float32:
        return coef.to(torch.bfloat16)
    return coef


def constrained_matvec(sd: StructuredData, coef, x2):
    """Dirichlet-constrained stencil matvec (rows/cols zeroed, unit diag)."""
    y = matvec(sd, coef, torch.where(sd.bc2, 0.0, x2))
    return torch.where(sd.bc2, x2, y)


# ---------------------------------------------------------------------------
# FEM operators
# ---------------------------------------------------------------------------


def quad_values(sd: StructuredData, x2):
    """Field at quadrature points: (2, nx, ny, Q)."""
    return torch.einsum("qa,txya->txyq", sd.phi, cell_gather(sd, x2))


def cell_grad(sd: StructuredData, x2):
    """Constant per-cell gradient: (2, nx, ny, 2)."""
    return torch.einsum("txya,tad->txyd", cell_gather(sd, x2), sd.grads)


def _corners_and_grad(sd, x2, t):
    nx, ny = sd.nx, sd.ny
    c = [x2[di:di + nx, dj:dj + ny] for (di, dj) in CORNERS[t]]
    gux = sum(sd.grads[t, a, 0] * c[a] for a in range(3))
    guy = sum(sd.grads[t, a, 1] * c[a] for a in range(3))
    return c, gux, guy


def nonlinear_rhs(sd: StructuredData, x2, flux: Flux):
    """N(u)_a = int (f'(u) . grad u) phi_a dx, componentwise quadrature
    planes (every intermediate is an (nx, ny) plane)."""
    fx, fy = flux.fprime_xy
    nx, ny = sd.nx, sd.ny
    out = torch.zeros((nx + 1, ny + 1), dtype=x2.dtype, device=x2.device)
    two_area = 2.0 * sd.area
    for t in range(2):
        c, gux, guy = _corners_and_grad(sd, x2, t)
        vals = [None, None, None]
        for q in range(sd.qw.shape[0]):
            uq = sum(sd.phi[q, a] * c[a] for a in range(3))
            conv = fx(uq) * gux + fy(uq) * guy
            for a in range(3):
                w = two_area * sd.qw[q] * sd.phi[q, a]
                vals[a] = conv * w if vals[a] is None else vals[a] + conv * w
        for a, (di, dj) in enumerate(CORNERS[t]):
            out[di:di + nx, dj:dj + ny] += vals[a]
    return out


def keps_coef(sd: StructuredData, eps2):
    """eps-weighted stiffness stencil (eps P1 -> exact mean rule)."""
    nx, ny = sd.nx, sd.ny
    coef = torch.zeros((len(OFFSETS), nx + 1, ny + 1), dtype=eps2.dtype,
                       device=eps2.device)
    for t in range(2):
        cs = CORNERS[t]
        ae = sd.area / 3.0 * sum(eps2[di:di + nx, dj:dj + ny]
                                 for (di, dj) in cs)
        for a in range(3):
            dai, daj = cs[a]
            for b in range(3):
                gg = (sd.grads[t, a, 0] * sd.grads[t, b, 0]
                      + sd.grads[t, a, 1] * sd.grads[t, b, 1])
                p = _PLANE[(cs[b][0] - dai, cs[b][1] - daj)]
                coef[p, dai:dai + nx, daj:daj + ny] += gg * ae
    return coef


def flux_jacobian_coef(sd: StructuredData, x2, flux: Flux):
    """Stencil of d/du N(u): componentwise quadrature planes, with f' and
    f'' from the flux's explicit derivative callables."""
    fx, fy = flux.fprime_xy
    dfx, dfy = flux.fprime2_xy
    nx, ny = sd.nx, sd.ny
    coef = torch.zeros((len(OFFSETS), nx + 1, ny + 1), dtype=x2.dtype,
                       device=x2.device)
    two_area = 2.0 * sd.area
    for t in range(2):
        cs = CORNERS[t]
        c, gux, guy = _corners_and_grad(sd, x2, t)
        loc = [[None] * 3 for _ in range(3)]
        for q in range(sd.qw.shape[0]):
            uq = sum(sd.phi[q, a] * c[a] for a in range(3))
            fpx, fpy = fx(uq), fy(uq)
            t1 = dfx(uq) * gux + dfy(uq) * guy
            gb = [fpx * sd.grads[t, b, 0] + fpy * sd.grads[t, b, 1]
                  for b in range(3)]
            for a in range(3):
                wqa = sd.qw[q] * sd.phi[q, a]
                for b in range(3):
                    contrib = (two_area * wqa) * (t1 * sd.phi[q, b] + gb[b])
                    loc[a][b] = (contrib if loc[a][b] is None
                                 else loc[a][b] + contrib)
        for a in range(3):
            dai, daj = cs[a]
            for b in range(3):
                p = _PLANE[(cs[b][0] - dai, cs[b][1] - daj)]
                coef[p, dai:dai + nx, daj:daj + ny] += loc[a][b]
    return coef


def mass_matvec(sd: StructuredData, x2):
    return matvec(sd, sd.M_coef, x2)


# ---------------------------------------------------------------------------
# RV epsilon on the grid (cf. stabilization.rv_epsilon_nonlinear)
# ---------------------------------------------------------------------------


def _patch_reduce(x2, reducer, pad_val):
    """Reduce over the 7-neighbour patch with boundary-safe padding."""
    n1x, n1y = x2.shape
    xp = F.pad(x2, (1, 1, 1, 1), value=pad_val)
    acc = x2
    for (di, dj) in OFFSETS[1:]:
        acc = reducer(acc, _shifted(xp, di, dj, n1x, n1y))
    return acc


def rv_epsilon(sd: StructuredData, Cvel, Crv, u2, Rh2, fprime_norm,
               abs_term=None):
    """Grid version of stabilization.rv_epsilon_nonlinear. abs_term =
    max|u - mean u| is the one global reduction; a caller that holds only a
    row block of the grid (ops/fused_step.fused_rv_block_step) passes it
    in."""
    if abs_term is None:
        abs_term = (u2 - u2.mean()).abs().max()
    u_max = _patch_reduce(u2, torch.maximum, -np.inf)
    u_min = _patch_reduce(u2, torch.minimum, np.inf)
    n_i = ((u_max - u_min) - abs_term).abs()
    Rh_i = _patch_reduce(Rh2.abs(), torch.maximum, -np.inf)
    R_i = Rh_i / n_i.clamp_min(tiny_of(u2.dtype))
    beta = _patch_reduce(fprime_norm(u2), torch.maximum, -np.inf)
    return torch.minimum(Cvel * sd.h_cg2 * beta,
                         Crv * sd.h_cg2 ** 2 * R_i.abs())


# ---------------------------------------------------------------------------
# grid versions of the stabilisation library (cf. ops/stabilization.py)
# ---------------------------------------------------------------------------


def directional_convection_coefs(sd: StructuredData):
    """Stencil forms of Cx, Cy with (Cd)_ab = (A/3) g_b[d] per cell
    (cf. assembly.assemble_directional_convection; group-FEM Euler)."""
    nx, ny = sd.nx, sd.ny
    coefs = []
    for d in range(2):
        loc_t = sd.area / 3.0 * sd.grads[:, :, d]        # (2,3): type, b
        loc = loc_t[:, None, None, None, :].expand(2, nx, ny, 3, 3)
        coefs.append(local_to_stencil(sd, loc))
    return coefs[0], coefs[1]


def lumped_mass_grid(sd: StructuredData):
    """Row-sum lumped mass on the grid: M_coef applied to ones."""
    ones = torch.ones((sd.nx + 1, sd.ny + 1), dtype=sd.M_coef.dtype,
                      device=sd.M_coef.device)
    return matvec(sd, sd.M_coef, ones)


def stiffness_bc_coef(sd: StructuredData):
    """The bc-applied stiffness as stencil planes: rows and columns at
    Dirichlet nodes zeroed, unit diagonal (cf. bc.ell_with_bc; the SI
    kernel reads these entries)."""
    nx, ny = sd.nx, sd.ny
    gg = torch.einsum("tad,tbd->tab", sd.grads, sd.grads)
    loc = (sd.area * gg)[:, None, None].expand(2, nx, ny, 3, 3)
    K = local_to_stencil(sd, loc)
    bc = sd.bc2
    n1x, n1y = nx + 1, ny + 1
    bcp = F.pad(bc, (1, 1, 1, 1))
    planes = []
    for k, (di, dj) in enumerate(OFFSETS):
        v = torch.where(bc | _shifted(bcp, di, dj, n1x, n1y), 0.0, K[k])
        if k == 0:
            v = torch.where(bc, 1.0, v)
        planes.append(v)
    return torch.stack(planes)


def si_epsilon_grid(sd: StructuredData, Cm, K_bc_coef, u2, beta2,
                    eps_floor=1e-8):
    """Grid SI (cf. stabilization.si_epsilon): alpha_i = |sum_k b_ik du_ik|
    / max(sum_k |b_ik| |du_ik|, eps), eps_i = psi(alpha_i) Cm h_i beta_i."""
    from conservation_fem_tpu_torch.ops.stabilization import (
        sigmoid_activation)

    n1x, n1y = u2.shape
    up = F.pad(u2, (1, 1, 1, 1))
    num = torch.zeros_like(u2)
    den = torch.zeros_like(u2)
    for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
        du = _shifted(up, di, dj, n1x, n1y) - u2
        b = K_bc_coef[k]
        num = num + b * du
        den = den + b.abs() * du.abs()
    alpha = num.abs() / den.clamp_min(eps_floor)
    return sigmoid_activation(alpha) * Cm * sd.h_cg2 * beta2


def rv_epsilon_system_grid(sd: StructuredData, Cvel, Crv, rho2, Rh2, beta2):
    """Grid version of stabilization.rv_epsilon_system (Euler: density
    normalisation, precomputed wavespeed field)."""
    abs_term = (rho2 - rho2.mean()).abs().max()
    r_max = _patch_reduce(rho2, torch.maximum, -np.inf)
    r_min = _patch_reduce(rho2, torch.minimum, np.inf)
    n_i = ((r_max - r_min) - abs_term).abs()
    Rh_i = _patch_reduce(Rh2.abs(), torch.maximum, -np.inf)
    beta_i = _patch_reduce(beta2, torch.maximum, -np.inf)
    return torch.minimum(
        Cvel * sd.h_cg2 * beta_i,
        Crv * sd.h_cg2 ** 2 * (Rh_i / n_i.clamp_min(tiny_of(rho2.dtype)))
        .abs())


def smooth_vector_grid(sd: StructuredData, u2, l):
    """Grid version of stabilization.smooth_vector (Jacobi variant):
    u_i <- (sum_{j!=i} u_j + (l-1) d u_i) / (l d)."""
    n1x, n1y = u2.shape
    up = F.pad(u2, (1, 1, 1, 1))
    onesp = F.pad(torch.ones_like(u2), (1, 1, 1, 1))
    nbr_sum = torch.zeros_like(u2)
    d = torch.zeros_like(u2)
    for (di, dj) in OFFSETS[1:]:
        nbr_sum = nbr_sum + _shifted(up, di, dj, n1x, n1y)
        d = d + _shifted(onesp, di, dj, n1x, n1y)
    d = d.clamp_min(1.0)
    return (nbr_sum + (l - 1.0) * d * u2) / (l * d)
