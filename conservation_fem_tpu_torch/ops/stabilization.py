"""Artificial-viscosity stabilisation: RV and SI epsilon kernels (port of
conservation_fem_tpu/ops/stabilization.py).

  * RV (residual viscosity), the five variants;
  * SI (smoothness indicator) with its sigmoid gate, reading the stiffness
    entries from the patch-aligned ELL matrix;
  * patch smoothing (the Jacobi variant).

Every kernel is a few (N,K) gathers and masked row reductions over the
node patches (``MeshArrays.patch_cols`` / ``patch_mask``).

Reference behaviours kept on purpose, as in the JAX package:
  * the patch normalisation n_i = |u_tilde - ||u - mean(u)||_inf| can be ~0
    and spike R_i; only the min() clamps it, and a ``tiny`` floor (1e-300
    in f64, 1e-30 below) only avoids a literal division by zero;
  * ``rv_epsilon_linear`` takes the velocity at the patch owner, so beta
    is |w_i|;
  * ``rv_epsilon_cell`` scatters with last-cell-wins in file cell order by
    default (the node takes the eps of its highest-numbered cell).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from conservation_fem_tpu_torch.ops.mesh import MeshArrays
from conservation_fem_tpu_torch.ops.structured import tiny_of


def _patch_gather(mesh: MeshArrays, x):
    """x (N,) -> (N,K) patch values (padding gathers self, masked later)."""
    return x[mesh.patch_cols]


def _masked_max(vals, mask):
    return torch.where(mask, vals, -np.inf).amax(dim=1)


def _masked_min(vals, mask):
    return torch.where(mask, vals, np.inf).amin(dim=1)


def inf_norm_centered(u):
    """||u - mean(u)||_inf."""
    return (u - u.mean()).abs().max()


def _patch_normalised_residual(mesh: MeshArrays, u_norm, u_n, Rh):
    """max_{j in P_i} |Rh_j| / max(n_i, tiny), n_i = |(max - min of u_n
    over P_i) - ||u_norm - mean||_inf|."""
    mask = mesh.patch_mask
    u_patch = _patch_gather(mesh, u_n)
    u_tilde = _masked_max(u_patch, mask) - _masked_min(u_patch, mask)
    n_i = (u_tilde - inf_norm_centered(u_norm)).abs()
    Rh_i = _masked_max(_patch_gather(mesh, Rh).abs(), mask)
    return Rh_i / n_i.clamp_min(tiny_of(n_i.dtype))


# ---------------------------------------------------------------------------
# RV — residual viscosity
# ---------------------------------------------------------------------------


def rv_epsilon(Cvel, Crv, h, residual, beta):
    """Plain nodal RV: eps_i = min(Cvel h_i beta_i, Crv h_i^2 |R_i|)."""
    return torch.minimum(Cvel * h * beta, Crv * h**2 * residual.abs())


def rv_epsilon_1storder(h, beta):
    """First-order viscosity eps_i = 0.5 h_i |f'(u_i)|."""
    return 0.5 * h * beta


def rv_epsilon_nonlinear(mesh: MeshArrays, Cvel, Crv, uh, u_n,
                         fprime_norm: Callable, Rh, h):
    """Patch-normalised RV for nonlinear fluxes: for node i with patch P_i,
    u_tilde = max u_n - min u_n over P_i, n_i = |u_tilde - ||uh - mean
    uh||_inf|, R_i = max |Rh| over P_i / n_i, beta_i = max |f'(uh)| over
    P_i, eps_i = min(Cvel h_i beta_i, Crv h_i^2 |R_i|). fprime_norm: u ->
    |f'(u)| pointwise."""
    R_i = _patch_normalised_residual(mesh, uh, u_n, Rh)
    beta = _masked_max(_patch_gather(mesh, fprime_norm(uh)), mesh.patch_mask)
    return torch.minimum(Cvel * h * beta, Crv * h**2 * R_i.abs())


def rv_epsilon_linear(mesh: MeshArrays, Cvel, Crv, uh, u_n, w, Rh, h):
    """Patch-normalised RV with a vector velocity field w (N,2); beta_i =
    |w_i| (the reference evaluates w at the patch owner)."""
    R_i = _patch_normalised_residual(mesh, uh, u_n, Rh)
    beta = torch.linalg.norm(w, dim=1)
    return torch.minimum(Cvel * h * beta, Crv * h**2 * R_i.abs())


def rv_epsilon_linear_simple(Cvel, Crv, w, residual, u_n, h):
    """Globally normalised RV (the P2/P3 runs): R <- R / ||u_n -
    mean||_inf, eps_i = min(Cvel h |w_i|, Crv h^2 |R_i|)."""
    r = residual / inf_norm_centered(u_n)
    beta = torch.linalg.norm(w, dim=1)
    return torch.minimum(Cvel * h * beta, Crv * h**2 * r.abs())


def rv_epsilon_system(mesh: MeshArrays, Cvel, Crv, rho, beta, Rh, h):
    """RV for systems (Euler): rv_epsilon_nonlinear's patches over the
    density, with the wavespeed beta (|u| + c) a precomputed nodal field."""
    R_i = _patch_normalised_residual(mesh, rho, rho, Rh)
    beta_i = _masked_max(_patch_gather(mesh, beta), mesh.patch_mask)
    return torch.minimum(Cvel * h * beta_i, Crv * h**2 * R_i.abs())


def rv_epsilon_cell(mesh: MeshArrays, Cvel, Crv, residual_node, beta_cell,
                    h_cell, scatter: str = "last"):
    """Cell-based RV: eps_k = min(Cvel h_k beta_k, Crv h_k^2 max_{a in
    cell} |R_a|), scattered to the cell's nodes. scatter="last" (the
    reference's plain assignment in its cell loop): a node takes the eps of
    its highest-numbered cell in file order; "max": the largest eps of its
    cells. Both are order-independent maxima, so the card gives the same
    bits as the CPU."""
    n = mesh.patch_cols.shape[0]
    R_cell = residual_node[mesh.cells].abs().amax(dim=1)
    eps_k = torch.minimum(Cvel * h_cell * beta_cell,
                          Crv * h_cell**2 * R_cell)
    flat_nodes = mesh.cells.reshape(-1)
    if scatter == "max":
        out = torch.full((n,), -np.inf, dtype=eps_k.dtype,
                         device=eps_k.device)
        return out.scatter_reduce_(0, flat_nodes, eps_k.repeat_interleave(3),
                                   "amax")
    cell_idx = torch.arange(mesh.cells.shape[0], device=eps_k.device)
    last_cell = torch.zeros(n, dtype=torch.int64, device=eps_k.device)
    last_cell.scatter_reduce_(0, flat_nodes, cell_idx.repeat_interleave(3),
                              "amax", include_self=False)
    return eps_k[last_cell]


# ---------------------------------------------------------------------------
# SI — smoothness indicator
# ---------------------------------------------------------------------------


def sigmoid_activation(alpha, s=20.0, x0=0.5):
    """psi(alpha) = 1/(1+exp(-s(alpha-x0)))."""
    return 1.0 / (1.0 + torch.exp(-s * (alpha - x0)))


class SIResult(NamedTuple):
    epsilon: torch.Tensor
    alpha: torch.Tensor
    psi: torch.Tensor


def si_alpha(mesh: MeshArrays, stiffness_ell, u, eps_floor=1e-8):
    """Oscillation detector alpha_i = |sum_j b_ij du_ij| / max(sum_j |b_ij|
    |du_ij|, eps) over the node patch, du_ij = u_j - u_i (the diagonal's du
    is 0)."""
    mask = mesh.patch_mask
    du = _patch_gather(mesh, u) - u[:, None]
    b = stiffness_ell
    num = torch.where(mask, b * du, 0.0).sum(dim=1).abs()
    den = torch.where(mask, b.abs() * du.abs(), 0.0).sum(dim=1)
    return num / den.clamp_min(eps_floor)


def si_epsilon(mesh: MeshArrays, Cm, stiffness_ell, u_n, beta, h,
               eps_floor=1e-8) -> SIResult:
    """SI viscosity eps_i = psi(alpha_i) Cm h_i beta_i; beta (N,): the
    wavespeed, |w_i| (linear) or |f'(u_n_i)| (nonlinear)."""
    alpha = si_alpha(mesh, stiffness_ell, u_n, eps_floor)
    psi = sigmoid_activation(alpha)
    return SIResult(psi * Cm * h * beta, alpha, psi)


# ---------------------------------------------------------------------------
# smoothing
# ---------------------------------------------------------------------------


def smooth_vector(mesh: MeshArrays, u, l: float):
    """Jacobi patch blending u_i <- (sum_{j!=i} u_j + (l-1) d u_i) / (l d),
    d = patch size - 1 (the reference updates in place, node after node;
    this is the simultaneous version, as in the JAX package)."""
    mask = mesh.patch_mask
    total = torch.where(mask, _patch_gather(mesh, u), 0.0).sum(dim=1)
    d = (mask.sum(dim=1).to(u.dtype) - 1.0).clamp_min(1.0)
    return (total - u + (l - 1.0) * d * u) / (l * d)
