"""Exact Riemann solver for the 1D compressible Euler equations, the port
of conservation_fem_tpu/utils/riemann_exact.py (host numpy, Toro's
pressure-function Newton iteration; the port keeps its own copy).

The accuracy oracle of the Sod shock tube in models/euler.py
(``sod_density_error``): ``solve_star`` gives the star-region pressure
and velocity, ``sample`` the self-similar solution W(x/t), ``sod_exact``
the Sod tube's density, velocity and pressure at time t.
"""

from __future__ import annotations

import numpy as np


def _sound_speed(gamma, rho, p):
    return np.sqrt(gamma * p / rho)


def _pressure_function(p, rho_k, p_k, c_k, gamma):
    """f_K(p) and f_K'(p) from Toro ch. 4."""
    if p > p_k:  # shock
        A = 2.0 / ((gamma + 1) * rho_k)
        B = (gamma - 1) / (gamma + 1) * p_k
        f = (p - p_k) * np.sqrt(A / (p + B))
        df = np.sqrt(A / (B + p)) * (1 - (p - p_k) / (2 * (B + p)))
    else:  # rarefaction
        f = 2 * c_k / (gamma - 1) * ((p / p_k) ** ((gamma - 1) / (2 * gamma)) - 1)
        df = 1.0 / (rho_k * c_k) * (p / p_k) ** (-(gamma + 1) / (2 * gamma))
    return f, df


def solve_star(rho_l, u_l, p_l, rho_r, u_r, p_r, gamma=1.4, tol=1e-12):
    """Star-region pressure/velocity via Newton iteration."""
    c_l = _sound_speed(gamma, rho_l, p_l)
    c_r = _sound_speed(gamma, rho_r, p_r)
    du = u_r - u_l
    p = max(tol, 0.5 * (p_l + p_r) - 0.125 * du * (rho_l + rho_r) * (c_l + c_r))
    for _ in range(100):
        f_l, df_l = _pressure_function(p, rho_l, p_l, c_l, gamma)
        f_r, df_r = _pressure_function(p, rho_r, p_r, c_r, gamma)
        dp = (f_l + f_r + du) / (df_l + df_r)
        p_new = max(tol, p - dp)
        if abs(p_new - p) < tol * p:
            p = p_new
            break
        p = p_new
    f_l, _ = _pressure_function(p, rho_l, p_l, c_l, gamma)
    f_r, _ = _pressure_function(p, rho_r, p_r, c_r, gamma)
    u_star = 0.5 * (u_l + u_r) + 0.5 * (f_r - f_l)
    return p, u_star


def sample(xi, rho_l, u_l, p_l, rho_r, u_r, p_r, gamma=1.4):
    """Self-similar solution W(xi = x/t): returns (rho, u, p) arrays."""
    xi = np.asarray(xi, dtype=float)
    c_l = _sound_speed(gamma, rho_l, p_l)
    c_r = _sound_speed(gamma, rho_r, p_r)
    p_star, u_star = solve_star(rho_l, u_l, p_l, rho_r, u_r, p_r, gamma)
    g1 = (gamma - 1) / (gamma + 1)
    rho = np.empty_like(xi)
    u = np.empty_like(xi)
    p = np.empty_like(xi)

    left = xi <= u_star
    # --- left side
    if p_star > p_l:  # left shock
        rho_star_l = rho_l * ((p_star / p_l + g1) / (g1 * p_star / p_l + 1))
        s_l = u_l - c_l * np.sqrt((gamma + 1) / (2 * gamma) * p_star / p_l
                                  + (gamma - 1) / (2 * gamma))
        in_l = left & (xi < s_l)
        in_star = left & (xi >= s_l)
        rho[in_l], u[in_l], p[in_l] = rho_l, u_l, p_l
        rho[in_star], u[in_star], p[in_star] = rho_star_l, u_star, p_star
    else:  # left rarefaction
        rho_star_l = rho_l * (p_star / p_l) ** (1 / gamma)
        c_star_l = c_l * (p_star / p_l) ** ((gamma - 1) / (2 * gamma))
        head, tail = u_l - c_l, u_star - c_star_l
        pre = left & (xi < head)
        fan = left & (xi >= head) & (xi < tail)
        star = left & (xi >= tail)
        rho[pre], u[pre], p[pre] = rho_l, u_l, p_l
        u[fan] = 2 / (gamma + 1) * (c_l + (gamma - 1) / 2 * u_l + xi[fan])
        cfan = 2 / (gamma + 1) * (c_l + (gamma - 1) / 2 * (u_l - xi[fan]))
        rho[fan] = rho_l * (cfan / c_l) ** (2 / (gamma - 1))
        p[fan] = p_l * (cfan / c_l) ** (2 * gamma / (gamma - 1))
        rho[star], u[star], p[star] = rho_star_l, u_star, p_star

    right = ~left
    # --- right side
    if p_star > p_r:  # right shock
        rho_star_r = rho_r * ((p_star / p_r + g1) / (g1 * p_star / p_r + 1))
        s_r = u_r + c_r * np.sqrt((gamma + 1) / (2 * gamma) * p_star / p_r
                                  + (gamma - 1) / (2 * gamma))
        in_r = right & (xi > s_r)
        in_star = right & (xi <= s_r)
        rho[in_r], u[in_r], p[in_r] = rho_r, u_r, p_r
        rho[in_star], u[in_star], p[in_star] = rho_star_r, u_star, p_star
    else:  # right rarefaction
        rho_star_r = rho_r * (p_star / p_r) ** (1 / gamma)
        c_star_r = c_r * (p_star / p_r) ** ((gamma - 1) / (2 * gamma))
        head, tail = u_r + c_r, u_star + c_star_r
        post = right & (xi > head)
        fan = right & (xi <= head) & (xi > tail)
        star = right & (xi <= tail)
        rho[post], u[post], p[post] = rho_r, u_r, p_r
        cfan = 2 / (gamma + 1) * (c_r - (gamma - 1) / 2 * (u_r - xi[fan]))
        u[fan] = 2 / (gamma + 1) * (-c_r + (gamma - 1) / 2 * u_r + xi[fan])
        rho[fan] = rho_r * (cfan / c_r) ** (2 / (gamma - 1))
        p[fan] = p_r * (cfan / c_r) ** (2 * gamma / (gamma - 1))
        rho[star], u[star], p[star] = rho_star_r, u_star, p_star

    return rho, u, p


def sod_exact(x, t, x0=0.5, gamma=1.4):
    """Sod shock tube: L=(1,0,1), R=(0.125,0,0.1); returns (rho,u,p)."""
    if t <= 0:
        x = np.asarray(x, dtype=float)
        left = x <= x0
        rho = np.where(left, 1.0, 0.125)
        p = np.where(left, 1.0, 0.1)
        return rho, np.zeros_like(rho), p
    xi = (np.asarray(x, dtype=float) - x0) / t
    return sample(xi, 1.0, 0.0, 1.0, 0.125, 0.0, 0.1, gamma)
