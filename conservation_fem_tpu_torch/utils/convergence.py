"""Mesh-refinement convergence harness, a copy of the JAX package's
conservation_fem_tpu/utils/convergence.py (numpy only): solve at h = 1 /
mesh_size for each size and fit log10(err) ~ slope * log10(h) by least
squares, the reference's 4-point refinement h in 1/[4, 8, 16, 32].
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np


class ConvergenceResult(NamedTuple):
    hmaxes: np.ndarray
    errors: np.ndarray
    slope: float
    fit: tuple  # (slope, intercept)

    def rates(self) -> np.ndarray:
        """Pairwise convergence rates log(e_i / e_i+1) / log(h_i / h_i+1)."""
        return (np.log(self.errors[:-1] / self.errors[1:])
                / np.log(self.hmaxes[:-1] / self.hmaxes[1:]))


def run_convergence(
    solve_fn: Callable[[int], float],
    mesh_sizes: Sequence[int] = (4, 8, 16, 32),
) -> ConvergenceResult:
    """solve_fn(mesh_size) -> L2 error. Fits log10(err) ~ slope*log10(h)."""
    hmaxes = 1.0 / np.asarray(mesh_sizes, dtype=float)
    errors = np.array([float(solve_fn(n)) for n in mesh_sizes])
    fit = np.polyfit(np.log10(hmaxes), np.log10(errors), 1)
    return ConvergenceResult(hmaxes, errors, float(fit[0]), tuple(fit))
