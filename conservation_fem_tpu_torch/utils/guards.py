"""Runtime failure detection: blow-up and NaN guards, CFL clamp, ported
from conservation_fem_tpu/utils/guards.py.

  * ``blown_up``: a 0-dim bool tensor on the field's device, computed
    there and read by nothing on the host (the reference's divergence
    guard ``if (linf > 1e3) error(...)``, ref Burger_CPP/main.cpp:463-464);
  * ``check_state``: the host guard, raising BlowupError;
  * ``clamp_final_dt``: the final-step CFL clamp (ref GFEM_pol.py:199-200).
"""

from __future__ import annotations

import numpy as np
import torch

from conservation_fem_tpu_torch.utils.checkpoint import host_array


class BlowupError(RuntimeError):
    pass


def blown_up(u, linf_max=1e3):
    """True when u holds a NaN or Inf or max|u| > linf_max (a 0-dim bool
    tensor on u's device)."""
    linf = torch.as_tensor(u).abs().max()
    return (~torch.isfinite(linf)) | (linf > linf_max)


def check_state(u, linf_max=1e3, what="solution"):
    """Host-side guard: raise if the field has blown up or gone NaN;
    returns max|u|."""
    arr = host_array(u)
    if not np.isfinite(arr).all():
        raise BlowupError(f"{what} contains NaN/Inf")
    linf = np.abs(arr).max()
    if linf > linf_max:
        raise BlowupError(f"{what} blew up: Linf = {linf:.3e} > {linf_max:g}")
    return float(linf)


def clamp_final_dt(t, dt, T):
    """dt' = min(dt, T - t): end exactly at T. Floats give a float; with a
    tensor among the arguments, a tensor in the first one's dtype, on its
    device."""
    tensors = [v for v in (t, dt, T) if isinstance(v, torch.Tensor)]
    if not tensors:
        return min(dt, T - t)
    f = lambda v: torch.as_tensor(v, dtype=tensors[0].dtype,
                                  device=tensors[0].device)
    return torch.minimum(f(dt), f(T) - f(t))
