"""Checkpoint and resume for time-stepping runs, ported from
conservation_fem_tpu/utils/checkpoint.py (its .npz part).

The solver carry (u_n, u_old, u_old_old), the step index and t go into one
plain .npz, in the JAX package's layout (``__step``, ``__t`` and the arrays
by name), so a checkpoint written by either package resumes in the other.
Tensors go to the host as numpy arrays at their own dtype; the solver puts
them back on its device at its dtype.

np.savez appends ".npz" to a path that lacks it; ``checkpoint_file`` names
the file it writes, and every function here reads and writes that file.
The JAX package's orbax checkpoints of sharded arrays are not ported
(orbax imports JAX): the sharded twins gather their rows and write this
.npz (parallel/structured_sharded.ShardedStructuredKPP.save_carry), which
resumes at any block count and in the single-device solve.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch


class Checkpoint(NamedTuple):
    step: int
    t: float
    arrays: dict          # name -> np.ndarray


def host_array(v) -> np.ndarray:
    """v (a tensor on any device, or array-like) as a host numpy array at
    its own dtype, copied from the device if it lives there."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True).numpy()
    return np.asarray(v)


def checkpoint_file(path: str) -> str:
    """The file np.savez writes for ``path``: the path itself when it ends
    in ".npz", else the path with ".npz" appended."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, step: int, t: float, **arrays) -> str:
    """Write step, t and the named arrays; returns the file written."""
    path = checkpoint_file(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __step=step, __t=t,
             **{k: host_array(v) for k, v in arrays.items()})
    return path


def load_checkpoint(path: str) -> Checkpoint:
    with np.load(checkpoint_file(path)) as f:
        arrays = {k: f[k] for k in f.files if not k.startswith("__")}
        return Checkpoint(int(f["__step"]), float(f["__t"]), arrays)
