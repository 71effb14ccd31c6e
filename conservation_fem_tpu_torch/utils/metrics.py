"""Per-step metrics, timers and profiling helpers, ported from
conservation_fem_tpu/utils/metrics.py.

``StepTimer`` times wall clock with per-step throughput accounting and
synchronises the device on entry and exit, so that it times the run and
not the host's enqueue; ``profile_trace`` is torch.profiler over the CPU
and, where there is one, the card, writing a Chrome trace;
``metrics_to_json`` summarises stacked per-step metrics in one JSON line.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

from conservation_fem_tpu_torch.utils.checkpoint import host_array

TRACE_FILE = "trace.json"


def _synchronize():
    """Wait for the current CUDA device, when CUDA is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock timer with per-step throughput accounting; on entry and
    exit it waits for the current CUDA device (when CUDA is in use), so it
    times the device's work and not the host's enqueue."""

    def __init__(self, n_dofs: int):
        self.n_dofs = n_dofs
        self._t0 = None
        self.elapsed = 0.0
        self.steps = 0

    def __enter__(self):
        _synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _synchronize()
        self.elapsed += time.perf_counter() - self._t0

    def count(self, steps: int):
        self.steps += steps

    @property
    def dof_steps_per_sec(self):
        return self.n_dofs * self.steps / max(self.elapsed, 1e-12)

    def summary(self):
        return {
            "steps": self.steps,
            "elapsed_s": round(self.elapsed, 4),
            "steps_per_sec": round(self.steps / max(self.elapsed, 1e-12), 2),
            "dof_steps_per_sec": round(self.dof_steps_per_sec, 1),
        }


@contextlib.contextmanager
def profile_trace(logdir=None):
    """torch.profiler over the CPU and, when CUDA is available, the card;
    on exit the Chrome trace goes to logdir/TRACE_FILE (logdir None: a new
    temporary directory). Yields logdir."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="cft_trace_")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        _synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def metrics_to_json(metrics: dict) -> str:
    """Stacked per-step metrics dict -> one JSON summary line."""
    out = {}
    for k, v in (metrics or {}).items():
        arr = host_array(v)
        if arr.dtype == bool:
            out[k] = {"all": bool(arr.all()), "frac": float(arr.mean())}
        else:
            out[k] = {
                "min": float(arr.min()), "max": float(arr.max()),
                "last": float(arr.reshape(-1)[-1]),
            }
    return json.dumps(out)
