"""The port's whole-step kernel choice (StructuredHyperbolicProblem.
_fused_mode) equals the JAX package's rule at the main path's mesh sizes,
in f32 and f64, for both inner solvers — so a configuration launches the
counterpart of the kernel the JAX package launches. Both sides are mesh-2
problems whose StructuredData is given the larger nx, ny, so nothing large
is built."""

import dataclasses
import functools

import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu_torch.models import kpp as tkpp

FIXED = dict(cg_iters=6, newton_iters=2, newton_linear_iters=4,
             modified_newton=True)
# (mesh, dtype) -> mode: per field (4 mesh + 1)^2 x itemsize against the
# 270 KiB / 1100 KiB gates
EXPECTED = {
    (32, "float32"): "single", (64, "float32"): "single",
    (128, "float32"): "split", (256, "float32"): "tiled",
    (512, "float32"): "tiled",
    (32, "float64"): "single", (64, "float64"): "split",
    (128, "float64"): "tiled", (256, "float64"): "tiled",
    (512, "float64"): "tiled",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run shares the cores among several
    pytest worker processes, where torch's thread pool only
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _problems(dtype, solver):
    cfg = dict(mesh_size=2, dtype=dtype, inner_solver=solver, **FIXED)
    pj = jkpp.build(jkpp.KPPConfig(backend="stencil", **cfg))
    pj.cfg = dataclasses.replace(pj.cfg, use_pallas=True)
    pt = tkpp.build(tkpp.KPPConfig(use_kernels=True, **cfg), device="cpu")
    return pj, pt


@pytest.mark.parametrize("solver", ["bicgstab", "cheby"])
@pytest.mark.parametrize("mesh,dtype", sorted(EXPECTED))
def test_fused_mode_matches_jax(mesh, dtype, solver):
    pj, pt = _problems(dtype, solver)
    n = 4 * mesh
    pj_sd, pt_sd = pj.sd, pt.sd
    try:
        pj.sd = pj_sd._replace(nx=n, ny=n)
        pt.sd = pt_sd._replace(nx=n, ny=n)
        assert pt._fused_mode() == pj._fused_mode() == EXPECTED[mesh, dtype]
    finally:
        pj.sd, pt.sd = pj_sd, pt_sd


def test_fused_mode_none_without_kernels():
    """No kernels, or adaptive solvers: no whole-step kernel, as in JAX."""
    pt = tkpp.build(tkpp.KPPConfig(mesh_size=2, **FIXED), device="cpu")
    assert pt._fused_mode() is None
    pt = tkpp.build(tkpp.KPPConfig(mesh_size=2, use_kernels=True),
                    device="cpu")
    assert pt._fused_mode() is None
