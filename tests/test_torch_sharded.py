"""The port's owner-cell decomposition (conservation_fem_tpu_torch/parallel/
sharded.py) against the JAX package's shard_problem on the 8 virtual CPU
devices of tests/conftest.py and against the port's single-device ELL
step, f64, on the CPU: the JAX package's own cases
(tests/test_sharded.py), KPP mesh 4 (the [-2,2]^2 rectangle nx 16, 512
cells) on the ELL backend.

Tolerances, absolute on O(1) fields, the JAX package's:
  * 1e-13 for the sharded nonlinear residual and eps-stiffness against
    JAX's (the same cell sums, added over the blocks in another order);
  * 1e-10 for the full solve against the single-device run, on 8 blocks
    and on 3 (512 cells: the zero-area padding cells).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.parallel.sharded import shard_problem as jshard
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                 ShardedHyperbolicProblem,
                                                 shard_problem)

CFG = dict(mesh_size=4, T=0.05, backend="ell")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(**kw):
    return tkpp.build(tkpp.KPPConfig(**CFG, **kw), device="cpu")


def _inputs(p):
    u = p.u0 + 0.01 * torch.sin(p.points[:, 0])
    return u, torch.cos(u).abs()


@functools.lru_cache(maxsize=None)
def _jax_kernels():
    """JAX's sharded residual and eps-stiffness on 8 devices, at the same
    u and eps."""
    devs = jax.devices()
    assert len(devs) >= 8
    pj = jshard(jkpp.build(jkpp.KPPConfig(**CFG)),
                jax.sharding.Mesh(np.array(devs[:8]), ("fem",)))
    u = pj.u0 + 0.01 * jnp.sin(pj.mesh.points[:, 0])
    # jitted: eager shard_map dispatches op by op (~7 s each here)
    return (np.asarray(jax.jit(pj._nonlinear_rhs)(u)),
            np.asarray(jax.jit(pj._assemble_keps)(jnp.abs(jnp.cos(u)))))


def test_sharded_kernels_match_jax():
    r_ref, k_ref = _jax_kernels()
    p = shard_problem(_port(), LocalBlocks(8, "cpu"))
    u, eps = _inputs(p)
    np.testing.assert_allclose(p._nonlinear_rhs(u).numpy(), r_ref, rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(p._assemble_keps(eps).numpy(), k_ref, rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("n", [3, 8])
def test_sharded_kernels_match_single_device(n):
    ref = _port()
    p = shard_problem(_port(), LocalBlocks(n, "cpu"))
    assert (p.host_mesh.n_cells % n == 0) == (n == 8)    # 3: padded
    u, eps = _inputs(ref)
    np.testing.assert_allclose(p._nonlinear_rhs(u).numpy(),
                               ref._nonlinear_rhs(u).numpy(), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(p._assemble_keps(eps).numpy(),
                               ref._assemble_keps(eps).numpy(), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("n", [3, 8])
def test_full_solve_matches_single_device(n):
    ref = _port().solve().u
    p = shard_problem(_port(), LocalBlocks(n, "cpu"))
    assert isinstance(p, ShardedHyperbolicProblem)
    u = p.solve().u
    np.testing.assert_allclose(u.numpy(), ref.numpy(), rtol=0, atol=1e-10)
    assert (u - p.u0).abs().max() > 1e-3                  # it moved


def test_refuses_other_problems_and_devices():
    with pytest.raises(ValueError):
        shard_problem(tkpp.build(tkpp.KPPConfig(mesh_size=4), device="cpu"),
                      LocalBlocks(2, "cpu"))               # stencil backend
    with pytest.raises(ValueError):
        shard_problem(_port(), LocalBlocks(2, "meta"))
