"""The port's sharded blocked linear advection
(conservation_fem_tpu_torch/parallel/blocked_advection_sharded.py) against
the JAX package's class of the same name on its 8 virtual CPU devices,
f64, on the CPU, with the JAX package's own configuration and gate
(tests/test_blocked_advection.py), 1e-9 absolute: disk mesh 8 over 4
blocks, gfem, rv_node, rv_node_simple and si; rv_cell and rk4 refused
with the JAX message, a problem off the blocked backend refused.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import linear_advection as jadv
from conservation_fem_tpu.parallel.blocked_advection_sharded import \
    DistributedBlockedAdvection as JaxAdvection
from conservation_fem_tpu_torch.models import linear_advection as tadv
from conservation_fem_tpu_torch.parallel import (DistributedBlockedAdvection,
                                                 LocalBlocks)

ADV = dict(mesh_size=8, T=0.05, dtype="float64", ell_matvec_backend="blocked")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _dmesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("i",))


@pytest.mark.parametrize("stab", ["gfem", "rv_node", "rv_node_simple", "si"])
def test_advection_twin_matches_jax_twin(stab):
    cfg = dict(ADV, stabilization=stab)
    ref = JaxAdvection(jadv.build(jadv.AdvectionConfig(**cfg)),
                       _dmesh(4)).solve()
    got = DistributedBlockedAdvection(
        tadv.build(tadv.AdvectionConfig(**cfg), device="cpu"),
        LocalBlocks(4, "cpu")).solve()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9)


def test_advection_twin_refusals():
    for stab in ("rv_cell", "rk4"):
        extra = dict(rv_cell_scatter="max") if stab == "rv_cell" else {}
        p = tadv.build(tadv.AdvectionConfig(**ADV, stabilization=stab,
                                            **extra), device="cpu")
        with pytest.raises(NotImplementedError,
                           match="live on DistributedAdvection"):
            DistributedBlockedAdvection(p, LocalBlocks(2, "cpu"))
    p = tadv.build(tadv.AdvectionConfig(mesh_size=8, T=0.05), device="cpu")
    with pytest.raises(ValueError, match="ell_matvec_backend='blocked'"):
        DistributedBlockedAdvection(p, LocalBlocks(2, "cpu"))
