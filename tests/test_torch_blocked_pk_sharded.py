"""The port's sharded blocked Pk solver
(conservation_fem_tpu_torch/parallel/blocked_pk_sharded.py) against the
JAX package's class of the same name on its 8 virtual CPU devices, f64, on
the CPU, with the JAX package's own configuration and gate
(tests/test_blocked_pk_sharded.py), 1e-9 absolute:

  * DistributedBlockedPk, P2 Burgers mesh 10 (time-dependent Dirichlet
    data), rv and si on 4 blocks, against the JAX class; the fixed
    Chebyshev configuration against the port's single-device blocked run
    of the same configuration (1e-10) and within 2e-3 (relative L2) of the
    adaptive run, the JAX test's gate.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import burgers as jburgers
from conservation_fem_tpu.parallel.blocked_pk_sharded import \
    DistributedBlockedPk as JaxPk
from conservation_fem_tpu_torch.models import burgers as tburgers
from conservation_fem_tpu_torch.parallel import (DistributedBlockedPk,
                                                 LocalBlocks)

PK = dict(mesh_size=10, degree=2, T=0.04, dtype="float64", krylov_rtol=1e-10,
          newton_linear_rtol=1e-8, ell_matvec_backend="blocked")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _dmesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("i",))


@pytest.mark.parametrize("stab", ["rv", "si"])
def test_pk_twin_matches_jax_twin(stab):
    cfg = dict(PK, stabilization=stab)
    ref = JaxPk(jburgers.build(jburgers.BurgersConfig(**cfg)),
                _dmesh(4)).solve()
    sh = DistributedBlockedPk(
        tburgers.build(tburgers.BurgersConfig(**cfg), device="cpu"),
        LocalBlocks(4, "cpu"))
    np.testing.assert_allclose(sh.solve().numpy(), ref, rtol=0, atol=1e-9)


def test_pk_twin_fixed_solvers():
    kw = dict(PK, stabilization="si", modified_newton=True)
    fixed = dict(kw, cg_iters=12, newton_iters=3, newton_linear_iters=12,
                 inner_solver="cheby")
    build = lambda c: tburgers.build(tburgers.BurgersConfig(**c),
                                     device="cpu")
    got = DistributedBlockedPk(build(fixed), LocalBlocks(4, "cpu")).solve()
    np.testing.assert_allclose(got.numpy(), build(fixed).solve().u.numpy(),
                               rtol=0, atol=1e-10)
    adaptive = build(kw).solve().u
    assert float((got - adaptive).norm() / adaptive.norm()) < 2e-3
