"""The port's sharded f64-accumulated reductions (ops/precision.pdot_acc64,
psum_acc64) against the JAX package's on its 8 virtual CPU devices, and
the sharded fused structured path with ``precise_reductions``:

  * pdot_acc64 / psum_acc64 on LocalBlocks(8) against the JAX twins under
    ``jax.jit`` of a ``shard_map`` over 8 devices: equal in f32 (both sum
    the same f64 partials, in another order, and round once), 1e-14
    relative in f64;
  * an f32 input whose block-ordered f32 sum is not its f64-accumulated
    one, so the flag changes the result: pdot_acc64 gives the exact f64
    sum rounded once, the plain block-ordered f32 dot does not;
  * ShardedFusedStructured takes precise_reductions=True and its solve is
    bit for bit the solve without the flag (its step has no dot product,
    as in the JAX class).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conservation_fem_tpu.ops import precision as jprec
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops.precision import pdot_acc64, psum_acc64
from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                 ShardedFusedStructured)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_reductions():
    """jit(shard_map) of the JAX pdot_acc64 and psum_acc64 over 8
    devices."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("i",))
    pdot = jax.jit(jax.shard_map(
        lambda a, b: jprec.pdot_acc64("i")(a, b), mesh=mesh,
        in_specs=(P("i"), P("i")), out_specs=P()))
    psum = jax.jit(jax.shard_map(
        lambda v: jprec.psum_acc64(v[0], "i"), mesh=mesh,
        in_specs=P("i"), out_specs=P()))
    return pdot, psum


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_reductions_match_jax(dtype):
    rng = np.random.default_rng(7)
    a = rng.standard_normal(8 * 37).astype(dtype)
    b = rng.standard_normal(8 * 37).astype(dtype)
    parts = (rng.standard_normal(8) * 1e3).astype(dtype)
    jdot, jsum = _jax_reductions()
    blocks = LocalBlocks(8, "cpu")
    got_dot = pdot_acc64(blocks)(torch.from_numpy(a.reshape(8, -1)),
                                 torch.from_numpy(b.reshape(8, -1)))
    got_sum = psum_acc64(torch.from_numpy(parts), blocks)
    ref_dot = np.asarray(jdot(a, b))
    ref_sum = np.asarray(jsum(parts))
    assert got_dot.dtype == getattr(torch, dtype) and got_dot.shape == ()
    assert got_sum.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert got_dot.item() == ref_dot.item()
        assert got_sum.item() == ref_sum.item()
    else:
        np.testing.assert_allclose(got_dot.item(), ref_dot, rtol=1e-14)
        np.testing.assert_allclose(got_sum.item(), ref_sum, rtol=1e-14)


def test_acc64_differs_from_block_ordered_f32():
    """Cancelling partials: the f32 block-ordered sum loses the small terms
    that the f64 carriage keeps."""
    a = np.zeros((4, 3), np.float32)
    a[:, 0] = [1e8, 1.0, -1e8, 1.0]
    a[:, 1] = [3.0, 1.0, 1.0, 1.0]
    b = np.ones_like(a)
    blocks = LocalBlocks(4, "cpu")
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    exact = np.float32((a.astype(np.float64) * b).sum())
    precise = pdot_acc64(blocks)(at, bt)
    plain = blocks.sum((at * bt).sum(dim=1)).reshape(())
    assert precise.item() == exact
    assert plain.item() != exact
    parts = torch.tensor([1e8, 1.0, -1e8, 1.0], dtype=torch.float32)
    assert psum_acc64(parts, blocks).item() == 2.0
    assert blocks.sum(parts).item() != 2.0


def test_sharded_fused_accepts_precise_reductions():
    """The JAX class runs this configuration; the port's runs it too, and
    bit for bit as without the flag."""
    cfg = dict(mesh_size=6, T=0.02, modified_newton=True,
               inner_solver="cheby", cg_iters=4, newton_iters=2,
               newton_linear_iters=4)
    runs = [ShardedFusedStructured(
        tkpp.build(tkpp.KPPConfig(**cfg, precise_reductions=flag),
                   device="cpu"), LocalBlocks(3, "cpu")).solve()
        for flag in (False, True)]
    assert torch.equal(runs[0], runs[1])
    assert torch.isfinite(runs[1]).all()
