"""The row-sharded Euler solver of the port
(conservation_fem_tpu_torch/parallel/euler_sharded.py) against the JAX
package's ShardedStructuredEuler on the 8 virtual CPU devices of
tests/conftest.py and against the port's single-device stencil step, f64,
on the CPU: Sod nx 24 and the 2D Riemann problem nx 13 (14 rows over 8
blocks: the padding path), the configurations of the JAX package's own
tests (tests/test_euler_sharded.py); a run continued from a JAX carry; a
checkpoint across block counts; two gloo ranks.

Tolerances: 1e-10 against the JAX class and the single-device path (the
JAX package's sharded bound; the RV mean is reduced in another order); bit
for bit against an in-memory transfer and between two gloo ranks and
LocalBlocks(2).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import euler as jeuler
from conservation_fem_tpu.parallel.euler_sharded import (
    shard_euler as jax_shard)
from conservation_fem_tpu_torch.models import euler as teuler
from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                 ShardedStructuredEuler,
                                                 shard_euler)
from torch_ranks import run_ranks

TOL = 1e-10
CASES = {"sod_nx24": dict(problem="sod", nx=24, T=0.05),
         "riemann2d_nx13": dict(problem="riemann2d", nx=13, T=0.05)}
CONTINUE_FROM = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name):
    return teuler.build(teuler.EulerConfig(**CASES[name]), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX sharded class on 8 virtual devices: its geometry, its final
    U and, for Sod, its carry after CONTINUE_FROM steps (global (N, 4)).
    Built once per module."""
    devs = jax.devices()
    assert len(devs) >= 8
    p = jeuler.build(**CASES[name])
    js = jax_shard(p, jax.sharding.Mesh(np.array(devs[:8]), ("i",)))
    carry = None
    if name == "sod_nx24":
        n1x, n1y = js.nx + 1, js.n1y
        U = jax.numpy.pad(
            jax.numpy.moveaxis(p.U0.reshape(n1x, n1y, 4), -1, 0),
            ((0, 0), (0, js.pad_rows), (0, 0)))
        step = jax.jit(lambda U, Uo: js.make_step()(
            js.Mc_s, js.Cx_s, js.Cy_s, js.ml_s, js.bc_s, js.slip_s, js.h_s,
            js.valid_s, U, Uo))
        c = (U, U)
        for _ in range(CONTINUE_FROM):
            c = step(*c)
        carry = tuple(np.moveaxis(np.asarray(x)[:, :n1x], 0, -1)
                      .reshape(-1, 4) for x in c)
    return dict(L=js.L, pad_rows=js.pad_rows, num_steps=p.num_steps,
                U=np.asarray(js.solve()), carry=carry)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_sharded_class(name):
    ref = _jax(name)
    sh = ShardedStructuredEuler(_port(name), LocalBlocks(8, "cpu"))
    assert (sh.L, sh.pad_rows, sh.p.num_steps) == (
        ref["L"], ref["pad_rows"], ref["num_steps"])
    if name == "riemann2d_nx13":
        assert sh.pad_rows > 0
    U = sh.solve()
    assert U.shape == (sh.n1x * sh.n1y, 4)
    np.testing.assert_allclose(U.numpy(), ref["U"], rtol=0, atol=TOL)
    assert np.abs(ref["U"] - sh.p.U0.numpy()).max() > 1e-3     # it moved


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_single_device(name, n):
    ref = teuler.solve(_port(name)).U
    U = shard_euler(_port(name), LocalBlocks(n, "cpu")).solve()
    np.testing.assert_allclose(U.numpy(), ref.numpy(), rtol=0, atol=TOL)


def test_continues_a_jax_carry():
    """Sod from JAX's carry after 2 steps, on 3 blocks, to JAX's end
    state."""
    ref = _jax("sod_nx24")
    sh = ShardedStructuredEuler(_port("sod_nx24"), LocalBlocks(3, "cpu"))
    sh.set_carry(*ref["carry"], start_step=CONTINUE_FROM)
    np.testing.assert_allclose(sh.solve().numpy(), ref["U"], rtol=0,
                               atol=TOL)


def test_checkpoint_restores_across_block_counts(tmp_path):
    """Saved on LocalBlocks(8) at step 2, restored on 3 blocks: the rows
    bit-equal, the continuation bit-equal to an in-memory transfer, and the
    checkpointed solve to the plain one."""
    path = str(tmp_path / "ck")
    s8 = ShardedStructuredEuler(_port("riemann2d_nx13"), LocalBlocks(8, "cpu"))
    c8 = s8.run_chunk(s8.init_carry(), 0, 2)
    s8.save_carry(path, 2, c8)
    s3 = ShardedStructuredEuler(_port("riemann2d_nx13"), LocalBlocks(3, "cpu"))
    step, c3 = s3.restore_carry(path)
    assert step == 2
    for a, b in zip(c3, c8):
        assert torch.equal(s3._to_global(a), s8._to_global(b))
    direct = tuple(s3._from_global(s8._to_global(x)) for x in c8)
    n = s3.p.num_steps - 2
    assert torch.equal(s3.run_chunk(c3, 2, n)[0],
                       s3.run_chunk(direct, 2, n)[0])
    assert torch.equal(s8.solve_checkpointed(path, every=3), s8.solve())


def test_process_group_blocks_equal_local_blocks(tmp_path):
    """Two gloo ranks (tests/torch_ranks.py) against LocalBlocks(2), Sod nx
    24, bit for bit: the four components exchanged together, the density
    mean gathered and added in block order."""
    got = run_ranks(tmp_path, "euler", (CASES["sod_nx24"],))
    ref = ShardedStructuredEuler(_port("sod_nx24"),
                                 LocalBlocks(2, "cpu")).solve().numpy()
    for U in got:
        assert np.array_equal(U, ref)
