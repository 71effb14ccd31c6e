"""The row-sharded stencil solver of the port
(conservation_fem_tpu_torch/parallel/structured_sharded.py) against the
JAX package's ShardedStructuredKPP on the 8 virtual CPU devices of
tests/conftest.py and against the port's single-device stencil path, f64,
on the CPU: KPP mesh 4, KPP mesh 3 (13 rows over 8 blocks: the padding
path) and Burgers mesh 12 (time-dependent Dirichlet data), the
configurations of the JAX package's own tests
(tests/test_structured_sharded.py); a run continued from a JAX carry; the
sharded carry checkpoint across block counts; two gloo ranks.

Tolerances, absolute on O(1) fields:
  * 1e-10 against the JAX sharded class and the single-device path: the
    JAX package's own sharded-against-single bound; the dots are reduced
    in another order;
  * bit for bit where the same arithmetic runs in the same order: a
    restore against the saved rows and against an in-memory transfer, a
    checkpointed or resumed solve against the plain one, two gloo ranks
    against LocalBlocks(2).
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import burgers as jburgers
from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.parallel.structured_sharded import (
    shard_structured as jax_shard)
from conservation_fem_tpu_torch.models import burgers as tburgers
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                 ShardedStructuredKPP,
                                                 shard_structured)
from conservation_fem_tpu_torch.utils.checkpoint import load_checkpoint
from torch_ranks import run_ranks

TOL = 1e-10
CASES = {
    "kpp_mesh4": ("kpp", dict(mesh_size=4, T=0.05)),
    "kpp_mesh3_uneven": ("kpp", dict(mesh_size=3, T=0.03)),
    "burgers_mesh12": ("burgers", dict(mesh_size=12, T=0.05)),
}
CONTINUE_FROM = 2      # steps JAX takes before the port continues
CKPT = dict(mesh_size=4, T=0.04)     # 4 steps, checkpoint at step 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(model, cfg):
    if model == "kpp":
        return tkpp.build(tkpp.KPPConfig(**cfg), device="cpu")
    return tburgers.build(tburgers.BurgersConfig(**cfg), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX sharded class on 8 virtual devices for CASES[name]: its
    geometry, its final u and, for Burgers, its carry after CONTINUE_FROM
    steps (global rows, flat). Built once per module."""
    model, cfg = CASES[name]
    devs = jax.devices()
    assert len(devs) >= 8
    if model == "kpp":
        p = jkpp.build(jkpp.KPPConfig(backend="stencil", **cfg))
    else:
        p = jburgers.build(jburgers.BurgersConfig(backend="stencil", **cfg))
    js = jax_shard(p, jax.sharding.Mesh(np.array(devs[:8]), ("i",)))
    carry = None
    if model == "burgers":
        c = js.run_chunk(js.init_carry(), 0, CONTINUE_FROM)
        carry = tuple(np.asarray(x)[:js.nx + 1].reshape(-1) for x in c)
    return dict(L=js.L, pad_rows=js.pad_rows, num_steps=p.num_steps,
                u=np.asarray(js.solve()), carry=carry)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_sharded_class(name):
    """LocalBlocks(8) against the JAX class on 8 devices: the same
    decomposition, the same trajectory."""
    model, cfg = CASES[name]
    ref = _jax(name)
    sh = ShardedStructuredKPP(_port(model, cfg), LocalBlocks(8, "cpu"))
    assert (sh.L, sh.pad_rows, sh.p.num_steps) == (
        ref["L"], ref["pad_rows"], ref["num_steps"])
    if name == "kpp_mesh3_uneven":
        assert sh.pad_rows > 0
    u = sh.solve()
    assert u.shape == (sh.n1x * sh.n1y,)
    np.testing.assert_allclose(u.numpy(), ref["u"], rtol=0, atol=TOL)
    assert np.abs(ref["u"] - sh.p.u0.numpy()).max() > 1e-3     # it moved


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_single_device(name, n):
    model, cfg = CASES[name]
    ref = _port(model, cfg).solve().u
    u = shard_structured(_port(model, cfg), LocalBlocks(n, "cpu")).solve()
    np.testing.assert_allclose(u.numpy(), ref.numpy(), rtol=0, atol=TOL)


def test_continues_a_jax_carry():
    """Burgers from JAX's carry after 2 steps, on 3 blocks: the remaining
    steps at their own times (their Dirichlet data) give JAX's end
    state."""
    model, cfg = CASES["burgers_mesh12"]
    ref = _jax("burgers_mesh12")
    sh = ShardedStructuredKPP(_port(model, cfg), LocalBlocks(3, "cpu"))
    sh.set_carry(*ref["carry"], start_step=CONTINUE_FROM)
    np.testing.assert_allclose(sh.solve().numpy(), ref["u"], rtol=0,
                               atol=TOL)
    assert np.abs(ref["carry"][0] - sh.p.u0.numpy()).max() > 1e-3


def test_padding_rows_never_reach_owned_rows():
    """13 rows over 8 blocks: whatever the 3 rows past the grid hold, the
    owned rows come out the same, bit for bit."""
    model, cfg = CASES["kpp_mesh3_uneven"]
    sh = ShardedStructuredKPP(_port(model, cfg), LocalBlocks(8, "cpu"))
    clean = sh.run_chunk(sh.init_carry(), 0, 2)
    rng = np.random.default_rng(0)
    dirty = []
    for x in sh.init_carry():
        x = x.clone().reshape(-1, sh.n1y)
        x[sh.n1x:] = torch.from_numpy(rng.uniform(-50, 50, x[sh.n1x:].shape))
        dirty.append(x.reshape(8, sh.L, sh.n1y))
    got = sh.run_chunk(tuple(dirty), 0, 2)
    for a, b in zip(got, clean):
        assert torch.equal(sh._to_global(a), sh._to_global(b))


@pytest.mark.parametrize("n", [4, 3])
def test_checkpoint_restores_across_block_counts(tmp_path, n):
    """Saved on LocalBlocks(8) at step 2, restored on n blocks: the rows
    bit-equal to the saved ones, re-padded, and the continuation bit-equal
    to one from an in-memory transfer of the same carry."""
    path = str(tmp_path / "ck")
    s8 = ShardedStructuredKPP(_port("kpp", CKPT), LocalBlocks(8, "cpu"))
    c8 = s8.run_chunk(s8.init_carry(), 0, 2)
    written = s8.save_carry(path, 2, c8)
    ck = load_checkpoint(written)
    assert ck.step == 2 and ck.t == 2 * s8.p.dt
    sn = ShardedStructuredKPP(_port("kpp", CKPT), LocalBlocks(n, "cpu"))
    step, cn = sn.restore_carry(path)
    assert step == 2
    for a, b in zip(cn, c8):
        assert a.shape == (n, sn.L, sn.n1y) and sn.L != s8.L
        assert torch.equal(sn._to_global(a), s8._to_global(b))
        assert not a.reshape(-1, sn.n1y)[sn.n1x:].any()     # re-padded
    direct = tuple(sn._from_global(s8._to_global(x)) for x in c8)
    u_resumed = sn.run_chunk(cn, 2, 2)[0]
    u_direct = sn.run_chunk(direct, 2, 2)[0]
    assert torch.equal(u_resumed, u_direct)


def test_solve_checkpointed_matches_solve(tmp_path):
    """Chunks of 2 with a snapshot after each against the plain solve, bit
    for bit; a resume from the midpoint snapshot reproduces it. The
    snapshot also resumes the single-device solve."""
    path = str(tmp_path / "ck2")
    sh = ShardedStructuredKPP(_port("kpp", CKPT), LocalBlocks(8, "cpu"))
    u_straight = sh.solve()
    u_chunked = sh.solve_checkpointed(path, every=2)
    assert torch.equal(u_chunked, u_straight)
    c_mid = sh.run_chunk(sh.init_carry(), 0, 2)
    sh.save_carry(path, 2, c_mid)
    assert torch.equal(sh.solve_checkpointed(path, every=2, resume=True),
                       u_chunked)
    sh.save_carry(path, 2, c_mid)
    single = _port("kpp", CKPT)
    u_single = single.solve(checkpoint_path=path, checkpoint_every=2,
                            resume=True).u
    np.testing.assert_allclose(u_single.numpy(), u_straight.numpy(), rtol=0,
                               atol=TOL)


def test_process_group_blocks_equal_local_blocks(tmp_path):
    """Two gloo ranks (tests/torch_ranks.py) against LocalBlocks(2), KPP
    mesh 4, bit for bit: the one-row halo and the reverse shipment between
    ranks, the dots gathered and added in block order."""
    model, cfg = CASES["kpp_mesh4"]
    got = run_ranks(tmp_path, "structured", (model, cfg))
    ref = ShardedStructuredKPP(_port(model, cfg),
                               LocalBlocks(2, "cpu")).solve().numpy()
    for u in got:
        assert np.array_equal(u, ref)


def test_from_previous_and_guards():
    """The reverse shipment of LocalBlocks; the problem's backend and the
    blocks' device are checked."""
    blocks = LocalBlocks(3, "cpu")
    x = torch.arange(6.0).reshape(3, 1, 2)
    assert torch.equal(blocks.from_previous(x, fill=-1.0),
                       torch.tensor([[[-1.0, -1.0]], [[0.0, 1.0]],
                                     [[2.0, 3.0]]]))
    p = _port("kpp", CASES["kpp_mesh4"][1])
    elsewhere = types.SimpleNamespace(device=torch.device("meta"), n_dev=2,
                                      ranks=(0, 1))
    with pytest.raises(ValueError, match="blocks on"):
        ShardedStructuredKPP(p, elsewhere)
    ell = tkpp.build(tkpp.KPPConfig(mesh_size=2, backend="ell"),
                     device="cpu")
    with pytest.raises(ValueError, match="stencil backend"):
        ShardedStructuredKPP(ell, LocalBlocks(2, "cpu"))
    sh = ShardedStructuredKPP(p, LocalBlocks(2, "cpu"))
    with pytest.raises(ValueError, match="fields"):
        sh.set_carry(p.u0, p.u0)
    with pytest.raises(ValueError, match="outside"):
        sh.run_chunk(sh.init_carry(), p.num_steps, 1)
