"""The sharded fused structured path of the port
(conservation_fem_tpu_torch/parallel) against the JAX package, f64, on the
CPU (the port's wrappers then run their plain versions).

Tolerances, all absolute on O(1-10) fields:
  * 1e-11 for a block step against the JAX block kernel in interpret mode,
    on the owned rows only (beyond the block's first and last row the TPU
    kernel reads rows that wrap around, the port reads nothing: both are
    garbage that never reaches the owned rows), and for every sharded solve
    against the JAX single-device fixed Chebyshev trajectory: the bound of
    the JAX package's own sharded identity tests
    (test_structured_fused_sharded.py); the port sums the same terms in
    another order;
  * exact (bit for bit) between LocalBlocks(2) and two gloo ranks: the same
    arithmetic on the same blocks, sums in the same order.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops import pallas_fused as jpf
from conservation_fem_tpu.parallel.structured_fused_sharded import (
    ShardedFusedStructured as JaxSharded)
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import fused_step as fs
from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                 ShardedFusedStructured,
                                                 shard_structured_fused)

TOL = 1e-11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHEBY = dict(modified_newton=True, inner_solver="cheby", cg_iters=10,
             newton_iters=2, newton_linear_iters=12)
TRIM = {**CHEBY, "cg_iters": 4, "newton_linear_iters": 4}
CASES = {
    # name: (KPPConfig arguments, blocks, ShardedFusedStructured arguments)
    "allgather_mesh6_x8": (dict(mesh_size=6, T=0.05, **CHEBY), 8, {}),
    "neighbours_mesh16_x2": (dict(mesh_size=16, T=0.03, **TRIM), 2, {}),
    "gfem_uneven_x3": (dict(mesh_size=4, T=0.04, stabilization="gfem",
                            **CHEBY), 3, {}),
    "tiled_mesh16_x2": (dict(mesh_size=16, T=0.02, **TRIM), 2,
                        dict(kernel="tiled", tile_rows=8)),
}


def _jax_trajectory(cfg, steps=None):
    """The JAX single-device fixed Chebyshev trajectory through the XLA
    step: the list of carries (u, u_old, u_old_old) after 0, 1, ... steps."""
    pj = jkpp.build(jkpp.KPPConfig(backend="stencil", **cfg))
    carry = (pj.u0,) * 3
    out = [carry]
    for k in range(pj.num_steps if steps is None else steps):
        (u, _, _), _ = pj.step(carry, jnp.asarray((k + 1.0) * pj.dt))
        carry = (u, carry[0], carry[1])
        out.append(carry)
    return pj, out


def test_required_halo_matches_jax():
    for cg in (0, 4, 10):
        for newton in (0, 1, 2, 3):
            for lin in (0, 4, 16):
                assert (fs.required_halo(cg, newton, lin)
                        == jpf.required_halo(cg, newton, lin))
    assert fs.required_halo(10, 2, 16) == 62


@pytest.mark.parametrize("block", [0, 2])
def test_block_step_matches_pallas_interpret(block):
    """One step of the first (rows above the grid) and the last (padding
    rows below it) of 3 uneven blocks at mesh 6, from a state two steps
    into the trajectory, against the JAX block kernel in interpret mode."""
    cfg = dict(mesh_size=6, T=0.05, **TRIM)
    pj, traj = _jax_trajectory(cfg, steps=2)
    pt = tkpp.build(tkpp.KPPConfig(**cfg), device="cpu")
    n1x, n1y = pt._shape2
    L = -(-n1x // 3)
    D = fs.required_halo(4, 2, 4)
    B, row0 = L + 2 * D, block * L - D
    assert L * 3 > n1x                                # uneven: padding rows

    def ext(a, planes=False):
        a = np.asarray(a).reshape((7, n1x, n1y) if planes else (n1x, n1y))
        pad = ((0, 0),) * planes + ((D, L * 3 - n1x + D), (0, 0))
        return np.pad(a, pad)[..., block * L:block * L + B, :]

    u, uo, uoo = (ext(c) for c in traj[-1])
    g = ext(np.full((n1x, n1y), np.pi / 4))
    Mc = ext(pt.sd.M_coef.numpy(), planes=True)
    un = np.asarray(traj[-1][0])
    abs_term = float(np.abs(un - un.mean()).max())
    kw = {k: v for k, v in pt.fused_step_kwargs().items()
          if k not in ("nx", "ny", "flux")}
    ref = jpf.fused_rv_block_step(
        *(jnp.asarray(a) for a in (u, uo, uoo, g, Mc)), row0, abs_term,
        n_rows=n1x, n_cols=n1y, fprime=jkpp.flux_prime,
        fprime_norm=jkpp.flux_prime_norm, fprime_xy=jkpp.flux_prime_xy,
        interpret=True, **kw)
    got = fs.fused_rv_block_step(
        *(torch.tensor(a) for a in (u, uo, uoo, g, Mc)), row0,
        torch.tensor([abs_term], dtype=torch.float64), n_rows=n1x, n_cols=n1y, flux=tkpp.FLUX,
        **kw)
    own = slice(D, D + min(L, n1x - block * L))
    np.testing.assert_allclose(got[own].numpy(), np.asarray(ref)[own],
                               rtol=0, atol=TOL)
    assert np.abs(got[own].numpy() - u[own]).max() > 1e-3   # it moved
    # rows outside the grid come back zero
    outside = np.ones(B, bool)
    outside[max(0, -row0):min(B, n1x - row0)] = False
    assert outside.any() and not got[outside].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_solve_matches_jax_single_device(name):
    """The whole sharded solve against the JAX fixed Chebyshev trajectory:
    a halo deeper than a block, a halo within a block, gfem on uneven
    blocks, and the tiled kernel's block mode."""
    cfg, n, extra = CASES[name]
    _, traj = _jax_trajectory(cfg)
    sh = ShardedFusedStructured(
        tkpp.build(tkpp.KPPConfig(**cfg), device="cpu"),
        LocalBlocks(n, "cpu"), **extra)
    if name == "allgather_mesh6_x8":
        assert sh.D > sh.L
    if name == "neighbours_mesh16_x2":
        assert sh.D <= sh.L and sh.kernel == "block"
    if name == "gfem_uneven_x3":
        assert sh.pad_rows > 0
    if name == "tiled_mesh16_x2":
        assert sh.kernel == "tiled" and sh.B > 8
    got = sh.solve()
    assert got.shape == (sh.n1x * sh.n1y,)
    np.testing.assert_allclose(got.numpy(), np.asarray(traj[-1][0]), rtol=0,
                               atol=TOL)


def test_sharded_solve_matches_jax_sharded_class():
    """The same configuration through the JAX ShardedFusedStructured on 8
    virtual devices (its all_gather exchange) and the port's 8 local
    blocks: same fields, same result."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 JAX devices")
    cfg = dict(mesh_size=6, T=0.02, **TRIM)
    js = JaxSharded(jkpp.build(jkpp.KPPConfig(backend="stencil", **cfg)),
                    jax.sharding.Mesh(np.array(devs[:8]), ("i",)))
    sh = shard_structured_fused(
        tkpp.build(tkpp.KPPConfig(**cfg), device="cpu"),
        LocalBlocks(8, "cpu"))
    for field in ("n_dev", "L", "D", "B", "pad_rows", "kernel"):
        assert getattr(sh, field) == getattr(js, field), field
    np.testing.assert_allclose(sh.solve().numpy(), np.asarray(js.solve()),
                               rtol=0, atol=TOL)


def test_set_carry_starts_from_a_jax_state():
    """Two more steps from a JAX state two steps into the trajectory."""
    cfg = dict(mesh_size=6, T=0.04, **TRIM)
    _, traj = _jax_trajectory(cfg)
    p = tkpp.build(tkpp.KPPConfig(**{**cfg, "T": 0.02}), device="cpu")
    sh = ShardedFusedStructured(p, LocalBlocks(3, "cpu"))
    sh.set_carry(*(np.asarray(c) for c in traj[2]))
    np.testing.assert_allclose(sh.solve().numpy(), np.asarray(traj[4][0]),
                               rtol=0, atol=TOL)
    # and not what a start from u0 gives
    fresh = ShardedFusedStructured(p, LocalBlocks(3, "cpu")).solve()
    assert (fresh - sh.solve()).abs().max() > 1e-3


def test_config_guard_and_auto_rule():
    p = tkpp.build(tkpp.KPPConfig(mesh_size=6), device="cpu")
    with pytest.raises(NotImplementedError):
        ShardedFusedStructured(p, LocalBlocks(2, "cpu"))
    for bad in (dict(inner_solver="bicgstab"), dict(cg_iters=None),
                dict(newton_iters=None)):
        q = tkpp.build(tkpp.KPPConfig(mesh_size=2, **{**CHEBY, **bad}),
                       device="cpu")
        with pytest.raises(NotImplementedError):
            ShardedFusedStructured(q, LocalBlocks(2, "cpu"))
    p = tkpp.build(tkpp.KPPConfig(mesh_size=2, **CHEBY), device="cpu")
    with pytest.raises(ValueError):
        ShardedFusedStructured(p, LocalBlocks(2, "cpu"), kernel="split")
    with pytest.raises(ValueError):
        LocalBlocks(0, "cpu")
    # the auto rule by bytes, as the JAX class states it: no problem is
    # built, the geometry is set on a bare object of each class
    probe = tkpp.build(tkpp.KPPConfig(mesh_size=2, dtype="float32",
                                      **{**CHEBY, "newton_linear_iters": 16}),
                       device="cpu")
    picks = {}
    for mesh in (64, 128, 256, 512):
        for n in (1, 2, 4, 8):
            n1 = 4 * mesh + 1
            probe.sd = probe.sd._replace(nx=n1 - 1, ny=n1 - 1)
            sh = ShardedFusedStructured.__new__(ShardedFusedStructured)
            sh.p, sh.blocks = probe, LocalBlocks(n, "cpu")
            sh._geometry("auto")
            L = -(-n1 // n)
            want = ("block" if (L + 2 * 62) * n1 * 4 <= 270 * 2**10
                    else "tiled")
            assert (sh.kernel, sh.L, sh.D, sh.B) == (want, L, 62, L + 124)
            picks[mesh, n] = sh.kernel
    assert picks[64, 4] == "block" and picks[64, 8] == "block"
    assert picks[64, 1] == "tiled" and picks[128, 4] == "tiled"
    assert picks[256, 4] == "tiled" and picks[512, 4] == "tiled"


def test_block_wrappers_refuse():
    """Block mode: Chebyshev only, abs_term for rv, the block's own
    columns; fewer than two rows of the grid in a block."""
    from conservation_fem_tpu_torch.ops import tiled_step as ts

    p = tkpp.build(tkpp.KPPConfig(mesh_size=2, **CHEBY), device="cpu")
    u2 = p.u0.reshape(p._shape2)
    args = (u2, u2, u2, u2, p.sd.M_coef)
    kw = {k: v for k, v in p.fused_step_kwargs().items()
          if k not in ("nx", "ny")}
    with pytest.raises(NotImplementedError, match="cheby"):
        fs.fused_rv_block_step(*args, 0, 1.0, n_rows=9, n_cols=9,
                               **dict(kw, inner_solver="bicgstab"))
    with pytest.raises(ValueError, match="abs_term"):
        fs.fused_rv_block_step(*args, 0, None, n_rows=9, n_cols=9, **kw)
    with pytest.raises(ValueError, match="n_cols"):
        fs.fused_rv_block_step(*args, 0, 1.0, n_rows=9, n_cols=8, **kw)
    with pytest.raises(ValueError, match="fewer than 2 rows"):
        fs.fused_rv_block_step(*args, -8, 1.0, n_rows=9, n_cols=9, **kw)
    with pytest.raises(ValueError, match="block mode"):
        ts.tiled_rv_step(*args, n_rows=9, **p.fused_step_kwargs())
    # gfem needs no abs_term, and block mode on the whole grid is the step
    gf = dict(kw, stabilization="gfem")
    whole = fs.fused_rv_step(*args, **dict(p.fused_step_kwargs(),
                                           stabilization="gfem"))[0]
    got = fs.fused_rv_block_step(*args, 0, None, n_rows=9, n_cols=9, **gf)
    torch.testing.assert_close(got, whole, rtol=0, atol=1e-13)
    got = ts.tiled_rv_step(*args, row0_base=0, n_rows=9, **gf)
    torch.testing.assert_close(got, whole, rtol=0, atol=1e-13)


_RANK_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, {repo!r})
    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.parallel import (
        ProcessGroupBlocks, ShardedFusedStructured)

    rank, world, store, out, cfg = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4],
                                    eval(sys.argv[5]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    sh = ShardedFusedStructured(
        kpp.build(kpp.KPPConfig(**cfg), device="cpu"),
        ProcessGroupBlocks(dist.group.WORLD))
    np.save(out, sh.solve().numpy())
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("trim", [True, False])
def test_process_group_blocks_equal_local_blocks(tmp_path, trim):
    """Two gloo ranks (subprocesses, file-store rendezvous) against
    LocalBlocks(2) at mesh 16, bit for bit: the neighbour exchange (trimmed
    counts, D <= L) and the all_gather one (D > L). Each rank runs under a
    hard time limit and is killed when it expires."""
    cfg = dict(mesh_size=16, T=0.02, **(TRIM if trim else CHEBY))
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT.format(repo=REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp_path / "store"),
         str(tmp_path / f"u{r}.npy"), repr(cfg)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=120)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert [proc.returncode for proc in procs] == [0, 0], "\n".join(logs)
    sh = ShardedFusedStructured(
        tkpp.build(tkpp.KPPConfig(**cfg), device="cpu"),
        LocalBlocks(2, "cpu"))
    assert (sh.D <= sh.L) == trim
    ref = sh.solve().numpy()
    for r in range(2):
        assert np.array_equal(np.load(tmp_path / f"u{r}.npy"), ref)
