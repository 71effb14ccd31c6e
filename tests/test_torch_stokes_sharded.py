"""The port's row-sharded IPCS Stokes solver (conservation_fem_tpu_torch/
parallel/stokes_sharded.py, ShardedStokes) and ``backend="grid"`` against
the JAX package's on its 8 virtual CPU devices, f64, on the CPU, with the
JAX package's own configurations (fewer steps) and gate
(tests/test_stokes_sharded.py), 1e-9 absolute on u and p:

  * ShardedStokes against the JAX class: nx 10 on 4 and 8 blocks and
    multigrid nx 16 on 8 (a stencil level in the momentum hierarchy, the
    pressure's dense only), each JAX run once for the module on the JAX
    devices given (its result does not depend on them beyond roundoff: the
    JAX package's own sharded gate); fixed krylov_iters on 4 blocks, nx 7
    over 3 blocks (uneven rows) and multigrid nx 8 on 4 (both hierarchies
    dense only) against the port's single-device solver of the same
    configuration, itself held to the JAX package's by
    tests/test_torch_stokes.py (three more JAX compiles would cost ~30 s
    of the tier-1 budget);
  * the multigrid hierarchy's refusal of a large even-sized grid;
  * stokes.solve(backend="grid") against the JAX class's run of the same
    configuration (the JAX grid backend is that class on one device) and
    the port's lattice backend, with and without multigrid;
  * two gloo ranks of ProcessGroupBlocks bit for bit against
    LocalBlocks(2).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import stokes as jstokes
from conservation_fem_tpu.parallel.stokes_sharded import \
    ShardedStokes as JaxStokes
from conservation_fem_tpu_torch.models import stokes as tstokes
from conservation_fem_tpu_torch.parallel import LocalBlocks, ShardedStokes
from torch_ranks import run_ranks

NX10 = dict(nx=10, num_steps=10, T=0.2)
MG = dict(backend="lattice", multigrid=True)
# the JAX runs: name -> (StokesConfig arguments, JAX devices)
JAX_RUNS = {
    "nx10": (NX10, 4),
    "multigrid_nx16": (dict(nx=16, num_steps=6, T=0.12, **MG), 8),
}
# case: (JAX run, blocks, (momentum, pressure) level-0 arrays on the
# blocks)
AGAINST_JAX = {
    "nx10_x4": ("nx10", 4, (0, 0)),
    "nx10_x8": ("nx10", 8, (0, 0)),
    "multigrid_nx16_x8": ("multigrid_nx16", 8, (5, 0)),
}
# case: (StokesConfig arguments, blocks, level-0 arrays on the blocks)
AGAINST_SINGLE = {
    "fixed_x4": ({**NX10, "krylov_iters": 20}, 4, (0, 0)),
    "uneven_nx7_x3": (dict(nx=7, num_steps=10, T=0.2), 3, (0, 0)),
    "dense_only_nx8_x4": (dict(nx=8, num_steps=6, T=0.12, **MG), 4, (0, 0)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _dmesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("i",))


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """((u, p) of the JAX class, its level-0 array counts), once."""
    cfg, n = JAX_RUNS[name]
    js = JaxStokes(*jstokes.build(**cfg), _dmesh(n))
    return js.solve(), (js._mg1_n, js._mg2_n)


@pytest.mark.parametrize("name", sorted(AGAINST_JAX))
def test_sharded_stokes_matches_jax_twin(name):
    run, n, mg = AGAINST_JAX[name]
    (u_ref, p_ref), jax_mg = _jax_run(run)
    sh = ShardedStokes(*tstokes.build(device="cpu", **JAX_RUNS[run][0]),
                       LocalBlocks(n, "cpu"))
    assert (sh._mg1_n, sh._mg2_n) == jax_mg == mg
    u, p = sh.solve()
    np.testing.assert_allclose(u.numpy(), u_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", sorted(AGAINST_SINGLE))
def test_sharded_stokes_matches_single_device(name):
    cfg, n, mg = AGAINST_SINGLE[name]
    ref = tstokes.solve(tstokes.build(device="cpu", **cfg))
    sh = ShardedStokes(*tstokes.build(device="cpu", **cfg),
                       LocalBlocks(n, "cpu"))
    assert (sh._mg1_n, sh._mg2_n) == mg
    u, p = sh.solve()
    np.testing.assert_allclose(u.numpy(), ref.u.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(p.numpy(), ref.p.numpy(), rtol=0, atol=1e-9)


def test_multigrid_dense_degeneration_guard():
    p, fd = tstokes.build(device="cpu", nx=63, num_steps=1, **MG)
    with pytest.raises(ValueError, match="dense-solve limit"):
        ShardedStokes(p, fd, LocalBlocks(4, "cpu"))


@pytest.mark.parametrize("run", ["nx10", "multigrid_nx16"])
def test_backend_grid_matches_jax_and_lattice(run):
    cfg = dict(JAX_RUNS[run][0], backend="grid")
    grid = tstokes.solve(tstokes.build(device="cpu", **cfg))
    lattice = tstokes.solve(tstokes.build(device="cpu",
                                          **{**cfg, "backend": "lattice"}))
    (u_ref, p_ref), _ = _jax_run(run)
    for got, want in ((grid.u, u_ref), (grid.p, p_ref), (grid.u, lattice.u),
                      (grid.p, lattice.p)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-9)
    assert abs(grid.error_l2 - lattice.error_l2) < 1e-9


def test_process_group_blocks_equal_local_blocks(tmp_path):
    cfg = dict(nx=7, num_steps=4, T=0.08)
    u, p = ShardedStokes(*tstokes.build(device="cpu", **cfg),
                         LocalBlocks(2, "cpu")).solve()
    local = torch.cat([u.reshape(-1), p]).numpy()
    for r in run_ranks(tmp_path, "stokes", (cfg,)):
        np.testing.assert_array_equal(r, local)
