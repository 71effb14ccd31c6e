"""The port's sharded blocked solver (conservation_fem_tpu_torch/parallel/
blocked_sharded.py, DistributedBlocked) against the JAX package's class of
the same name on its 8 virtual CPU devices and against the port's own
single-device blocked run, f64 unless said, on the CPU (the ELL kernels'
plain versions). Tolerances, absolute on O(1) fields:

  * bit for bit: one product (kernel A), one Jacobian assembly from the
    Newton locals (kernels C and B), one N(u) + K_eps u (C and B) and one
    RV eps (D) of 3 blocks against the single-device plan's rows: each own
    row's block plan lists the same entries and contributions in the same
    order;
  * 1e-9 against the JAX class (its own gate, tests/test_blocked_sharded.py)
    on KPP mesh 8: rv on 4 blocks, si with l = 2 smoothing on 2, 8 blocks
    with padding-only blocks, the fixed Chebyshev configuration, the
    matrix-free Newton, and blocked2d on the tiled irregular nx 60 mesh of
    the JAX dry run's path 13;
  * 1e-10 against the port's single-device blocked run on 1, 3 and 8
    blocks (the dots and the mean are the only sums taken in another
    order);
  * 1e-5 for the f32 precise_reductions configuration of the JAX dry run's
    path 12 against the port's single-device f32 run (f64-accumulated dots
    and mean on both sides);
  * the refusal of a halo deeper than a block's rows, with the JAX
    twin's message, and of a problem off the blocked backends;
  * two gloo ranks of ProcessGroupBlocks bit for bit against
    LocalBlocks(2).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops.mesh import irregular_mesh as j_irregular
from conservation_fem_tpu.ops.tiling import tile_mesh as j_tile_mesh
from conservation_fem_tpu.parallel.blocked_sharded import \
    DistributedBlocked as JaxBlocked
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import blocked
from conservation_fem_tpu_torch.ops import ell_kernels as ek
from conservation_fem_tpu_torch.ops.mesh import irregular_mesh
from conservation_fem_tpu_torch.ops.tiling import tile_mesh
from conservation_fem_tpu_torch.parallel import DistributedBlocked, LocalBlocks
from torch_ranks import run_ranks

BASE = dict(mesh_size=8, T=0.05, backend="ell", ell_matvec_backend="blocked")
CHEBY = dict(modified_newton=True, cg_iters=10, newton_iters=2,
             newton_linear_iters=16, inner_solver="cheby")
TILED = dict(dtype="float64", dt=0.005, T=0.02, backend="ell",
             ell_matvec_backend="blocked2d", krylov_rtol=1e-10)
# name: (KPPConfig arguments, blocks)
AGAINST_JAX = {
    "rv_x4": (BASE, 4),
    "si_smooth_x2": ({**BASE, "stabilization": "si", "smooth_l": 2.0}, 2),
    "padding_x8": (BASE, 8),
    "cheby_x4": ({**BASE, **CHEBY}, 4),
    "matrix_free_x4": ({**BASE, "blocked_matrix_free": True}, 4),
    "blocked2d_x4": (TILED, 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _tiled_meshes():
    """The path-13 mesh, tiled, in both packages."""
    return (tile_mesh(irregular_mesh((-2, -2), (2, 2), nx=60, seed=1))[0],
            j_tile_mesh(j_irregular((-2, -2), (2, 2), nx=60, seed=1))[0])


def _port(cfg):
    mesh = (_tiled_meshes()[0] if cfg["ell_matvec_backend"] == "blocked2d"
            else None)
    return tkpp.build(tkpp.KPPConfig(**cfg), device="cpu", host_mesh=mesh)


def _jax_twin(cfg, n):
    mesh = (_tiled_meshes()[1] if cfg["ell_matvec_backend"] == "blocked2d"
            else None)
    dm = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("i",))
    return JaxBlocked(jkpp.build(jkpp.KPPConfig(**cfg), host_mesh=mesh), dm)


@pytest.mark.parametrize("name", sorted(AGAINST_JAX))
def test_twin_matches_jax_twin(name):
    cfg, n = AGAINST_JAX[name]
    js = _jax_twin(cfg, n)
    sh = DistributedBlocked(_port(cfg), LocalBlocks(n, "cpu"))
    assert (sh.L, sh.H, sh.blocks_pad) == (js.rows_local, js.halo,
                                           js.blocks_pad)
    if name == "padding_x8":
        assert sh.blocks_pad > sh.n_blocks
    np.testing.assert_allclose(sh.solve().numpy(), js.solve(), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_twin_matches_single_device(n):
    single = _port(BASE).solve().u
    got = DistributedBlocked(_port(BASE), LocalBlocks(n, "cpu")).solve()
    assert got.shape == single.shape
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0,
                               atol=1e-10)


def test_block_operations_bit_equal_single_device():
    """The kernels on the block plans of 3 blocks give the single-device
    plan's rows bit for bit."""
    p = _port({**BASE, "dt": 0.01})
    sh = DistributedBlocked(_port({**BASE, "dt": 0.01}), LocalBlocks(3,
                                                                     "cpu"))
    plan, bp, n = p.plan, sh.bp, p.plan.n
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.uniform(0.5, 3.0, n))
    eps = torch.from_numpy(rng.uniform(0.0, 0.1, n))
    Rh = torch.from_numpy(rng.standard_normal(n))
    ue, ee = sh.extend(sh.own(u)), sh.extend(sh.own(eps))
    rows = lambda y: sh.gather(sh.cut(y))
    # kernel A
    assert torch.equal(rows(blocked.spmv(bp, sh.M, ue)),
                       blocked.spmv(plan, p.M, u))
    # kernels C and B: N(u) + K_eps u and the CN Jacobian
    assert torch.equal(
        rows(blocked.conv_plus_locals_rhs_components(bp, ue, p.flux, ee)),
        blocked.conv_plus_locals_rhs_components(plan, u, p.flux, eps))
    J = blocked.assemble_matrix(bp, blocked.newton_locals(bp, ue, ee, 0.005,
                                                          p.flux))
    J1 = blocked.assemble_matrix(plan, blocked.newton_locals(
        plan, u, eps, 0.005, p.flux))
    got = sh.blocks.gather(sh.cut(J)).reshape(-1, J.shape[1])[:n]
    assert torch.equal(got, J1)
    # kernel D, given the same global term
    term = torch.tensor(0.75, dtype=torch.float64)
    e_blk = ek.ell_rv_epsilon(bp.mesh, 0.5, 4.0, ue, sh.extend(sh.own(Rh)),
                              ue, sh.h_ext, term, p.flux, sh.valid_ext)
    e_one = ek.ell_rv_epsilon(plan.mesh, 0.5, 4.0, u, Rh, u, p.h_cg, term,
                              p.flux)
    assert torch.equal(rows(e_blk), e_one)


def test_precise_reductions_f32_matches_single_device():
    """The JAX dry run's path 12: f32, fixed counts, BiCGStab dots, with
    precise_reductions on both sides."""
    cfg = dict(mesh_size=8, dtype="float32", T=0.05, backend="ell",
               ell_matvec_backend="blocked", modified_newton=True,
               cg_iters=6, newton_iters=2, newton_linear_iters=4,
               inner_solver="bicgstab", precise_reductions=True)
    single = _port(cfg).solve().u
    got = DistributedBlocked(_port(cfg), LocalBlocks(8, "cpu")).solve()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0,
                               atol=1e-5)


def test_halo_deeper_than_a_block_is_refused():
    """The tiled plan's halo (T + k) nb exceeds the rows of 8 blocks."""
    p = _port(TILED)
    with pytest.raises(ValueError, match="window halo"):
        DistributedBlocked(p, LocalBlocks(8, "cpu"))
    with pytest.raises(ValueError, match="blocked"):
        DistributedBlocked(tkpp.build(tkpp.KPPConfig(mesh_size=4, T=0.02,
                                                     backend="ell"),
                                      device="cpu"), LocalBlocks(2, "cpu"))


def test_process_group_blocks_equal_local_blocks(tmp_path):
    cfg = {**BASE, "T": 0.02}
    local = DistributedBlocked(_port(cfg), LocalBlocks(2, "cpu")).solve()
    for r in run_ranks(tmp_path, "blocked", (cfg,)):
        np.testing.assert_array_equal(r, local.numpy())
