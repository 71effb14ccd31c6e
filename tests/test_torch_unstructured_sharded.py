"""The port's distributed unstructured solvers (conservation_fem_tpu_torch/
parallel/unstructured_sharded.py) against the JAX package's classes of the
same names on the 8 virtual CPU devices of tests/conftest.py, and against
the port's own single-device paths, f64, on the CPU, with the JAX
package's own meshes and tolerances (tests/test_unstructured_sharded.py):

  * against the JAX classes on LocalBlocks(8), each JAX run built once for
    the module: the sharded SpMV on disk_mesh(1/8) (1e-13), the
    distributed Poisson demo (1e-10), DistributedKPP on the [-2,2]^2
    rectangle nx 11 (1e-10), Burgers SI with l = 4 smoothing on the unit
    square nx 12 (1e-9), advection rv_cell at mesh 8 (1e-9);
  * against the port's single-device paths on 1, 3 and 8 blocks (1e-10
    KPP, 1e-9 the rest, as the JAX package's): Burgers RV with time-dependent Dirichlet data,
    the bump Burgers with BDF1, KPP SI, advection rv_node, si, rk4 and
    gfem;
  * noise in the pad rows (the carry's, the points', the mass's, nodal
    h's) leaves the owned rows' bits unchanged;
  * two gloo ranks of ProcessGroupBlocks bit for bit against
    LocalBlocks(2).

The tolerances are absolute on O(1) fields: the dots and the assembly sums
of the blocks are reduced in another order than on one device.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import burgers as jburgers
from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.models import linear_advection as jadv
from conservation_fem_tpu.ops import assembly as jasm
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.parallel import partition as jpart
from conservation_fem_tpu.parallel import unstructured_sharded as jus
from conservation_fem_tpu_torch.models import burgers as tburgers
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.models import linear_advection as tadv
from conservation_fem_tpu_torch.ops import assembly as tasm
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.parallel import (
    DistributedAdvection, DistributedELL, DistributedHyperbolic,
    DistributedKPP, LocalBlocks, build_partition, distributed_poisson_demo)
from torch_ranks import run_ranks

KPP_RECT = dict(p0=(-2, -2), p1=(2, 2), nx=11)
UNIT12 = dict(p0=(0, 0), p1=(1, 1), nx=12)
# name: (model, config, mesh of rectangle_mesh or None, tolerance)
RUNS = {
    "kpp_rv": ("kpp", dict(mesh_size=11, T=0.03, backend="ell"), KPP_RECT,
               1e-10),
    "kpp_si": ("kpp", dict(mesh_size=11, T=0.03, backend="ell",
                           stabilization="si"), KPP_RECT, 1e-10),
    "burgers_rv_timedep": ("burgers", dict(mesh_size=12, T=0.03,
                                           backend="ell"), UNIT12, 1e-9),
    "burgers_si_smooth": ("burgers", dict(mesh_size=12, T=0.03,
                                          backend="ell", stabilization="si",
                                          smooth_l=4.0), UNIT12, 1e-9),
    "burgers_bump_bdf1": ("burgers", dict(mesh_size=12, T=0.03,
                                          backend="ell", ic="bump",
                                          residual_scheme="bdf1"), UNIT12,
                          1e-9),
    "advection_rv_node": ("advection", dict(mesh_size=8, T=0.02,
                                            stabilization="rv_node"), None,
                          1e-9),
    "advection_si": ("advection", dict(mesh_size=8, T=0.02,
                                       stabilization="si"), None, 1e-9),
    "advection_rk4": ("advection", dict(mesh_size=8, T=0.02,
                                        stabilization="rk4"), None, 1e-9),
    "advection_gfem": ("advection", dict(mesh_size=8, T=0.02,
                                         stabilization="gfem"), None, 1e-9),
    "advection_rv_cell": ("advection", dict(mesh_size=8, T=0.02,
                                            stabilization="rv_cell",
                                            rv_cell_scatter="max"), None,
                          1e-9),
}
AGAINST_JAX = ("kpp_rv", "burgers_si_smooth", "advection_rv_cell")
AGAINST_SINGLE = ("burgers_rv_timedep", "burgers_bump_bdf1", "kpp_si",
                  "advection_rv_node", "advection_si", "advection_rk4",
                  "advection_gfem")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_mesh():
    devs = jax.devices()
    assert len(devs) >= 8
    return jax.sharding.Mesh(np.array(devs[:8]), ("i",))


def _port_problem(name):
    model, cfg, rect, _ = RUNS[name]
    if model == "advection":
        return tadv.build(tadv.AdvectionConfig(**cfg), device="cpu")
    m = tmesh.rectangle_mesh(**rect)
    if model == "kpp":
        return tkpp.build(tkpp.KPPConfig(**cfg), device="cpu", host_mesh=m)
    return tburgers.build(tburgers.BurgersConfig(**cfg), device="cpu",
                          host_mesh=m)


def _port_distributed(name, blocks):
    cls = dict(kpp=DistributedKPP, burgers=DistributedHyperbolic,
               advection=DistributedAdvection)[RUNS[name][0]]
    return cls(_port_problem(name), blocks)


def _port_single(name):
    p = _port_problem(name)
    if RUNS[name][0] == "advection":
        return tadv.solve(p).u
    return p.solve().u


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX class's end state for RUNS[name] on 8 devices (once per
    module)."""
    model, cfg, rect, _ = RUNS[name]
    dm = _jax_mesh()
    if model == "advection":
        cfg = {k: v for k, v in cfg.items() if k != "rv_cell_scatter"}
        p = jadv.build(jadv.AdvectionConfig(**cfg))
        return jus.DistributedAdvection(
            jadv.build(jadv.AdvectionConfig(**cfg), host_mesh=p.host_mesh),
            dm).solve()
    m = jmesh.rectangle_mesh(**rect)
    if model == "kpp":
        return jus.DistributedKPP(jkpp.build(jkpp.KPPConfig(**cfg),
                                             host_mesh=m), dm).solve()
    return jus.DistributedHyperbolic(
        jburgers.build(jburgers.BurgersConfig(**cfg), host_mesh=m),
        dm).solve()


def test_sharded_spmv_matches_jax():
    mesh_j, mesh_t = jmesh.disk_mesh(1 / 8), tmesh.disk_mesh(1 / 8)
    pj = jpart.build_partition(mesh_j, 8)
    dj = jus.DistributedELL(pj, _jax_mesh())
    mj = pj.mesh.device_arrays(jax.numpy.float64)
    Kj = jasm.assemble_stiffness(mj)
    x = np.random.default_rng(0).normal(size=pj.mesh.n_nodes)
    pad = pj.n_total - pj.mesh.n_nodes
    A_rows = jax.device_put(jax.numpy.concatenate(
        [Kj, jax.numpy.zeros((pad, pj.mesh.max_patch), Kj.dtype)]),
        dj.shard)
    # jitted: eager shard_map dispatches op by op
    ref = dj.unpad_rows(jax.jit(dj.sharded_spmv)(A_rows, dj.pad_rows(x)))

    pt = build_partition(mesh_t, 8)
    dt = DistributedELL(pt, LocalBlocks(8, "cpu"))
    Kt = tasm.assemble_stiffness(pt.mesh.device_arrays(torch.float64, "cpu"))
    y = dt.unpad_rows(dt.sharded_spmv(dt.pad_ell(Kt),
                                      dt.pad_rows(torch.tensor(x))))
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-13)


def _jax_poisson_demo(mesh):
    """conservation_fem_tpu.parallel.unstructured_sharded.
    distributed_poisson_demo's steps, its sharded CG jitted (eager
    shard_map dispatches op by op, ~15 s here): (data g, solution x) in
    the RCM order."""
    from conservation_fem_tpu.ops.spmv import ell_diag, ell_matvec

    jnp = jax.numpy
    dm = _jax_mesh()
    part = jpart.build_partition(mesh, 8)
    m = part.mesh.device_arrays(jnp.float64)
    K = jasm.assemble_stiffness(m)
    dist = jus.DistributedELL(part, dm)
    pad = part.n_total - part.mesh.n_nodes
    A_rows = jax.device_put(
        jnp.concatenate([K, jnp.zeros((pad, part.mesh.max_patch), K.dtype)]),
        dist.shard)
    bc = m.boundary_mask
    g = m.points[:, 0] ** 2 - m.points[:, 1] ** 2
    b = jnp.where(bc, g, -ell_matvec(m, K, jnp.where(bc, g, 0.0)))
    bc_rows = jax.device_put(jnp.concatenate([bc, jnp.zeros(pad, bool)]),
                             jax.sharding.NamedSharding(
                                 dm, jax.sharding.PartitionSpec("i")))
    x = jax.jit(dist.solve_cg)(A_rows, dist.pad_rows(b), bc_rows,
                               dist.pad_rows(ell_diag(m, K)))
    return np.asarray(g), dist.unpad_rows(x)


def test_poisson_demo_matches_jax():
    gj, xj = _jax_poisson_demo(jmesh.disk_mesh(1 / 8))
    mesh, x, g = distributed_poisson_demo(tmesh.disk_mesh(1 / 8),
                                          LocalBlocks(8, "cpu"))
    assert mesh.n_nodes == x.numel() == len(xj)
    np.testing.assert_array_equal(g.numpy(), gj)
    np.testing.assert_allclose(x.numpy(), xj, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", AGAINST_JAX)
def test_matches_jax_distributed_class(name):
    ref = _jax_run(name)
    d = _port_distributed(name, LocalBlocks(8, "cpu"))
    u = d.solve()
    assert u.shape == (d.n,)
    np.testing.assert_allclose(u.numpy(), ref, rtol=0, atol=RUNS[name][3])
    assert np.abs(ref - d.p.u0.numpy()).max() > 1e-3      # it moved


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("name", AGAINST_SINGLE)
def test_matches_single_device(name, n):
    ref = _port_single(name)
    u = _port_distributed(name, LocalBlocks(n, "cpu")).solve()
    np.testing.assert_allclose(u.numpy(), ref.numpy(), rtol=0,
                               atol=RUNS[name][3])


@pytest.mark.parametrize("name", ["burgers_rv_timedep", "advection_si"])
def test_pad_rows_never_reach_owned_rows(name):
    """Three blocks of the nx 12 square (169 nodes) or the mesh-8 disk
    leave pad rows in the last block; noise written into them leaves the
    owned rows' bits unchanged."""
    clean = _port_distributed(name, LocalBlocks(3, "cpu"))
    d = _port_distributed(name, LocalBlocks(3, "cpu"))
    pad = ~d.row_valid
    assert pad.any()
    g = torch.Generator().manual_seed(0)
    for field in ("u0_rows", "pts_rows", "M_rows", "h_rows"):
        x = getattr(d, field).clone()
        x[pad] = torch.randn(x[pad].shape, generator=g, dtype=x.dtype)
        setattr(d, field, x)
    assert torch.equal(d.solve(), clean.solve())


def test_blocks_on_another_device_raise():
    with pytest.raises(ValueError):
        _port_distributed("kpp_rv", LocalBlocks(2, "meta"))


def test_process_group_blocks_equal_local_blocks(tmp_path):
    """DistributedKPP at nx 11 on two gloo ranks against LocalBlocks(2):
    the same blocks and the same sums in the same order, bit for bit."""
    local = _port_distributed("kpp_rv", LocalBlocks(2, "cpu")).solve()
    model, cfg, rect, _ = RUNS["kpp_rv"]
    got = run_ranks(tmp_path, "unstructured", (model, cfg, rect))
    for u in got:
        np.testing.assert_array_equal(u, local.numpy())
