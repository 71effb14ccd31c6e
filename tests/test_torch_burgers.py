"""The port's Burgers P1 model (conservation_fem_tpu_torch/models/burgers.py)
against the JAX package, f64, on the CPU: the initial and exact
solutions, dt and the step count, the reference config's trajectory and
errors, the fixed-iteration config through the whole-step dispatch, a JAX
state carried across, the CLI and the unported options (the step kernels'
plain versions and the sharded path: test_torch_burgers_step.py).

Tolerances, absolute on O(1) fields unless stated:
  * 1e-11 for trajectories and errors against the exact solution: the
    bound of the JAX package's own fused-vs-XLA identity tests
    (test_pallas_fused.py); the port sums the same terms in another order;
  * 1e-15 (or equal) for the initial and exact solutions, which the two
    packages evaluate with the same operations in the same order;
  * the projected nodal h, which sets dt = CFL min h and the step count:
    the step count equal to JAX's at every size, min h within 1e-14
    relative of JAX's at N <= 50 and within 5e-14 at N = 100..800. The
    projection converges in one CG iteration whose step length is a ratio
    of two dot products over (N + 1)^2 nodes; the two packages sum them in
    other orders, which moves min h by ~N ulps of it.
Meshes stay at 16 or less, apart from the nodal h of the larger sizes, a
setup quantity. The cost here is the JAX side's compiles (~4.5 s for each
step program, as much again for the eager ops of a build at a new mesh
size), so every JAX model runs at mesh 12: one build's compiles serve
them all.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import burgers as jb
from conservation_fem_tpu.ops.helpers import get_nodal_h as jget_nodal_h
from conservation_fem_tpu.ops.mesh import rectangle_mesh as jrect
from conservation_fem_tpu_torch import __main__ as tmain
from conservation_fem_tpu_torch.models import burgers as tb
from conservation_fem_tpu_torch.models.scalar_hyperbolic import (
    HyperbolicConfig, check_supported)
from conservation_fem_tpu_torch.ops.mesh import (rectangle_cell_sizes,
                                                 rectangle_mesh_lean)
from conservation_fem_tpu_torch.ops.mesh import \
    rectangle_mesh as trectangle_mesh

TOL = 1e-11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's dt at sizes whose JAX build costs more than a test
# should: burgers.build(BurgersConfig(mesh_size=N)).dt, f64 on the CPU
JAX_DT = {50: 0.009999999999999964, 100: 0.0049999999999999585,
          200: 0.0024999999999999567, 400: 0.0012499999999999731,
          800: 0.0006249999999999866}
# the reference config (adaptive solvers, exact Newton) at mesh 12: 13
# steps to T = 0.5; SI with the l = 4 smoothing (Exact_Burger_SI.py) on
# both backends, RV on the ELL backend
REFERENCE = {"rv": dict(), "gfem": dict(stabilization="gfem"),
             "bdf1_bump": dict(residual_scheme="bdf1", ic="bump"),
             "si_l4": dict(stabilization="si", smooth_l=4.0),
             "si_l4_ell": dict(stabilization="si", smooth_l=4.0,
                               backend="ell"),
             "rv_ell": dict(backend="ell")}
# the fixed-iteration config of the JAX fused-kernel test
# (test_pallas_fused.py:test_fused_burgers_solve_matches_plain), there at
# mesh 16, here at 12 (3 steps to T 0.1)
FIXED = dict(mesh_size=12, T=0.1, stabilization="rv", cg_iters=10,
             newton_iters=2, newton_linear_iters=8, modified_newton=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these grids are small, and the test run shares
    the cores among several pytest worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _band_points(rng):
    """Points on every band edge and dividing line of the exact solution at
    the times used below, plus the IC's quadrant edges and random points."""
    xs, ys = [rng.uniform(0, 1, 64)], [rng.uniform(0, 1, 64)]
    for t in (0.05, 0.25, 0.5):
        for x in (0.5 - 0.6 * t, 0.5 - 0.25 * t, 0.5 + 0.5 * t,
                  0.5 + 0.8 * t, 0.5):
            xs.append(np.full(8, x))
            ys.append(rng.uniform(0, 1, 8))
        x = rng.uniform(0, 1, 8)
        for y in (0.5 + 0.15 * t + 0 * x,
                  -8.0 * x / 7.0 + 15.0 / 14.0 - 15.0 * t / 28.0,
                  x / 6.0 + 5.0 / 12.0 - 5.0 * t / 24.0,
                  x - 5.0 / (18.0 * t) * (x + t - 0.5) ** 2,
                  0.5 - 0.1 * t + 0 * x):
            xs.append(x)
            ys.append(y)
    xs.append(rng.uniform(0, 1, 8))
    ys.append(np.full(8, 0.5))
    return np.concatenate(xs), np.concatenate(ys)


def test_initial_and_exact_solution_match_jax():
    """Against the JAX functions, jitted (one compile instead of one per
    operation; the same values as eager here)."""
    x, y = _band_points(np.random.default_rng(7))
    exact = jax.jit(jb.exact_solution)
    tx, ty = torch.tensor(x), torch.tensor(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_array_equal(tb.initial_condition(tx, ty).numpy(),
                                  np.asarray(jb.initial_condition(jx, jy)))
    # the bump's cos may round differently in the two libraries
    np.testing.assert_allclose(tb.initial_condition_bump(tx, ty).numpy(),
                               np.asarray(jb.initial_condition_bump(jx, jy)),
                               rtol=0, atol=1e-15)
    for t in (0.0, 0.05, 0.25, 0.5):
        got = tb.exact_solution(tx, ty, t).numpy()
        ref = np.asarray(exact(jx, jy, t))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    # f32 fields cast t to f32 first, as the JAX function does
    got = tb.exact_solution(tx.float(), ty.float(), 0.25).numpy()
    ref = np.asarray(exact(jx.astype(jnp.float32), jy.astype(jnp.float32),
                           0.25))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("N", [8, 16])
def test_time_step_matches_jax(N):
    """dt = CFL min(h_CG) and ceil(T / dt) steps, live against the JAX
    package's get_nodal_h on its mesh (jitted: one compile per size
    instead of one per operation; mesh 12 is held to burgers.build's own
    dt in test_reference_config_matches_jax). N steps: N is a power of
    two. The cells' sizes that build takes from its rectangle_mesh are
    those rectangle_cell_sizes gives the lean mesh at N >= 512."""
    m = jrect((0, 0), (1, 1), nx=N).device_arrays(jnp.float64)
    dt = 0.5 * float(jax.jit(jget_nodal_h)(m).min())
    pt = tb.build(tb.BurgersConfig(mesh_size=N), device="cpu")
    assert pt.num_steps == int(np.ceil(0.5 / dt)) == N
    assert abs(pt.dt - dt) <= 1e-14 * dt
    for a, b in zip(rectangle_cell_sizes((0, 0), (1, 1), nx=N),
                    (pt.host_mesh.h_cell, pt.host_mesh.area)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("N", sorted(JAX_DT))
def test_time_step_matches_jax_at_reference_sizes(N):
    """N + 1 steps: h_CG lies a few 1e-15 below 1/N. Through the lean
    mesh and every cell's size, as build takes them at N >= 512."""
    mesh = rectangle_mesh_lean((0, 0), (1, 1), nx=N)
    cells = rectangle_cell_sizes((0, 0), (1, 1), nx=N)
    dt, steps = tb.time_step(tb.BurgersConfig(mesh_size=N),
                             tb.stencil_min_h(mesh, N, cells))
    assert steps == int(np.ceil(0.5 / JAX_DT[N])) == N + 1
    assert abs(dt - JAX_DT[N]) <= (1e-14 if N <= 50 else 5e-14) * JAX_DT[N]


@pytest.mark.parametrize("N", [8, 12, 16, 20, 32])
def test_f32_ell_step_count_matches_jax(N):
    """burgers.build(..., host_mesh=rectangle_mesh(N)) in f32 projects
    min h_CG through the ELL mass (ell_min_h): the JAX package's f32
    projection lands a few ulps below 1/N and takes N + 1 steps. The row
    sums of the ELL products must run in JAX's slot order for the port's
    to land there too (ops/spmv.ell_matvec; a tree-ordered f32 row sum
    lands on 1/N at N = 8, 16 and 32 and takes N steps). N = 12 and 20
    are controls that agree either way."""
    m = jrect((0, 0), (1, 1), nx=N).device_arrays(jnp.float32)
    h = float(jax.jit(jget_nodal_h)(m).min())
    jax_steps = int(np.ceil(0.5 / (0.5 * h)))
    p = tb.build(tb.BurgersConfig(mesh_size=N, dtype="float32"),
                 device="cpu", host_mesh=trectangle_mesh(nx=N))
    assert p.num_steps == jax_steps == N + 1
    if N in (8, 16, 32):
        assert p.dt == 0.5 * h


def test_f32_time_step_matches_jax_at_n20():
    """f32 at N = 20: an f32 projection alone rounds min h_CG onto
    f32(1/20), above 1/20, and takes 20 steps, where the JAX package's f32
    projection lands below 1/20 and takes 21. time_step takes the smaller
    of the f32 and f64 minima: JAX's 21 steps, and dt within f32 rounding
    (2e-7 relative) of JAX's 0.02499999664723873."""
    N = 20
    m = jrect((0, 0), (1, 1), nx=N).device_arrays(jnp.float32)
    dt_jax = 0.5 * float(jax.jit(jget_nodal_h)(m).min())
    dt, steps = tb.time_step(
        tb.BurgersConfig(mesh_size=N, dtype="float32"),
        tb.stencil_min_h(rectangle_mesh_lean((0, 0), (1, 1), nx=N), N,
                         rectangle_cell_sizes((0, 0), (1, 1), nx=N)))
    assert steps == int(np.ceil(0.5 / dt_jax)) == N + 1
    assert abs(dt - dt_jax) <= 2e-7 * dt_jax


def _jax_chain(p):
    """[carry after 0, 1, ..., num_steps steps] of the JAX problem p: its
    own step, jitted once and chained from u0 at its time loop's times
    (one compile; its solve's scan costs more to compile)."""
    step = jax.jit(p.step)
    carries = [(p.u0,) * 3]
    for t in (jnp.arange(p.num_steps, dtype=p.u0.dtype) + 1.0) * p.dt:
        carries.append(step(carries[-1], t)[0])
    return carries


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """(problem, its _jax_chain) of the JAX reference config at mesh 12
    (the state-carrying test shares the rv case's)."""
    p = jb.build(jb.BurgersConfig(mesh_size=12, **REFERENCE[name]))
    return p, _jax_chain(p)


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_reference_config_matches_jax(name):
    """The whole trajectory (13 steps) and both errors against the exact
    solution at t = 0.5, against the JAX step chained over the same
    times."""
    pj, carries = _jax_reference(name)
    uj = carries[-1][0]
    pt = tb.build(tb.BurgersConfig(mesh_size=12, **REFERENCE[name]),
                  device="cpu")
    rt = pt.solve()
    assert rt.num_steps == pj.num_steps == 13
    assert abs(pt.dt - pj.dt) <= 1e-14 * pj.dt
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(uj), rtol=0,
                               atol=TOL)
    for fn in ("l1_error_vs_exact", "l2_error_vs_exact"):
        got = float(getattr(tb, fn)(pt, rt.u, 0.5))
        ref = float(getattr(jb, fn)(pj, uj, 0.5))
        assert abs(got - ref) <= TOL, (fn, got, ref)
    assert np.abs(rt.u.numpy() - pt.u0.numpy()).max() > 1e-2


def test_fixed_config_plain_fused_path_matches_jax():
    """The fixed-iteration config with use_kernels: the port's fused path
    (the single kernel's wrapper, its plain version on the CPU, with the
    Dirichlet data at each step's t) against the JAX XLA path."""
    pj = jb.build(jb.BurgersConfig(backend="stencil", **FIXED))
    ref = np.asarray(_jax_chain(pj)[-1][0])
    pt = tb.build(tb.BurgersConfig(use_kernels=True, **FIXED), device="cpu")
    assert pt._fused_mode() == "single"
    assert not pt._fused_multistep_ok()
    assert pt.num_steps == 3
    got = pt.solve().u.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert np.abs(got - pt.u0.numpy()).max() > 1e-2


def test_set_carry_continues_a_jax_state():
    """A JAX state after 6 of the 13 steps, set with set_carry(...,
    start_step=6), runs the 7 remaining steps at their own times (the
    Dirichlet data follow t) to the JAX trajectory's end state."""
    pj, carries = _jax_reference("rv")
    carry = carries[6]
    pt = tb.build(tb.BurgersConfig(mesh_size=12), device="cpu")
    pt.set_carry(*(np.asarray(c) for c in carry), start_step=6)
    assert len(pt.step_times(6)) == 7
    got = pt.solve().u.numpy()
    np.testing.assert_allclose(got, np.asarray(carries[-1][0]), rtol=0,
                               atol=TOL)
    with pytest.raises(ValueError, match="start_step"):
        pt.set_carry(*(np.asarray(c) for c in carry), start_step=14)


def test_cli_prints_its_json_line(capsys):
    assert tmain.main(["burgers", "--mesh_size", "8", "--device",
                       "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"workload", "stabilization", "mesh_size", "num_steps",
            "L2_error_vs_exact", "device", "wall_s"} <= set(out)
    assert (out["workload"], out["mesh_size"], out["num_steps"],
            out["device"]) == ("burgers", 8, 8, "cpu")
    _, err = tb.run(tb.BurgersConfig(mesh_size=8), device="cpu")
    assert out["L2_error_vs_exact"] == err


def test_build_targets_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.build(tb.BurgersConfig(mesh_size=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["burgers", "--mesh_size", "4"])


@pytest.mark.parametrize("over,item", [
    (dict(degree=3, ell_matvec_backend="banded"), "queue 1 item 13"),
    (dict(ell_matvec_backend="banded"), "queue 1 item 13"),
    (dict(backend="ell", ell_matvec_backend="blocked"), "queue 1 item 13"),
])
def test_unported_options_raise(over, item):
    """The ELL backends that ``item`` named when it was still to come
    build and step now (banded: the ELL SpMV kernel's plain version on the
    CPU; blocked at degree 1: the gather step, as in the JAX package; on
    the structured mesh with backend "auto" the stencil step, which reads
    no ELL backend)."""
    p = tb.build(tb.BurgersConfig(mesh_size=4, T=0.25, **over),
                 device="cpu")
    assert item == "queue 1 item 13"
    assert hasattr(p, "sd") == ("degree" not in over and "backend" not in over)
    assert bool(torch.isfinite(p.solve().u).all())


@pytest.mark.parametrize("over", [
    dict(stabilization="si"), dict(smooth_l=4.0), dict(backend="ell"),
    dict(backend="ell", ell_matvec_backend="lattice")])
def test_ported_options_build_and_step(over):
    """SI, the smoothing, the ELL backend and its lattice application
    build and take the JAX package's steps at mesh 4 (the mesh-12
    trajectories against JAX: test_reference_config_matches_jax; the
    lattice backend's: test_torch_lattice.py)."""
    jp = jb.build(jb.BurgersConfig(mesh_size=4, T=0.25, **over))
    p = tb.build(tb.BurgersConfig(mesh_size=4, T=0.25, **over), device="cpu")
    assert p.num_steps == jp.num_steps == 2
    assert hasattr(p, "sd") == ("backend" not in over)
    u = p.solve().u
    assert bool(torch.isfinite(u).all())
    assert float((u - p.u0).abs().max()) > 1e-2


def test_precise_reductions_names_its_roadmap_items():
    """precise_reductions is ported (the ELL step's f64 dots; a no-op on
    the stencil backend, as in the JAX package); since item 15c the
    sharded fused path takes it too and reads it nowhere, as the JAX class
    does: its solve is bit for bit the one without the flag."""
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedFusedStructured)

    check_supported(HyperbolicConfig(precise_reductions=True))
    cfg = tb.BurgersConfig(mesh_size=8, T=0.25, inner_solver="cheby",
                           cg_iters=10, newton_iters=2,
                           newton_linear_iters=16, modified_newton=True)
    p = tb.build(cfg, device="cpu")
    q = tb.build(dataclasses.replace(cfg), device="cpu")
    q.cfg = dataclasses.replace(q.cfg, precise_reductions=True)
    torch.testing.assert_close(q.solve().u, p.solve().u, rtol=0, atol=0)
    torch.testing.assert_close(
        ShardedFusedStructured(q, LocalBlocks(2, "cpu")).solve(),
        ShardedFusedStructured(p, LocalBlocks(2, "cpu")).solve(), rtol=0,
        atol=0)


def test_golden_final_frame_matches_the_h5():
    """golden/burgers_rv50_final.npy is the last frame of
    golden/burgers_rv50.h5 (scripts/make_burgers_golden_npy.py)."""
    pytest.importorskip("h5py")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_burgers_golden_npy",
        os.path.join(REPO, "scripts", "make_burgers_golden_npy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t, u = mod.last_frame()
    assert abs(t - 0.51) < 1e-9
    np.testing.assert_array_equal(
        np.load(os.path.join(REPO, "golden", "burgers_rv50_final.npy")), u)
