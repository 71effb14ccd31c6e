"""The port's example scripts (conservation_fem_tpu_torch/examples/, the
JAX package's examples/tutorial.py and make_figures.py) on the CPU: the
tutorial's sections against the JAX package's functions at the same
inputs, make_figures' sections at reduced sizes against the port's own
model functions (each held against the JAX package in its model's test
file), both scripts' main() at a tiny size, and the six device-data
helpers' default device. Meshes of 16 or smaller; one JAX build per
fixture."""

import contextlib
import functools
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops import assembly as jasm
from conservation_fem_tpu.ops import bc as jbc
from conservation_fem_tpu.ops import krylov as jkrylov
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu_torch.examples import make_figures as mf
from conservation_fem_tpu_torch.examples import tutorial as tu
from conservation_fem_tpu_torch.models import burgers as tburgers
from conservation_fem_tpu_torch.models import euler as teuler
from conservation_fem_tpu_torch.models import linear_advection as tla
from conservation_fem_tpu_torch.ops import assembly as tasm
from conservation_fem_tpu_torch.ops import blocked as tblocked
from conservation_fem_tpu_torch.ops import blocked_pk as tblocked_pk
from conservation_fem_tpu_torch.ops import lattice as tlat
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import multigrid as tmg
from conservation_fem_tpu_torch.ops import spaces as tspaces
from conservation_fem_tpu_torch.ops import tiling as ttiling

# the tutorial's KPP run, cut to 10 steps
KPP_MESH, KPP_T = 4, 0.1
# make_figures' sections at reduced sizes (main()'s keywords)
FIGURES = dict(adv_mesh=8, conv_meshes=(4, 8), kpp_mesh=8, burgers_mesh=12,
               sod_nx=16, gif_mesh=4, gif_frames=3)
SECTIONS = ("advection", "convergence", "kpp_wave", "burgers_riemann",
            "sod", "evolution")
FILES = ("adv_rv_sol.png", "adv_rv_3d.png", "adv_gfem_conv.png",
         "kpp_rv_sol.png", "burgers_rv_sol.png", "burgers_exact.png",
         "sod_profile.png", "advection.gif")
PNG, GIF = b"\x89PNG\r\n\x1a\n", b"GIF89a"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tut_run():
    """The tutorial's section 3 at KPP_MESH, T = KPP_T on the CPU:
    (cfg, problem, result)."""
    return tu.stabilized_run("cpu", KPP_MESH, KPP_T)


@pytest.fixture(scope="module")
def jax_kpp():
    cfg = jkpp.KPPConfig(mesh_size=KPP_MESH, T=KPP_T, record_metrics=True)
    return jkpp.build(cfg).solve()


def test_tutorial_meshes_and_poisson_match_jax():
    """Sections 1 and 2 at the JAX script's size: the same mesh counts,
    CG iterations, and L2 error within 1e-12 relative."""
    mesh, m = tu.meshes("cpu")
    jm = jmesh.disk_mesh(hmax=1 / 16)
    assert (mesh.n_nodes, mesh.n_cells, int(mesh.boundary_mask.sum())) == (
        jm.n_nodes, jm.n_cells, int(jm.boundary_mask.sum())) == (817, 1536,
                                                                 96)
    assert m.points.device.type == "cpu" and m.points.dtype == torch.float64
    sol, err = tu.poisson(m)
    ja = jm.device_arrays(jnp.float64)
    K = jasm.assemble_stiffness(ja)
    g = ja.points[:, 0] ** 2 - ja.points[:, 1] ** 2
    b = jbc.lift_rhs(ja, K, jnp.zeros(jm.n_nodes), g, ja.boundary_mask)
    jsol = jkrylov.cg(jbc.constrained_operator(ja, K, ja.boundary_mask), b,
                      rtol=1e-12)
    jerr = float(jasm.l2_error_vs_function(ja, jsol.x,
                                           lambda x, y: x * x - y * y))
    assert int(sol.iters) == int(jsol.iters) == 49
    assert abs(float(err) - jerr) <= 1e-12 * jerr


def test_tutorial_stabilized_run_matches_jax(tut_run, jax_kpp):
    """Section 3: the step count, u within 1e-12 and newton_converged of
    the JAX package's run of the same config."""
    cfg, _, r = tut_run
    assert cfg.record_metrics and r.num_steps == jax_kpp.num_steps == 10
    assert np.abs(r.u.numpy() - np.asarray(jax_kpp.u)).max() <= 1e-12
    np.testing.assert_array_equal(
        r.metrics["newton_converged"].numpy(),
        np.asarray(jax_kpp.metrics["newton_converged"]))


def test_tutorial_checkpoint_resume_is_bit_exact(tut_run, tmp_path):
    """Section 4: the resumed run is the checkpointed run, bit for bit, and
    both are section 3's."""
    cfg, _, r = tut_run
    r1, r2 = tu.checkpoint_resume(cfg, "cpu", str(tmp_path))
    assert (tmp_path / "kpp.npz").exists()
    assert torch.equal(r1.u, r2.u) and torch.equal(r1.u, r.u)


def test_tutorial_plots_and_xdmf_round_trip(tut_run, tmp_path):
    """Section 5: the snapshot is a PNG and the XDMF series reads back
    section 3's u exactly at its time."""
    _, problem, r = tut_run
    times, vals, out = tu.plots_and_io(problem, r, str(tmp_path))
    assert out == str(tmp_path)
    assert (tmp_path / "kpp.png").read_bytes()[:8] == PNG
    assert (tmp_path / "kpp.xdmf").exists()
    np.testing.assert_array_equal(times, [r.num_steps * r.dt])
    np.testing.assert_array_equal(vals, r.u.numpy()[None])


def test_tutorial_sharded_solve_matches_single(tut_run):
    """Section 6: over LocalBlocks(4) within 1e-10 of the single run."""
    cfg, _, r = tut_run
    u_sh, diff = tu.sharded_solve(cfg, r.u, "cpu", 4)
    assert u_sh.shape == r.u.shape
    assert diff == float((u_sh - r.u).abs().max()) <= 1e-10


@pytest.fixture(scope="module")
def gallery(tmp_path_factory):
    """make_figures.main() at the reduced sizes: (its directory, its printed
    lines, {section: what the section's function returned to main})."""
    out, results = tmp_path_factory.mktemp("figures"), {}

    def kept(name, fn):
        return lambda *a, **kw: results.setdefault(name, fn(*a, **kw))

    with pytest.MonkeyPatch.context() as mp:
        for name in SECTIONS:
            mp.setattr(mf, name, kept(name, getattr(mf, name)))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mf.main(str(out), "cpu", **FIGURES)
    return out, buf.getvalue().splitlines(), results


def _check_advection(out):
    p, res = out
    assert (p.cfg.mesh_size, p.cfg.stabilization) == (8, "rv_node")
    assert torch.equal(res.u, tla.solve(p).u)
    assert torch.equal(res.error_l2, tla.l2_error_vs_ic(p, res.u))


def _check_convergence(conv):
    want = [float(tla.run(mesh_size=n, stabilization="gfem",
                          device="cpu").error_l2) for n in (4, 8)]
    np.testing.assert_array_equal(conv.errors, want)
    np.testing.assert_array_equal(conv.hmaxes, [1 / 4, 1 / 8])
    slope = np.polyfit(np.log10(conv.hmaxes), np.log10(want), 1)[0]
    assert conv.slope == float(slope) and 1.0 < conv.slope < 2.5


def _check_kpp_wave(out):
    p, res = out
    assert p.host_mesh.n_nodes == (4 * 8 + 1) ** 2 and p.dt == 0.01
    assert res.num_steps == p.num_steps == 100 and res.metrics is None
    u = res.u.numpy()
    assert u.shape == (p.host_mesh.n_nodes,) and np.isfinite(u).all()
    assert 0.5 < u.min() and u.max() < 12.0


def _check_burgers_riemann(out):
    p, res, ex = out
    assert p.num_steps == 13 and res.u.shape == ex.shape
    pts = torch.as_tensor(p.host_mesh.points)
    assert torch.equal(ex, tburgers.exact_solution(pts[:, 0], pts[:, 1],
                                                   0.5))
    d = res.u - ex
    assert torch.isfinite(d).all()
    assert 0 < float(tburgers.l2_error_vs_exact(p, res.u, 0.5)) < 0.5


def _check_sod(out):
    p, res, x, t_end, rho_ex = out
    assert t_end == res.num_steps * res.dt
    np.testing.assert_array_equal(x, p.mesh.points[:, 0].numpy())
    assert torch.equal(res.U, teuler.solve(p).U)
    rho = res.U[:, 0].numpy()[np.argsort(x)]
    assert np.isfinite(rho).all() and rho_ex.shape == rho.shape
    # closer to the exact solution than the initial state is
    assert (teuler.sod_density_error(p, res.U, t_end)
            < teuler.sod_density_error(p, p.U0, t_end))


def _check_evolution(out):
    p, us = out
    assert len(us) == 3 and p.cfg.T == 0.2
    u_n = u_old = p.u0
    for u in us:
        u_n, u_old = tla._step_rv_node(p, u_n, u_old), u_n
        assert torch.equal(u, u_n)


@pytest.mark.parametrize("section", SECTIONS)
def test_figures_section_numbers(gallery, section):
    """Each computation of make_figures, as main() ran it at the reduced
    sizes, against the port's own model functions."""
    globals()[f"_check_{section}"](gallery[2][section])


def test_figures_main_writes_the_gallery(gallery):
    """main() at the reduced sizes writes the JAX script's 8 files, each a
    non-empty PNG or GIF."""
    out = gallery[0]
    for name in FILES:
        head = (out / name).read_bytes()[:8]
        assert head.startswith(GIF if name.endswith(".gif") else PNG), name
    assert sorted(p.name for p in out.iterdir()) == sorted(FILES)


def test_figures_main_prints_the_jax_lines(gallery):
    """main() prints the JAX script's six lines."""
    lines = gallery[1]
    assert len(lines) == 6 and lines[0] == "advection figures done"
    assert re.fullmatch(r"convergence figure done \(slope \d\.\d\d\)",
                        lines[1])
    assert lines[2:] == ["kpp figure done", "burgers figures done",
                         "sod figure done", "gif done"]


def test_tutorial_main_prints_the_jax_lines(capsys):
    """main() at a tiny size prints the JAX tutorial's six lines in its
    format."""
    tu.main("cpu", n_blocks=2, hmax=1 / 4, mesh_size=KPP_MESH, T=KPP_T)
    lines = capsys.readouterr().out.splitlines()
    num = r"\d\.\d\de[-+]\d\d"
    pats = (r"mesh: \d+ nodes, \d+ cells, \d+ boundary nodes",
            rf"Poisson: CG iters=\d+, L2 error vs exact {num} \(O\(h\^2\) "
            r"discretization\)",
            r"KPP RV: 10 steps, Newton converged every step: True, u in "
            r"\[\d+\.\d\d, \d+\.\d\d\]",
            r"checkpoint/resume: bit-exact",
            r"wrote \+ re-read XDMF series: 1 snapshot\(s\) -> .+",
            rf"sharded solve on 2 block\(s\): max \|diff\| vs single = "
            rf"{num}")
    assert len(lines) == len(pats)
    for line, pat in zip(lines, pats):
        assert re.fullmatch(pat, line), line


@functools.lru_cache(maxsize=None)
def _helpers():
    """The six device-data helpers, each as f(**device_kw) -> a tensor it
    made."""
    rect = tmesh.rectangle_mesh((0, 0), (1, 1), nx=4)
    rcm = tmesh.reorder_mesh(rect, tmesh.rcm_permutation(rect))
    space = tspaces.build_space(rcm, 2)
    tiled, _ = ttiling.tile_mesh(tmesh.irregular_mesh((-2, -2), (2, 2),
                                                      nx=60, seed=1))
    K = tasm.assemble_stiffness(rect.device_arrays(torch.float64, "cpu"))
    return {
        "Mesh.device_arrays": lambda **kw: rect.device_arrays(
            torch.float64, **kw).points,
        "FunctionSpace.device_arrays": lambda **kw: space.device_arrays(
            torch.float64, **kw).dof_coords,
        "make_blocked_plan": lambda **kw: tblocked.make_blocked_plan(
            rcm, torch.float64, **kw).mesh.points,
        "make_tiled_plan": lambda **kw: tblocked.make_tiled_plan(
            tiled, dtype=torch.float64, **kw).row_valid,
        "make_blocked_pk_plan": lambda **kw: tblocked_pk.make_blocked_pk_plan(
            space, torch.float64, **kw).mesh.dof_coords,
        "build_mg": lambda **kw: tmg.build_mg(
            tlat.build_plan(rect.points), rect.patch_cols, rect.patch_mask,
            [[K]], rect.boundary_mask, coarse_max=10,
            **kw)[1]["cinv"],
    }


@pytest.mark.parametrize("helper", ["Mesh.device_arrays",
                                    "FunctionSpace.device_arrays",
                                    "make_blocked_plan", "make_tiled_plan",
                                    "make_blocked_pk_plan", "build_mg"])
def test_device_data_helpers_default_to_the_card(helper):
    """Without ``device`` each helper targets the card, as every model's
    build does: here, with no card, it raises; device="cpu" gives CPU
    tensors."""
    make = _helpers()[helper]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert make(device="cpu").device.type == "cpu"
