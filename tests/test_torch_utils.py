"""The utilities and solve()'s checkpoint, resume and streaming (ROADMAP
queue 1 item 14) against the JAX package on the CPU: chunked and resumed
runs bit-equal to the plain run (a JAX checkpoint resuming in the port is
tests/test_torch_kpp.py's, beside the JAX trajectory it shares), streamed
frames, XDMF and VTX files byte for byte the JAX writers', the DG carriers, cross-mesh interpolation, the scipy baseline
proxy, the native preprocessor, guards, metrics, the reference round trip,
the smoothing sweep and the plots. Meshes of 16 or smaller; the JAX runs
are shared through module-scoped fixtures."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops import dg as jdg
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.utils import baseline_proxy as jproxy
from conservation_fem_tpu.utils import guards as jguards
from conservation_fem_tpu.utils import interpolate as jinterp
from conservation_fem_tpu.utils import io as jio
from conservation_fem_tpu.utils import metrics as jmetrics
from conservation_fem_tpu.utils import sweeps as jsweeps
from conservation_fem_tpu_torch import native_ext
from conservation_fem_tpu_torch.models import burgers as tburgers
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import dg as tdg
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops.helpers import get_nodal_h_ell
from conservation_fem_tpu_torch.utils import baseline_proxy as tproxy
from conservation_fem_tpu_torch.utils import checkpoint as tck
from conservation_fem_tpu_torch.utils import guards as tguards
from conservation_fem_tpu_torch.utils import interpolate as tinterp
from conservation_fem_tpu_torch.utils import io as tio
from conservation_fem_tpu_torch.utils import metrics as tmetrics
from conservation_fem_tpu_torch.utils import plotting as tplot
from conservation_fem_tpu_torch.utils import sweeps as tsweeps
from conservation_fem_tpu_torch.utils.streaming import (StreamingSink,
                                                        StreamingXDMF)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KPP = dict(mesh_size=4, T=0.1)       # 10 steps, f64
BURGERS = dict(mesh_size=8)          # 8 steps, time-dependent Dirichlet data


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(model, **over):
    if model == "kpp":
        return tkpp.build(tkpp.KPPConfig(**{**KPP, **over}), device="cpu")
    return tburgers.build(tburgers.BurgersConfig(**{**BURGERS, **over}),
                          device="cpu")


@pytest.fixture(scope="module")
def plain_runs():
    return {m: _build(m).solve().u for m in ("kpp", "burgers")}


@pytest.mark.parametrize("model", ["kpp", "burgers"])
def test_chunked_and_resumed_runs_equal_the_plain_run(model, plain_runs,
                                                      tmp_path):
    u_plain = plain_runs[model]
    chunked = _build(model).solve(checkpoint_path=str(tmp_path / "a.npz"),
                                  checkpoint_every=3).u
    assert torch.equal(chunked, u_plain)
    ck = tck.load_checkpoint(str(tmp_path / "a.npz"))
    p = _build(model)
    assert ck.step == p.num_steps and ck.t == p.num_steps * p.dt
    assert torch.equal(torch.from_numpy(ck.arrays["u_n"]), u_plain)
    # stopped at half its steps, then resumed to the end
    half = p.num_steps // 2
    p.num_steps = half
    p.solve(checkpoint_path=str(tmp_path / "b.npz"), checkpoint_every=2)
    assert tck.load_checkpoint(str(tmp_path / "b.npz")).step == half
    resumed = _build(model).solve(checkpoint_path=str(tmp_path / "b.npz"),
                                  checkpoint_every=2, resume=True).u
    assert torch.equal(resumed, u_plain)


def test_checkpoint_path_without_suffix_really_resumes(plain_runs, tmp_path):
    """np.savez writes run.ckpt.npz for run.ckpt; the JAX solve then looks
    for run.ckpt, finds nothing and restarts from step 0. The port resumes
    from the file written: 4 steps, not 10, to the same u."""
    path = str(tmp_path / "run.ckpt")
    p = _build("kpp")
    p.num_steps = 6
    assert tck.save_checkpoint(path, 0, 0.0, u=np.zeros(1)) == path + ".npz"
    p.solve(checkpoint_path=path, checkpoint_every=3)
    assert os.path.exists(path + ".npz") and not os.path.exists(path)
    p = _build("kpp")
    steps = []
    step = p.step
    p.step = lambda *a: steps.append(1) or step(*a)
    u = p.solve(checkpoint_path=path, checkpoint_every=3, resume=True).u
    assert len(steps) == 4
    assert torch.equal(u, plain_runs["kpp"])


def test_stream_with_checkpointing_raises(tmp_path):
    with pytest.raises(ValueError, match="stream= is not supported"):
        _build("kpp").solve(checkpoint_path=str(tmp_path / "c"),
                            checkpoint_every=2, stream=StreamingSink(print))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_streamed_frames(dtype, tmp_path):
    p = _build("kpp", T=0.05, dtype=dtype)
    frames = []
    res = p.solve(stream=StreamingSink(lambda u, t: frames.append((u, t))))
    n = p.num_steps
    assert len(frames) == n
    want = (np.arange(n, dtype=dtype) + 1.0) * np.asarray(p.dt, dtype)
    assert [t for _, t in frames] == [float(x) for x in want]
    assert frames[-1][0].dtype == np.dtype(dtype)
    assert np.array_equal(frames[-1][0], res.u.numpy())
    times = []
    sink = StreamingSink(lambda u, t: times.append(t), every=2)
    p.solve(stream=sink)
    assert times == [float(x) for x in want[::2]]
    sink.close()
    times.clear()
    p.solve(stream=sink)
    assert len(times) == -(-n // 2)
    # the XDMF series of a stream round-trips through read_h5_series
    path = str(tmp_path / "stream.xdmf")
    with StreamingXDMF(path, p.host_mesh) as stream:
        p.solve(stream=stream)
    t_h5, vals = tio.read_h5_series(str(tmp_path / "stream.h5"), "uh")
    assert list(t_h5) == [float(x) for x in want]
    assert np.array_equal(vals[-1], res.u.numpy().astype(np.float64))


# -- I/O --------------------------------------------------------------------


def _fields(points):
    return [np.sin(3 * points[:, 0]) * points[:, 1], points[:, 0] ** 2]


def test_xdmf_and_vtx_bytes_equal_the_jax_writers(tmp_path):
    jm, tm = jmesh.disk_mesh(1 / 8), tmesh.disk_mesh(1 / 8)
    assert tmesh.mesh_fingerprint(tm) == tmesh.mesh_fingerprint(jm)
    fields, times = _fields(tm.points), (0.1, 0.25)
    out = {}
    for name, io, mesh, wrap in (("jax", jio, jm, jnp.asarray),
                                 ("torch", tio, tm, torch.as_tensor)):
        d = tmp_path / name
        with io.XDMFWriter(str(d / "series.xdmf"), mesh) as w:
            for f, t in zip(fields, times):
                w.write_function(wrap(f), t)
        with io.VTXWriter(str(d / "vtx"), mesh, wrap(fields[0])) as v:
            v.write(times[0])
            v.write(times[1], field=wrap(np.stack(fields, axis=1)))
        assert v.stats["writes"] == 2 and v.stats["bytes_total"] > 0
        out[name] = {f: open(d / f, "rb").read() for f in (
            "series.xdmf", "vtx.bp/step_000000.vtu",
            "vtx.bp/step_000001.vtu", "vtx.bp/series.pvd")}
    assert out["torch"] == out["jax"]
    t_h5, vals = tio.read_h5_series(str(tmp_path / "torch/series.h5"), "uh")
    assert list(t_h5) == list(times)
    assert np.array_equal(vals, np.stack(fields))
    m2 = tio.read_h5_mesh(str(tmp_path / "torch/series.h5"))
    assert tmesh.mesh_fingerprint(m2) == tmesh.mesh_fingerprint(tm)


# -- DG carriers and interpolation --------------------------------------------


def test_dg_functions_match_jax():
    jm = jmesh.disk_mesh(1 / 8).device_arrays(jnp.float64)
    tm = tmesh.disk_mesh(1 / 8).device_arrays(torch.float64, "cpu")
    tt = lambda a: np.asarray(a)

    def close(a, b, tol):
        np.testing.assert_allclose(tt(a), tt(b), rtol=0, atol=tol)

    close(tdg.cell_vertex_coords(tm), jdg.cell_vertex_coords(jm), 0)
    d0 = tdg.dg0_interpolate(tm, lambda p: torch.sin(3 * p[:, 0]) * p[:, 1])
    close(d0, jdg.dg0_interpolate(jm, lambda p: jnp.sin(3 * p[:, 0])
                                  * p[:, 1]), 1e-14)
    d1 = tdg.dg1_interpolate(tm, lambda p: torch.cos(2 * p[:, 1]) + p[:, 0])
    jd1 = jdg.dg1_interpolate(jm, lambda p: jnp.cos(2 * p[:, 1]) + p[:, 0])
    close(d1, jd1, 1e-14)
    u = torch.sin(tm.points[:, 0] + 2 * tm.points[:, 1])
    close(tdg.dg1_from_cg(tm, u), jdg.dg1_from_cg(jm, jnp.asarray(u.numpy())),
          0)
    close(tdg.dg1_average_to_cg(tm, d1), jdg.dg1_average_to_cg(jm, jd1),
          1e-12)
    close(tdg.project_to_cg(tm, d1), jdg.project_to_cg(jm, jd1), 1e-12)
    close(tdg.cell_h_dg1(tm), jdg.cell_h_dg1(jm), 0)
    h = tdg.nodal_h_dg1(tm)
    close(h, jdg.nodal_h_dg1(jm), 1e-12)
    # the DG0 projection of h_cell is get_nodal_h_ell's, the JAX
    # get_nodal_h's port
    h_ref = get_nodal_h_ell(tm)
    close(tdg.project_to_cg(tm, tm.h_cell), h_ref, 1e-12)
    close(h, h_ref, 1e-12)
    with pytest.raises(ValueError, match="DG0/DG1"):
        tdg.project_to_cg(tm, torch.zeros(3, 2, dtype=torch.float64))


def _kpp_field(points):
    r2 = points[:, 0] ** 2 + points[:, 1] ** 2
    return np.pi / 4 + 3 * np.pi * np.exp(-2 * r2)


def test_interpolation_matches_jax():
    fine_t, coarse_t = (tmesh.rectangle_mesh((-2, -2), (2, 2), nx=n)
                        for n in (32, 16))        # KPP mesh 8 and mesh 4
    fine_j, coarse_j = (jmesh.rectangle_mesh((-2, -2), (2, 2), nx=n)
                        for n in (32, 16))
    u_f, u_c = _kpp_field(fine_t.points), _kpp_field(coarse_t.points)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2.2, 2.2, size=(200, 2))   # some outside the domain
    got = tinterp.interpolate_p1(fine_t, torch.as_tensor(u_f), pts)
    np.testing.assert_allclose(got, jinterp.interpolate_p1(fine_j, u_f, pts),
                               rtol=0, atol=1e-12)
    cells, bary = tinterp.locate_cells(coarse_t, pts)
    jc, jb = jinterp.locate_cells(coarse_j, pts)
    assert np.array_equal(cells, jc) and np.array_equal(bary, jb)
    l2 = tinterp.cross_mesh_l2(fine_t, u_f, coarse_t,
                               torch.as_tensor(u_c + 1e-3 * coarse_t.points[
                                   :, 0]))
    ref = jinterp.cross_mesh_l2(fine_j, u_f, coarse_j,
                                u_c + 1e-3 * coarse_j.points[:, 0])
    assert ref > 0 and abs(l2 - ref) <= 1e-12 * ref


# -- the scipy baseline proxy -----------------------------------------------


def test_baseline_proxies_match_jax_and_the_port_step():
    p = _build("kpp")
    u0 = p.u0.numpy()
    tp = tproxy.make_kpp_proxy(p.host_mesh, dt=p.dt)
    jp = jproxy.make_kpp_proxy(jkpp.build(jkpp.KPPConfig(**KPP)).host_mesh,
                               dt=p.dt)
    u_t = tp.solve(u0, 2)
    assert np.array_equal(u_t, jp.solve(u0, 2))
    assert np.array_equal(tp.h_cg, jp.h_cg)
    carry = (p.u0, p.u0, p.u0)
    for t in p.step_times()[:2]:
        carry, _ = p.step(carry, t)
    np.testing.assert_allclose(carry[0].numpy(), u_t, rtol=0, atol=5e-9)
    # Burgers: the exact-solution Dirichlet data of every step
    q = tburgers.build(tburgers.BurgersConfig(mesh_size=12, backend="ell"),
                       device="cpu")
    tb = tproxy.make_burgers_proxy(q.host_mesh, dt=q.dt)
    jb = jproxy.make_burgers_proxy(q.host_mesh, dt=q.dt)
    for t in (0.0, q.dt, 0.37):
        np.testing.assert_allclose(tb.bc_value(q.host_mesh.points, t),
                                   jb.bc_value(q.host_mesh.points, t),
                                   rtol=0, atol=1e-14)
    v_t = tb.solve(q.u0.numpy(), 2)
    np.testing.assert_allclose(v_t, jb.solve(q.u0.numpy(), 2), rtol=0,
                               atol=1e-14)
    carry = (q.u0, q.u0, q.u0)
    for t in q.step_times()[:2]:
        carry, _ = q.step(carry, t)
    np.testing.assert_allclose(carry[0].numpy(), v_t, rtol=0, atol=5e-9)


# -- the native preprocessor ------------------------------------------------


def test_native_preprocessor_equals_the_numpy_path():
    base = tmesh.irregular_mesh((-2, -2), (2, 2), 24, seed=3)
    nat = tmesh.mesh_from_arrays(base.points, base.cells, use_native=True)
    ref = tmesh.mesh_from_arrays(base.points, base.cells)
    for key in ("boundary_mask", "patch_cols", "patch_mask", "diag_slot",
                "cell_slots", "mat_perm", "mat_segs", "vec_perm",
                "vec_segs"):
        assert np.array_equal(getattr(nat, key), getattr(ref, key)), key
    assert native_ext.available()
    _, _, _, rcm = native_ext.preprocess_mesh(base.n_nodes, base.cells)
    assert np.array_equal(rcm, tmesh.rcm_permutation(ref))
    pts, cells = native_ext.structured_rectangle(4, 3, 0, 0, 2, 1)
    rect = tmesh.rectangle_mesh((0, 0), (2, 1), nx=4, ny=3)
    np.testing.assert_allclose(pts, rect.points)
    assert np.array_equal(cells, rect.cells)
    assert os.path.dirname(native_ext.LIB) == os.path.join(
        REPO, "conservation_fem_tpu_torch", "_build")


# -- guards, metrics, profiling -----------------------------------------------


def test_guards_and_metrics_match_jax(tmp_path):
    for v in ([1.0, -2.0], [1e5, 0.0], [np.nan, 0.0], [np.inf, 1.0]):
        got = tguards.blown_up(torch.tensor(v))
        assert got.ndim == 0 and got.dtype == torch.bool
        assert bool(got) == bool(jguards.blown_up(jnp.asarray(v)))
    for v in ([np.inf], [2e3]):
        with pytest.raises(tguards.BlowupError):
            tguards.check_state(torch.tensor(v))
    assert tguards.check_state(torch.tensor([0.5, -0.75])) == 0.75
    for t, dt, T in ((0.95, 0.1, 1.0), (0.2, 0.1, 1.0)):
        want = float(jguards.clamp_final_dt(t, dt, T))
        assert tguards.clamp_final_dt(t, dt, T) == want
        assert float(tguards.clamp_final_dt(
            torch.tensor(t, dtype=torch.float64), dt, T)) == want
    m = {"newton_converged": [True, False, True],
         "eps_max": [0.1, 0.3, 0.2], "newton_iters": [3, 4, 2]}
    assert (tmetrics.metrics_to_json({k: torch.as_tensor(np.asarray(v))
                                      for k, v in m.items()})
            == jmetrics.metrics_to_json({k: jnp.asarray(v)
                                         for k, v in m.items()}))
    p = _build("kpp", T=0.03, record_metrics=True)
    with tmetrics.StepTimer(p.u0.numel()) as timer:
        res = p.solve()
    timer.count(p.num_steps)
    assert timer.summary()["steps"] == 3 and timer.dof_steps_per_sec > 0
    assert json.loads(tmetrics.metrics_to_json(res.metrics))[
        "newton_converged"]["all"]
    with tmetrics.profile_trace(str(tmp_path / "trace")) as logdir:
        (torch.arange(8.0) * 2.0).sum()
    with open(os.path.join(logdir, tmetrics.TRACE_FILE)) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::mul" in names and "aten::sum" in names


# -- the KPP reference, the sweep, the plots --------------------------------


def test_generate_and_compare_to_reference(tmp_path):
    path = str(tmp_path / "ref.xdmf")
    res = tkpp.generate_reference(path, mesh_size=2, T=0.03, device="cpu")
    p = _build("kpp", mesh_size=2)
    assert tkpp.compare_to_reference(path, res.u, p.host_mesh) == 0.0
    d = tkpp.compare_to_reference(path, res.u + 0.5, p.host_mesh)
    assert d == pytest.approx(0.5 * 4.0, rel=1e-12)   # 0.5 * sqrt(area 16)


def test_smoothing_sweep_matches_jax():
    got = tsweeps.burgers_smoothing_sweep((4.0,), mesh_size=8, device="cpu")
    want = jsweeps.burgers_smoothing_sweep((4.0,), mesh_size=8)
    assert list(got) == [4.0]
    assert abs(got[4.0] - want[4.0]) <= 1e-10


def test_plots(tmp_path):
    mesh = tmesh.rectangle_mesh((0, 0), (1, 1), nx=4)
    ma = mesh.device_arrays(torch.float64, "cpu")
    u = torch.sin(3 * ma.points[:, 0])
    loc = str(tmp_path)
    paths = [tplot.plot_field(mesh, u, "t", "f2", loc),
             tplot.plot_field(mesh, u, "t", "f3", loc, three_d=True),
             tplot.plot_grid(tmesh.make_periodic(mesh), "grid", loc,
                             node_labels=True),
             tplot.plot_dg_field(ma, tdg.dg1_from_cg(ma, u), "dg1", "dg1",
                                 loc),
             tplot.plot_dg_field(ma, tdg.cell_h_dg1(ma)[:, 0], "dg0", "dg0",
                                 loc, show_edges=True)]
    errors = [0.1, 0.025, torch.tensor(0.00625, dtype=torch.float64)]
    conv, slope = tplot.plot_convergence(errors, [4, 8, 16], "c", "conv",
                                         loc)
    assert all(os.path.getsize(p) > 1000 for p in paths + [conv])
    assert slope == pytest.approx(2.0, abs=1e-10)
    rp = tplot.RealtimePlot(mesh, loc, "anim.gif", fps=5)
    for k in range(2):
        rp.add_frame(u + k, eps=ma.points[:, 1], t=0.1 * k)
    assert os.path.getsize(rp.close()) > 500


def test_optional_libraries_raise_naming_themselves(monkeypatch, tmp_path):
    """Blocked h5py, matplotlib or PIL: what needs one raises ImportError
    naming it (the modules import without them:
    tests/test_torch_kpp.py::test_package_imports_without_jax)."""
    mesh = tmesh.rectangle_mesh(nx=2)
    for lib, fn in (
            ("matplotlib", lambda: tplot.plot_grid(mesh, "g", str(tmp_path))),
            ("h5py", lambda: tio.XDMFWriter(str(tmp_path / "x.xdmf"), mesh)),
            ("PIL", lambda: _gif_without_pil(mesh, tmp_path, monkeypatch))):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, lib, None)
            with pytest.raises(ImportError, match=lib):
                fn()


def _gif_without_pil(mesh, tmp_path, monkeypatch):
    rp = tplot.RealtimePlot(mesh, str(tmp_path), "anim.gif")
    rp.add_frame(np.zeros(mesh.n_nodes))
    rp.close()
