"""Full runs of the unstructured fast path on the CPU, f64 (the kernels'
plain versions): KPP on the blocked backend against the JAX package's
blocked backend (RV, SI and the matrix-free Jacobian, on an RCM-ordered
rectangle_mesh(nx=12), T = 0.05) within 1e-9, the JAX package's own bar
between its backends (tests/test_blocked_model.py); the banded backend
against the port's gather backend on the same mesh; blocked2d on the tile
slots of irregular_mesh(nx=60, seed=1) against the port's gather run on
the mesh itself, through the slot map (which is the JAX package's), within
1e-11; the launches each backend makes on the card counted nowhere here.
The Pk and advection blocked runs sit beside their JAX runs in
tests/test_torch_burgers_pk.py, test_torch_linear_advection.py and
test_torch_advection_ho.py."""

import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops import blocked as jblk
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.models.blocked_hyperbolic import \
    BlockedHyperbolicProblem
from conservation_fem_tpu_torch.ops import blocked as tblk
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops.tiling import tile_mesh

JAX_TOL = 1e-9
TOL = 1e-11
FIXED = dict(modified_newton=True, cg_iters=6, newton_iters=2,
             newton_linear_iters=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run shares the cores among several
    pytest worker processes, where torch's thread pool only
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rcm():
    jm = jmesh.rectangle_mesh((-2, -2), (2, 2), nx=12)
    tm = tmesh.rectangle_mesh((-2, -2), (2, 2), nx=12)
    return (jmesh.reorder_mesh(jm, jmesh.rcm_permutation(jm)),
            tmesh.reorder_mesh(tm, tmesh.rcm_permutation(tm)))


def _cfg(mod, **kw):
    return mod.KPPConfig(mesh_size=12, T=0.05, backend="ell", **kw)


@pytest.mark.parametrize("over", [
    dict(), dict(stabilization="si"), dict(blocked_matrix_free=True)],
    ids=["rv", "si", "matrix_free"])
def test_kpp_blocked_matches_jax_blocked(rcm, over):
    jm, tm = rcm
    want = np.asarray(jkpp.build(_cfg(jkpp, ell_matvec_backend="blocked",
                                      **over), host_mesh=jm).solve().u)
    p = tkpp.build(_cfg(tkpp, ell_matvec_backend="blocked", **over),
                   host_mesh=tm, device="cpu")
    assert isinstance(p, BlockedHyperbolicProblem) and p.plan.row_valid is None
    np.testing.assert_allclose(p.solve().u.numpy(), want, rtol=0,
                               atol=JAX_TOL)


@pytest.mark.parametrize("over", [dict(), dict(smooth_l=4.0), FIXED],
                         ids=["rv", "smoothing", "fixed"])
def test_kpp_banded_and_blocked_match_gather(rcm, over):
    """banded (the ELL SpMV's plain version on the gather backend's
    operators) and blocked against the gather backend, same RCM mesh."""
    _, tm = rcm
    ref = tkpp.build(_cfg(tkpp, **over), host_mesh=tm,
                     device="cpu").solve().u
    for backend in ("banded", "blocked"):
        u = tkpp.build(_cfg(tkpp, ell_matvec_backend=backend, **over),
                       host_mesh=tm, device="cpu").solve().u
        torch.testing.assert_close(u, ref, rtol=0, atol=TOL)


def test_kpp_builds_rcm_and_tile_meshes_as_jax():
    """A mesh built by kpp.build is RCM-ordered for blocked, with the JAX
    package's numbering; for blocked2d it is tiled, and at mesh 8 (T = 3
    tiles a strip) both packages refuse the tiled window."""
    jm = jmesh.rectangle_mesh((-2, -2), (2, 2), nx=32)
    p = tkpp.build(tkpp.KPPConfig(mesh_size=8, backend="ell",
                                  ell_matvec_backend="blocked"),
                   device="cpu")
    rj = jmesh.reorder_mesh(jm, jmesh.rcm_permutation(jm))
    assert np.array_equal(p.host_mesh.cells, rj.cells)
    cfg = dict(mesh_size=8, backend="ell", ell_matvec_backend="blocked2d")
    with pytest.raises(jblk.WindowCoverageError):
        jkpp.build(jkpp.KPPConfig(**cfg))
    with pytest.raises(tblk.WindowCoverageError, match="T=3"):
        tkpp.build(tkpp.KPPConfig(**cfg), device="cpu")


@pytest.mark.parametrize("over", [dict(), dict(stabilization="si"),
                                  dict(smooth_l=2.0)],
                         ids=["rv", "si", "smoothing"])
def test_blocked2d_matches_gather_through_slots(over):
    m = tmesh.irregular_mesh((-2, -2), (2, 2), nx=60, seed=1)
    mt, slot = tile_mesh(m)
    cfg = dict(dtype="float64", dt=0.005, T=0.02, backend="ell", **FIXED,
               **over)
    ref = tkpp.build(tkpp.KPPConfig(**cfg), host_mesh=m,
                     device="cpu").solve().u.numpy()
    p = tkpp.build(tkpp.KPPConfig(**cfg, ell_matvec_backend="blocked2d"),
                   host_mesh=mt, device="cpu")
    assert p.plan.row_valid is not None
    u = p.solve().u.numpy()
    assert np.isfinite(u).all()
    np.testing.assert_allclose(u[slot], ref, rtol=0, atol=TOL)
