"""The hand-written ELL kernels of the unstructured fast path (csrc/ell.cu,
ops/ell_kernels.py) on the card against their plain PyTorch versions, and
the banded / blocked / blocked2d paths on the card against the same code on
the CPU. Marked ``cuda``: every test takes the ``cuda`` fixture, which
skips when no CUDA device is present. On a machine with a card:
``python -m pytest --noconftest tests/test_torch_cuda_blocked.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from conservation_fem_tpu_torch.models import burgers, kpp
from conservation_fem_tpu_torch.models import linear_advection as la
from conservation_fem_tpu_torch.ops import _build, assembly
from conservation_fem_tpu_torch.ops import ell_kernels as ek
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import spaces
from conservation_fem_tpu_torch.ops.tiling import tile_mesh

pytestmark = pytest.mark.cuda

F64_TOL = 1e-11
F32_RTOL = 1e-5
RUN_TOL = 1e-10
FIXED = dict(modified_newton=True, cg_iters=10, newton_iters=3,
             newton_linear_iters=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def irr():
    m = tmesh.irregular_mesh((-2, -2), (2, 2), nx=40, seed=1)
    return tmesh.reorder_mesh(m, tmesh.rcm_permutation(m))


def _arrays(host, dtype, device):
    return tmesh.with_kernel_index(host.device_arrays(dtype, device))


def _close(got, ref, dtype):
    got, ref = got.double().cpu(), ref.double().cpu()
    if dtype == torch.float64:
        torch.testing.assert_close(got, ref, rtol=0, atol=F64_TOL)
    else:
        scale = ref.abs().max().item() or 1.0
        assert (got - ref).abs().max().item() <= F32_RTOL * scale


def _fields(n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.uniform(0.5, 3.0, n), dtype=dtype,
                            device=device) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("constrained", [False, True])
def test_ell_spmv(cuda, irr, dtype, constrained):
    m = _arrays(irr, dtype, cuda)
    x, _, _, _ = _fields(irr.n_nodes, dtype, cuda)
    A = assembly.assemble_stiffness(m)
    before = _build.launches["ell_spmv"]
    y = ek.ell_spmv(m, A, x, constrained)
    assert _build.launches["ell_spmv"] == before + 1
    _close(y, ek.ell_spmv_plain(m, A, x, constrained), dtype)
    assert torch.equal(y, ek.ell_spmv(m, A, x, constrained))


def _spmv_case(case, dtype, device):
    """(mesh arrays, ELL matrix) of kernel A's tile edges: "odd" irr nx 40
    (N 1681, not a multiple of the tile; K 9), "even" the same padded to K
    10 (a slot of the row's own index and value 0: the padded stride),
    "tiny" irr nx 8 (N 81, under one tile), "p2" / "p3" the P2 / P3
    spaces of irr nx 12 (K 19, 37)."""
    if case in ("p2", "p3"):
        sp = spaces.build_space(tmesh.irregular_mesh(nx=12, seed=2),
                                int(case[1]))
        m = tmesh.with_kernel_index(sp.device_arrays(dtype, device))
    else:
        host = tmesh.irregular_mesh((-2, -2), (2, 2),
                                    nx=8 if case == "tiny" else 40, seed=1)
        a = host.device_arrays(dtype, device)
        if case == "even":
            rows = torch.arange(a.patch_cols.shape[0], device=device)
            a = a._replace(
                patch_cols=torch.cat([a.patch_cols, rows[:, None]], 1),
                patch_mask=torch.cat([a.patch_mask,
                                      torch.zeros_like(rows[:, None],
                                                       dtype=torch.bool)],
                                     1))
        m = tmesh.with_kernel_index(a)
    g = torch.Generator(device="cpu").manual_seed(5)
    A = torch.rand(m.patch_cols.shape, generator=g, dtype=dtype) - 0.5
    A = torch.where(m.patch_mask.cpu(), A, 0.0).to(device)
    return m, A


@pytest.mark.parametrize("columns", ["int16", "int32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["odd", "even", "tiny", "p2", "p3"])
def test_ell_spmv_tiles(cuda, case, dtype, columns):
    """Kernel A at its tile edges, both modes, on the int16 column codes
    (read where K is odd) and on the int32 flagged columns: in f32
    bit-equal to its plain version on the CPU (the same slot order and
    rounded products), in f64 within F64_TOL; bc rows equal to x;
    repeated launches equal."""
    m, A = _spmv_case(case, dtype, cuda)
    assert m.patch_cols_d16 is not None
    if columns == "int32":
        m = m._replace(patch_cols_d16=None)
    n, K = m.patch_cols.shape
    assert (K % 2 == 0) == (case == "even")
    cols = ek.spmv_columns(m)
    assert cols.element_size() == (2 if columns == "int16" and K % 2
                                   else 4)
    if case != "tiny":
        assert n % ek.tile_plan(K, A.element_size(),
                                cols.element_size()).rows
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    mc = type(m)(*(t.cpu() if torch.is_tensor(t) else t for t in m))
    bc = m.boundary_mask
    for constrained in (False, True):
        y = ek.ell_spmv(m, A, x, constrained)
        ref = ek.ell_spmv_plain(mc, A.cpu(), x.cpu(), constrained)
        if dtype == torch.float32:
            assert torch.equal(y.cpu(), ref)
        else:
            _close(y, ref, dtype)
        if constrained:
            assert torch.equal(y[bc], x[bc])
        assert torch.equal(ek.ell_spmv(m, A, x, constrained), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx", [8, 41])
def test_p1_newton_locals_tiles(cuda, nx, dtype):
    """Kernel C where the cells are not a multiple of its tile (irr nx 41:
    3362 cells) or under one tile (nx 8: 128 cells, one whole tile; the
    rhs-only launch too): within the gates of its plain version."""
    host = tmesh.irregular_mesh((-2, -2), (2, 2), nx=nx, seed=1)
    m = _arrays(host, dtype, cuda)
    u, eps, _, _ = _fields(host.n_nodes, dtype, cuda, seed=7)
    eps = eps * 1e-2
    M = host.n_cells
    assert nx == 8 or M % ek.LOCALS_CELLS
    rhs, jac = ek.p1_newton_locals(m, u, eps, 0.005, kpp.FLUX, True)
    rr, jr = ek.p1_newton_locals_plain(m, u, eps, 0.005, kpp.FLUX, True)
    _close(rhs, rr, dtype)
    _close(jac, jr, dtype)
    rhs2, _ = ek.p1_newton_locals(m, u, None, 0.005, kpp.FLUX)
    _close(rhs2, ek.p1_newton_locals_plain(m, u, None, 0.005, kpp.FLUX,
                                           False)[0], dtype)


def _assemble_case(case, irr, dtype, device):
    """(mesh arrays, nd) of kernel B's tile edges: "odd" irr nx 40 RCM
    (many tiles, the last one short), "tiny" irr nx 8 (one tile), "tiled"
    the tile-slot mesh of irr nx 40 (phantom slots: empty segments), "p2"
    / "p3" the P2 / P3 spaces of irr nx 12 (K 19, 37)."""
    if case in ("p2", "p3"):
        sp = spaces.build_space(tmesh.irregular_mesh(nx=12, seed=2),
                                int(case[1]))
        return tmesh.with_kernel_index(sp.device_arrays(dtype, device)), \
            sp.nloc
    host = irr
    if case == "tiny":
        host = tmesh.irregular_mesh((-2, -2), (2, 2), nx=8, seed=1)
    elif case == "tiled":
        host, _ = tile_mesh(tmesh.irregular_mesh((-2, -2), (2, 2), nx=40,
                                                 seed=1))
    return _arrays(host, dtype, device), 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["odd", "tiny", "tiled", "p2", "p3"])
def test_ell_assemble(cuda, irr, dtype, case):
    """Kernel B at its tile edges, matrix and vector mode: bit-equal to its
    plain version on the CPU (which sums each segment in the kernel's
    order) and to the card's within the dtype's gate; repeated launches
    give the same bits."""
    m, nd = _assemble_case(case, irr, dtype, cuda)
    M = m.mat_perm.numel() // (nd * nd)
    cap = ek.assemble_plan(m.patch_cols.shape[1], 4).cap
    sizes = m.mat_tile32[1:, 1] - m.mat_tile32[:-1, 1]
    assert (m.mat_tile32.shape[0] == 2) == (case == "tiny")
    assert bool((sizes <= cap - 8).all())
    g = torch.Generator(device="cpu").manual_seed(nd)
    mats = torch.rand((M, nd, nd), generator=g, dtype=dtype).to(cuda)
    vecs = torch.rand((M, nd), generator=g, dtype=dtype).to(cuda)
    before = _build.launches["ell_assemble"]
    A = ek.assemble_matrix(m, mats)
    v = ek.assemble_vector(m, vecs)
    assert _build.launches["ell_assemble"] == before + 2
    _close(A, assembly.scatter_matrix(m, mats), dtype)
    _close(v, assembly.scatter_vector(m, vecs), dtype)
    mc = type(m)(*(t.cpu() if torch.is_tensor(t) else t for t in m))
    assert torch.equal(A.cpu(), assembly.scatter_matrix(mc, mats.cpu()))
    assert torch.equal(v.cpu(), assembly.scatter_vector(mc, vecs.cpu()))
    assert torch.equal(A, ek.assemble_matrix(m, mats))
    assert torch.equal(v, ek.assemble_vector(m, vecs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flux", [kpp.FLUX, burgers.FLUX],
                         ids=["kpp", "burgers"])
@pytest.mark.parametrize("eps_on", [False, True])
def test_p1_newton_locals(cuda, irr, dtype, flux, eps_on):
    m = _arrays(irr, dtype, cuda)
    u, eps, _, _ = _fields(irr.n_nodes, dtype, cuda, seed=3)
    eps = eps * 1e-2 if eps_on else None
    key = _build.launch_key("p1_newton_locals", flux.name)
    before = _build.launches[key]
    rhs, jac = ek.p1_newton_locals(m, u, eps, 0.005, flux, jacobian=True)
    assert _build.launches[key] == before + 1
    rr, jr = ek.p1_newton_locals_plain(m, u, eps, 0.005, flux, True)
    _close(rhs, rr, dtype)
    _close(jac, jr, dtype)
    rhs2, none = ek.p1_newton_locals(m, u, eps, 0.005, flux)
    assert none is None and torch.equal(rhs2, rhs)


@pytest.mark.parametrize("columns", ["int16", "int32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flux", [kpp.FLUX, burgers.FLUX],
                         ids=["kpp", "burgers"])
@pytest.mark.parametrize("case", ["odd", "tiny", "even", "tiled"])
def test_ell_rv_epsilon(cuda, case, flux, dtype, columns):
    """Kernel D at its tile edges, on the int16 column codes (read where K
    is odd) and on patch_cols32: "odd" irr nx 40 (N 1681, not a multiple
    of the tile), "tiny" irr nx 8 (N 81, under one tile), "even" irr nx 40
    padded to an even K (int32 columns copied into padded rows), "tiled"
    its tile-slot mesh (phantom slots write 0); bit-equal to its plain
    version in f32 and f64."""
    host = tmesh.irregular_mesh((-2, -2), (2, 2),
                                nx=8 if case == "tiny" else 40, seed=1)
    valid = None
    if case == "tiled":
        host, _ = tile_mesh(host)
        valid = torch.as_tensor(host.slot_valid, device=cuda)
    if case == "even":
        m, _ = _spmv_case("even", dtype, cuda)
    else:
        m = _arrays(host, dtype, cuda)
    if columns == "int32":
        m = m._replace(patch_cols_d16=None)
    n, K = m.patch_cols.shape
    assert (ek.rv_columns(m).element_size() == 2) == (
        columns == "int16" and K % 2 == 1)
    assert (n < ek.TILE_ROWS) == (case == "tiny")
    u_n, rh, uh, h = _fields(n, dtype, cuda, seed=4)
    rh = rh - 1.75
    abs_term = (uh - uh.mean()).abs().max()
    key = _build.launch_key("ell_rv_epsilon", flux.name)
    before = _build.launches[key]
    eps = ek.ell_rv_epsilon(m, 0.5, 4.0, u_n, rh, uh, h * 0.05, abs_term,
                            flux, valid)
    assert _build.launches[key] == before + 1
    ref = ek.ell_rv_epsilon_plain(m, 0.5, 4.0, u_n, rh, uh, h * 0.05,
                                  abs_term, flux, valid)
    assert torch.isfinite(eps).all()
    assert torch.equal(eps, ref)
    if valid is not None:
        assert not eps[~valid].any()
    assert torch.equal(ek.ell_rv_epsilon(m, 0.5, 4.0, u_n, rh, uh, h * 0.05,
                                         abs_term, flux, valid), eps)


@pytest.mark.parametrize("backend", ["banded", "blocked", "blocked2d"])
@pytest.mark.parametrize("stabilization", ["rv", "si"])
def test_kpp_blocked_card_matches_cpu(cuda, irr, backend, stabilization):
    host, slot = irr, None
    if backend == "blocked2d":
        host, slot = tile_mesh(tmesh.irregular_mesh((-2, -2), (2, 2), nx=40,
                                                    seed=1))
    cfg = kpp.KPPConfig(stabilization=stabilization, backend="ell",
                        dt=0.01, T=0.03, ell_matvec_backend=backend, **FIXED)
    _build.launches.clear()
    got = kpp.build(cfg, device=cuda, host_mesh=host).solve().u
    assert _build.launches["ell_spmv"] > 0
    if backend != "banded":
        assert _build.launches["ell_assemble"] > 0
        assert _build.launches["p1_newton_locals"] > 0
    ref = kpp.build(cfg, device="cpu", host_mesh=host).solve().u
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=RUN_TOL)


def test_pk_and_advection_blocked_card_matches_cpu(cuda):
    """P2 SI Burgers and linear advection rv_node on the blocked backend:
    the card against the CPU, f64, a few steps."""
    cfg = burgers.BurgersConfig(mesh_size=8, degree=2, stabilization="si",
                                T=0.05, ell_matvec_backend="blocked")
    _build.launches.clear()
    got = burgers.build(cfg, device=cuda).solve().u
    assert _build.launches["ell_spmv"] and _build.launches["ell_assemble"]
    ref = burgers.build(cfg, device="cpu").solve().u
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=RUN_TOL)
    acfg = la.AdvectionConfig(mesh_size=8, T=0.05, stabilization="rv_node",
                              ell_matvec_backend="blocked")
    got = la.solve(la.build(acfg, device=cuda)).u
    ref = la.solve(la.build(acfg, device="cpu")).u
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=RUN_TOL)
