"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, with the launch counters. Marked ``cuda``: every test takes the
``cuda`` fixture, which skips when no CUDA device is present (the card
is looked for when a test runs, never at import). On a machine with a
card: ``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m
cuda`` (the suite's conftest imports JAX, which that machine need not
have). The block-mode kernels of the sharded path are here too: against
their plain version on every row of a block, against the single kernel on
the owned rows, and through ShardedFusedStructured.

f64 bound 1e-11: kernel and plain version sum in different orders (the
bound of the JAX package's own fused identity tests); 1e-10 for the tiled
kernel (the JAX package's bound for its tiled BiCGStab kernel,
test_pallas_tiled.py); f32 is checked loosely (1e-3 relative) since
reduction order is chaotic there."""

import dataclasses

import numpy as np
import pytest
import torch

from conservation_fem_tpu_torch.models import kpp
from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops import fused_step as fs
from conservation_fem_tpu_torch.ops import stencil_kernels as sk
from conservation_fem_tpu_torch.ops import tiled_step as ts

pytestmark = pytest.mark.cuda

F64_TOL = 1e-11
BENCH = dict(cg_iters=6, newton_iters=2, newton_linear_iters=4,
             modified_newton=True, newton_final_residual=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_matvec_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    coef = torch.tensor(rng.normal(size=(7, 65, 65)), dtype=dtype,
                        device=cuda)
    x = torch.tensor(rng.normal(size=(65, 65)), dtype=dtype, device=cuda)
    before = _build.launches["stencil_matvec"]
    y = sk.stencil_matvec(coef, x)
    assert _build.launches["stencil_matvec"] == before + 1
    tol = F64_TOL if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(y, sk.stencil_matvec_plain(coef, x), rtol=0,
                               atol=tol)


def test_kernel_wrappers_check_inputs(cuda):
    x = torch.zeros((9, 9), device=cuda)
    with pytest.raises(TypeError):
        sk.stencil_matvec(torch.zeros((7, 9, 9), device=cuda,
                                      dtype=torch.float64), x)
    with pytest.raises(ValueError):
        sk.stencil_matvec(torch.zeros((7, 9, 8), device=cuda), x)
    with pytest.raises(ValueError):
        sk.stencil_matvec(torch.zeros((7, 9, 9), device=cuda), x.t())
    with pytest.raises(ValueError):
        sk.stencil_matvec(torch.zeros((7, 9, 9)), x)


def _problem(cuda, mesh_size, dtype, **over):
    return kpp.build(kpp.KPPConfig(mesh_size=mesh_size, dtype=dtype,
                                   **{**BENCH, **over}), device=cuda)


def test_cg_solve_kernel_matches_plain(cuda):
    p = _problem(cuda, 16, "float64", T=0.0)
    sd = p.sd
    x_true = torch.tensor(np.random.default_rng(1).normal(size=sd.bc2.shape),
                          dtype=torch.float64, device=cuda)
    b = torch.where(sd.bc2, 0.0, sk.stencil_matvec_plain(
        sd.M_coef, torch.where(sd.bc2, 0.0, x_true)))
    args = (sd.M_coef, b, sd.bc2, sd.diagM2)
    before = _build.launches["cg_solve"]
    x = sk.cg_solve(*args, rtol=1e-10)
    assert _build.launches["cg_solve"] == before + 1
    torch.testing.assert_close(x, sk.cg_solve_plain(*args, rtol=1e-10),
                               rtol=0, atol=F64_TOL)


def _mass_case(cuda, nx, ny, dtype, seed=2):
    """(mass planes, b, frame mask, diagonal) of the unit square's nx x ny
    mesh in dtype, b = M x_true pinned to 0 on the frame, x_true ~ N(0, 1):
    the solution is O(1), so an absolute bound is a relative one."""
    from conservation_fem_tpu_torch.ops import mesh as pm
    from conservation_fem_tpu_torch.ops import structured as st

    dt = getattr(torch, dtype)
    sd = st.build_structured(pm.rectangle_mesh(nx=nx, ny=ny), nx, ny, dt,
                             cuda)
    x_true = torch.tensor(np.random.default_rng(seed).normal(
        size=sd.bc2.shape), dtype=dt, device=cuda)
    b = torch.where(sd.bc2, 0.0, sk.stencil_matvec_plain(
        sd.M_coef, torch.where(sd.bc2, 0.0, x_true)))
    return sd.M_coef, b, sd.bc2, sd.diagM2


# (instance, CTAs, resident): the cluster sizes 1, 2, 8, 16 and the grid,
# its bands in shared memory and not, 36 bands of exactly n1y + 1 nodes
CG_FORCED = [("cluster", 1, True), ("cluster", 2, True),
             ("cluster", 8, True), ("cluster", 16, True),
             ("grid", 36, True), ("grid", 36, False), ("grid", 7, True)]


def _cg_plan(b, instance, ctas, resident):
    return sk.cg_plan(*b.shape, b.element_size(), 132, instance=instance,
                      ctas=ctas, resident=resident)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("instance,ctas,resident", CG_FORCED)
def test_cg_solve_instances_match_plain(cuda, instance, ctas, resident,
                                        dtype):
    """Each instance of the cg_solve kernel forced on a thin 40 x 9 grid
    (uneven bands of 22 and 23 nodes at 16 CTAs, of 10 = n1y + 1 at 36,
    51 and 52 at 7), f64 and f32, against the plain version at rtol 1e-10
    (f32: 1e-5); each launch counted once and repeated bit for bit."""
    args = _mass_case(cuda, 39, 8, dtype)
    plan = _cg_plan(args[1], instance, ctas, resident)
    rtol = 1e-10 if dtype == "float64" else 1e-5
    before = _build.launches["cg_solve"]
    x = sk.cg_solve(*args, rtol=rtol, plan=plan)
    assert _build.launches["cg_solve"] == before + 1
    torch.testing.assert_close(x, sk.cg_solve_plain(*args, rtol=rtol),
                               rtol=0, atol=_tol(dtype))
    assert torch.equal(x, sk.cg_solve(*args, rtol=rtol, plan=plan))


@pytest.mark.parametrize("instance,ctas,resident", CG_FORCED)
def test_cg_solve_instances_at_the_edges(cuda, instance, ctas, resident):
    """maxiter = 0 returns x0 = where(bc, b, 0) exactly; rtol = 0 runs to
    maxiter (25, past convergence to roundoff) as the plain version does;
    on a grid whose every node is Dirichlet the solve returns b."""
    M, b, bc, d = _mass_case(cuda, 39, 8, "float64")
    plan = _cg_plan(b, instance, ctas, resident)
    x = sk.cg_solve(M, b, bc, d, rtol=1e-10, maxiter=0, plan=plan)
    assert torch.equal(x, torch.where(bc, b, 0.0))
    for maxiter in (3, 25):
        x = sk.cg_solve(M, b, bc, d, rtol=0.0, maxiter=maxiter, plan=plan)
        torch.testing.assert_close(
            x, sk.cg_solve_plain(M, b, bc, d, rtol=0.0, maxiter=maxiter),
            rtol=0, atol=F64_TOL)
    g = b + 1.0
    every = torch.ones_like(bc)
    assert torch.equal(sk.cg_solve(M, g, every, d, rtol=1e-10, plan=plan), g)


def test_cg_solve_hand_made_plans(cuda):
    """The kernel works out each band and its shared memory from the grid,
    the CTAs and the instance: a plan whose cap and smem understate them
    gives the honest plan's bits, and one whose band the card cannot hold
    in shared memory (one CTA for a 101 x 101 grid in f64) raises instead
    of running past the CTA's shared memory."""
    args = _mass_case(cuda, 39, 8, "float64")
    for instance, ctas, resident in (("cluster", 8, True),
                                     ("grid", 7, True)):
        plan = _cg_plan(args[1], instance, ctas, resident)
        x = sk.cg_solve(*args, rtol=1e-10, plan=plan)
        assert torch.equal(x, sk.cg_solve(*args, rtol=1e-10,
                                          plan=dict(plan, cap=1, smem=0)))
    big = _mass_case(cuda, 100, 100, "float64")
    for instance in ("cluster", "grid"):
        plan = dict(_cg_plan(big[1], instance, 16, True), ctas=1, smem=1024)
        with pytest.raises(RuntimeError):
            sk.cg_solve(*big, rtol=1e-10, plan=plan)


def test_cg_solve_default_plans(cuda):
    """The wrapper's own plans: the cluster instance on the Burgers
    reference shape of mesh 50 and the grid instance on KPP mesh 64, f64,
    each within 1e-11 of the plain version."""
    for n, instance in ((50, "cluster"), (256, "grid")):
        args = _mass_case(cuda, n, n, "float64")
        plan = sk.card_cg_plan(args[1].device, n + 1, n + 1, torch.float64)
        assert plan["instance"] == instance
        torch.testing.assert_close(sk.cg_solve(*args, rtol=1e-12),
                                   sk.cg_solve_plain(*args, rtol=1e-12),
                                   rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("solver,frozen,stabilization,scheme", [
    ("bicgstab", True, "rv", "bdf2"), ("bicgstab", False, "rv", "bdf2"),
    ("cheby", True, "rv", "bdf2"), ("bicgstab", True, "gfem", "bdf2"),
    ("bicgstab", True, "rv", "bdf1")])
def test_fused_rv_step_kernel_matches_plain(cuda, solver, frozen,
                                            stabilization, scheme):
    p = _problem(cuda, 8, "float64", T=0.2)
    u = p.solve().u.reshape(p._shape2)
    g2 = torch.full_like(u, np.pi / 4)
    kw = dict(p.fused_step_kwargs(),
              cg_iters=6 if solver == "bicgstab" else 10,
              lin_iters=4 if solver == "bicgstab" else 16,
              freeze_jacobian=frozen, inner_solver=solver, n_substeps=3,
              stabilization=stabilization, residual_scheme=scheme)
    before = _build.launches["fused_rv_step"]
    out = fs.fused_rv_step(u, u, u, g2, p.sd.M_coef, **kw)
    assert _build.launches["fused_rv_step"] == before + 1
    ref = fs.fused_rv_step_plain(u, u, u, g2, p.sd.M_coef, **kw)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=F64_TOL)


def test_main_path_goes_through_the_fused_kernel(cuda):
    """One fused launch per step on the bench config, and the f32 result
    stays within 1e-3 of the plain composed path after 10 steps."""
    p = _problem(cuda, 16, "float32", T=0.1, use_kernels=True)
    before = _build.launches["fused_rv_step"]
    u = p.solve().u
    assert _build.launches["fused_rv_step"] == before + p.num_steps
    q = _problem(cuda, 16, "float32", T=0.1)
    v = q.solve().u
    assert float((u - v).norm() / v.norm()) < 1e-3


def test_kernels_repeat_bit_for_bit(cuda):
    """The cooperative kernels reduce in a fixed order: two launches on the
    same inputs give identical bits."""
    p = _problem(cuda, 16, "float32", T=0.1, use_kernels=True)
    a = p.solve().u
    b = p.solve().u
    assert torch.equal(a, b)
    sd = p.sd
    rhs = torch.where(sd.bc2, 0.0, torch.ones_like(sd.diagM2))
    x1 = sk.cg_solve(sd.M_coef, rhs, sd.bc2, sd.diagM2, rtol=1e-5)
    x2 = sk.cg_solve(sd.M_coef, rhs, sd.bc2, sd.diagM2, rtol=1e-5)
    assert torch.equal(x1, x2)
    # the tiled kernel, its two stages wrapping over many tiles per block
    q = _problem(cuda, 64, "float32", T=0.0)
    u2 = q.u0.reshape(q._shape2)
    args = (u2, u2, u2, torch.full_like(u2, np.pi / 4), q.sd.M_coef)
    kw = q.fused_step_kwargs()
    t1 = ts.tiled_rv_step(*args, tile_rows=1, **kw)
    t2 = ts.tiled_rv_step(*args, tile_rows=1, **kw)
    assert torch.equal(t1, t2)
    # the split step on the same pipeline, its default plan and 1-row tiles
    for rows in (None, 1):
        s1 = fs.fused_rv_step_split(*args, tile_rows=rows, **kw)
        s2 = fs.fused_rv_step_split(*args, tile_rows=rows, **kw)
        assert torch.equal(s1, s2)


def _state(cuda, mesh_size):
    """A mid-trajectory f64 history at mesh_size: (problem, u, u_old,
    u_old_old, g); dt = 0.01 min(1, 64 / mesh_size), the bench's CFL-matched
    step (0.01 up to mesh 64)."""
    p = _problem(cuda, mesh_size, "float64", T=0.2,
                 dt=0.01 * min(1.0, 64 / mesh_size))
    carry = (p.solve().u,) * 3
    for _ in range(2):
        carry, _ = p.step(carry, p.dt)
    u2, uo2, uoo2 = (v.reshape(p._shape2) for v in carry)
    return p, u2, uo2, uoo2, torch.full_like(u2, np.pi / 4)


@pytest.mark.parametrize("solver,frozen", [("bicgstab", True),
                                           ("cheby", False)])
def test_split_kernels_match_plain_stages(cuda, solver, frozen):
    """Each split kernel against its plain stage on the same inputs, and
    the whole split step against the single kernel; 1 + newton_iters
    launches per step."""
    p, u2, uo2, uoo2, g2 = _state(cuda, 8)
    kw = dict(p.fused_step_kwargs(), inner_solver=solver,
              freeze_jacobian=frozen, newton_iters=3,
              cg_iters=6 if solver == "bicgstab" else 10,
              lin_iters=4 if solver == "bicgstab" else 16)
    s = fs.step_args("test", kw)
    sd, body = fs._plain_data(u2, p.sd.M_coef, s), fs._body_kw(s)
    before = dict(_build.launches)
    setup = fs.split_setup(u2, uo2, uoo2, g2, p.sd.M_coef, **kw)
    for a, b in zip(setup, fs._split_setup_plain(sd, u2, uo2, uoo2, g2,
                                                 **body)):
        torch.testing.assert_close(a, b, rtol=0, atol=F64_TOL)
    Kc, aux, uk, F = setup
    new = fs.split_newton(uk, F, u2, g2, p.sd.M_coef, Kc, aux, uk, **kw)
    for a, b in zip(new, fs._split_newton_plain(sd, uk, F, u2, g2, Kc, aux,
                                                uk, **body)):
        torch.testing.assert_close(a, b, rtol=0, atol=F64_TOL)
    out = fs.fused_rv_step_split(u2, uo2, uoo2, g2, p.sd.M_coef, **kw)
    assert _build.launches["split_setup"] == before.get("split_setup", 0) + 2
    assert (_build.launches["split_newton"]
            == before.get("split_newton", 0) + 1 + kw["newton_iters"])
    single = fs.fused_rv_step(u2, uo2, uoo2, g2, p.sd.M_coef, **kw)[0]
    torch.testing.assert_close(out, single, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("relinearize,residual", [(True, True),
                                                  (True, False),
                                                  (False, True),
                                                  (False, False)])
@pytest.mark.parametrize("solver", ["bicgstab", "cheby"])
def test_split_newton_keywords_match_plain_stage(cuda, solver, relinearize,
                                                 residual):
    """Mesh 16 (17 rows: two 8-row tiles and a ragged one), f64: a Newton
    launch with each pair of keywords against the plain stage. Without
    relinearisation the launch takes the Jacobian that a launch at the same
    w left in the same scratch; without the residual it returns none."""
    p, u2, uo2, uoo2, g2 = _state(cuda, 16)
    Mc = p.sd.M_coef
    kw = dict(p.fused_step_kwargs(), inner_solver=solver,
              cg_iters=6 if solver == "bicgstab" else 10,
              lin_iters=4 if solver == "bicgstab" else 16)
    s = fs.step_args("test", kw)
    sd, body = fs._plain_data(u2, Mc, s), fs._body_kw(s)
    scr = fs.new_scratch(u2.dtype, u2.device, *u2.shape)
    Kc, aux, uk, F = fs.split_setup(u2, uo2, uoo2, g2, Mc, scratch=scr,
                                    tile_rows=8, **kw)
    for a, b in zip((Kc, aux, uk, F),
                    fs._split_setup_plain(sd, u2, uo2, uoo2, g2, **body)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
    w = uk
    # the first Newton launch of the step: it linearises at w, leaving the
    # Jacobian in the scratch
    uk1, F1 = fs.split_newton(uk, F, u2, g2, Mc, Kc, aux, w, scratch=scr,
                              tile_rows=8, **kw)
    before = _build.launches["split_newton"]
    got = fs.split_newton(uk1, F1, u2, g2, Mc, Kc, aux, w, scratch=scr,
                          tile_rows=8, relinearize=relinearize,
                          residual=residual, **kw)
    assert _build.launches["split_newton"] == before + 1
    ref = fs._split_newton_plain(sd, uk1, F1, u2, g2, Kc, aux, w,
                                 relinearize=relinearize, residual=residual,
                                 **body)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-10)
    if residual:
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-10)
    else:
        assert got[1] is None and ref[1] is None


@pytest.mark.parametrize("mesh,tile_rows", [(16, 8), (64, None)])
def test_split_step_matches_tiled_kernel_on_the_same_plan(cuda, mesh,
                                                          tile_rows):
    """The split step runs the tiled kernel's passes in its order over the
    same tiles and blocks, with the same deterministic reductions, f64,
    BiCGStab with a frozen and Chebyshev with a fresh Jacobian: the tiled
    kernel's result bit for bit."""
    p, u2, uo2, uoo2, g2 = _state(cuda, mesh)
    args = (u2, uo2, uoo2, g2, p.sd.M_coef)
    for solver, frozen in (("bicgstab", True), ("cheby", False)):
        kw = dict(p.fused_step_kwargs(), inner_solver=solver,
                  freeze_jacobian=frozen, newton_iters=3,
                  cg_iters=6 if solver == "bicgstab" else 10,
                  lin_iters=4 if solver == "bicgstab" else 16)
        split = fs.fused_rv_step_split(*args, tile_rows=tile_rows, **kw)
        tiled = ts.tiled_rv_step(*args, tile_rows=tile_rows, **kw)
        assert torch.equal(split, tiled)


@pytest.mark.parametrize("solver,frozen,newton,stabilization,scheme", [
    ("bicgstab", True, 2, "rv", "bdf2"), ("bicgstab", False, 3, "rv", "bdf2"),
    ("cheby", True, 3, "rv", "bdf2"), ("cheby", False, 2, "rv", "bdf2"),
    ("bicgstab", True, 3, "gfem", "bdf2"), ("cheby", True, 2, "rv", "bdf1")])
def test_tiled_kernel_matches_plain(cuda, solver, frozen, newton,
                                    stabilization, scheme):
    """Mesh 4 (17 rows: two 8-row tiles and a ragged one-row tile) and
    mesh 16 with the default tiles: the tiled kernel against its plain
    version and against the single kernel."""
    for mesh in (4, 16):
        p, u2, uo2, uoo2, g2 = _state(cuda, mesh)
        kw = dict(p.fused_step_kwargs(), inner_solver=solver,
                  freeze_jacobian=frozen, newton_iters=newton,
                  cg_iters=6 if solver == "bicgstab" else 10,
                  lin_iters=4 if solver == "bicgstab" else 16,
                  stabilization=stabilization, residual_scheme=scheme)
        args = (u2, uo2, uoo2, g2, p.sd.M_coef)
        before = _build.launches["tiled_rv_step"]
        out = ts.tiled_rv_step(*args, tile_rows=8 if mesh == 4 else None,
                               **kw)
        assert _build.launches["tiled_rv_step"] == before + 1
        torch.testing.assert_close(out, ts.tiled_rv_step_plain(*args, **kw),
                                   rtol=0, atol=1e-10)
        torch.testing.assert_close(out, fs.fused_rv_step(*args, **kw)[0],
                                   rtol=0, atol=1e-10)


# (name, mesh, tile_rows, dtype): the tile plans the tiled kernel's
# pipeline must get right
TILE_CASES = [
    # mesh 64 is a 257 x 257 grid. 257 rows of 1 by 5 columns of 52: 1285
    # tiles, more than twice the resident blocks, so each block's two
    # stages wrap
    ("stages wrap", 64, 1, "float64"),
    # 257 rows: 32 tiles of 8 and a ragged one; 257 columns: 5 tiles of
    # 52, the last ragged
    ("ragged row and column", 64, 8, "float64"),
    # f64 64-row tiles: two stages of 52 columns would not fit the shared
    # memory, so the tile narrows
    ("f64 narrowed", 64, 64, "float64"),
    ("f32 default", 64, None, "float32"),
]


@pytest.mark.parametrize("name,mesh,tile_rows,dtype", TILE_CASES,
                         ids=[c[0] for c in TILE_CASES])
def test_tiled_kernel_tile_plans(cuda, name, mesh, tile_rows, dtype):
    """The tiled kernel against its plain version and the single kernel on
    a mid-trajectory state, BiCGStab and Chebyshev, for each tile plan."""
    p, u2, uo2, uoo2, g2 = _state(cuda, mesh)
    dt = getattr(torch, dtype)
    args = [a.to(dt) for a in (u2, uo2, uoo2, g2, p.sd.M_coef)]
    n1 = p._shape2[0]
    plan = ts.card_plan(n1, n1, dt, tile_rows)
    if name == "stages wrap":
        assert plan["tiles"] > 2 * plan["blocks"]
    if name == "ragged row and column":
        assert n1 % plan["rows"] and n1 % plan["cols"]
    if name == "f64 narrowed":
        assert plan["cols"] < -(-n1 // -(-n1 // ts.MAX_TILE_COLS))
    tol = 1e-10 if dtype == "float64" else 1e-4
    for solver in ("bicgstab", "cheby"):
        kw = dict(p.fused_step_kwargs(), inner_solver=solver,
                  cg_iters=6 if solver == "bicgstab" else 10,
                  lin_iters=4 if solver == "bicgstab" else 16)
        before = _build.launches["tiled_rv_step"]
        out = ts.tiled_rv_step(*args, tile_rows=tile_rows, **kw)
        assert _build.launches["tiled_rv_step"] == before + 1
        torch.testing.assert_close(out, ts.tiled_rv_step_plain(*args, **kw),
                                   rtol=0, atol=tol)
        torch.testing.assert_close(out, fs.fused_rv_step(*args, **kw)[0],
                                   rtol=0, atol=tol)


def test_step_kernels_refuse_bad_arguments(cuda):
    """On CUDA tensors: block mode with BiCGStab or (rv) without abs_term,
    a flux the step kernels do not compile in (neither KPP nor Burgers) for
    every step kernel, bf16 planes with the Burgers flux in f32 (that
    instance is KPP only), and tiles of fewer than one row for the split
    kernels raise before a launch."""
    p = _problem(cuda, 4, "float64", T=0.0)
    u2 = p.u0.reshape(p._shape2)
    args = (u2, u2, u2, u2, p.sd.M_coef)
    kw = p.fused_step_kwargs()
    before = sum(_build.launches.values())
    with pytest.raises(NotImplementedError):
        ts.tiled_rv_step(*args, **kw, row0_base=0, n_rows=17, abs_term=0.0)
    burgers = dict(kw, flux=kw["flux"]._replace(name="burgers"))
    with pytest.raises(NotImplementedError, match="KPP flux only"):
        ts.tiled_rv_step(*(a.float() for a in args), bf16_planes=True,
                         **burgers)
    with pytest.raises(ValueError, match="abs_term"):
        ts.tiled_rv_step(*args, **dict(kw, inner_solver="cheby"),
                         row0_base=0, n_rows=17)
    other = dict(kw, flux=kw["flux"]._replace(name="euler"))
    for fn in (fs.fused_rv_step, fs.fused_rv_step_split, fs.split_setup,
               ts.tiled_rv_step):
        with pytest.raises(NotImplementedError, match="structured.Flux"):
            fn(*args, **other)
    block_kw = {k: v for k, v in dict(other, inner_solver="cheby").items()
                if k not in ("nx", "ny")}
    with pytest.raises(NotImplementedError, match="structured.Flux"):
        fs.fused_rv_block_step(*args, 0, 1.0, n_rows=17, n_cols=17,
                               **block_kw)
    # tiles of fewer than one row, for the split wrappers
    planes = torch.zeros((7, 17, 17), dtype=u2.dtype, device=cuda)
    aux = torch.zeros((2, 17, 17), dtype=u2.dtype, device=cuda)
    for call in (lambda: fs.split_setup(*args, tile_rows=0, **kw),
                 lambda: fs.split_newton(u2, u2, u2, u2, p.sd.M_coef, planes,
                                         aux, u2, tile_rows=0, **kw),
                 lambda: fs.fused_rv_step_split(*args, tile_rows=-1, **kw)):
        with pytest.raises(ValueError, match="tile_rows"):
            call()
    assert sum(_build.launches.values()) == before


CHEBY = dict(inner_solver="cheby", cg_iters=4, newton_linear_iters=4)


def _blocks(p, fields, n_blocks):
    """The deep-halo blocks of a decomposition of p's grid into n_blocks:
    [(row0, extended fields + mass planes)], L, D."""
    n1x = p._shape2[0]
    cfg = p.cfg
    L = -(-n1x // n_blocks)
    D = fs.required_halo(cfg.cg_iters, cfg.newton_iters,
                         cfg.newton_linear_iters)
    pad = (0, 0, D, L * n_blocks - n1x + D)
    ext = [torch.nn.functional.pad(a, pad)
           for a in list(fields) + [p.sd.M_coef]]
    return [(d * L - D, [a[..., d * L:d * L + L + 2 * D, :].contiguous()
                         for a in ext]) for d in range(n_blocks)], L, D


@pytest.mark.parametrize("stabilization,frozen,scheme", [
    ("rv", True, "bdf2"), ("rv", False, "bdf2"), ("gfem", True, "bdf2"),
    ("rv", True, "bdf1")])
def test_block_kernels_match_plain_and_single(cuda, stabilization, frozen,
                                              scheme):
    """Mesh 16 in 3 uneven blocks (rows above the grid, an interior block,
    padding rows below it), D = 32: both block-mode kernels against the
    plain version on every row, zero outside the grid, and their owned rows
    against the single kernel on the whole grid."""
    p, u2, uo2, uoo2, g2 = _state(cuda, 16)
    p.cfg = dataclasses.replace(p.cfg, **CHEBY)
    kw = dict(p.fused_step_kwargs(), stabilization=stabilization,
              freeze_jacobian=frozen, residual_scheme=scheme)
    whole = fs.fused_rv_step(u2, uo2, uoo2, g2, p.sd.M_coef, **kw)[0]
    abs_term = (u2 - u2.mean()).abs().max().reshape(1)
    blocks, L, D = _blocks(p, (u2, uo2, uoo2, g2), 3)
    n1x, n1y = p._shape2
    bkw = {k: v for k, v in kw.items() if k not in ("nx", "ny")}
    for d, (row0, ext) in enumerate(blocks):
        before = dict(_build.launches)
        got_b = fs.fused_rv_block_step(*ext, row0, abs_term, n_rows=n1x,
                                       n_cols=n1y, **bkw)
        got_t = ts.tiled_rv_step(*ext, row0_base=row0, n_rows=n1x,
                                 abs_term=abs_term, tile_rows=8, **bkw)
        assert (_build.launches["fused_rv_block_step"]
                == before.get("fused_rv_block_step", 0) + 1)
        assert (_build.launches["tiled_rv_step_block"]
                == before.get("tiled_rv_step_block", 0) + 1)
        assert (_build.launches["tiled_rv_step"]
                == before.get("tiled_rv_step", 0))
        ref = fs.fused_rv_block_step_plain(*ext, row0, abs_term, n_rows=n1x,
                                           n_cols=n1y, **bkw)
        own = slice(D, D + min(L, n1x - d * L))
        for got in (got_b, got_t):
            torch.testing.assert_close(got, ref, rtol=0, atol=F64_TOL)
            torch.testing.assert_close(got[own],
                                       whole[d * L:d * L + own.stop - D],
                                       rtol=0, atol=F64_TOL)
        outside = torch.ones(L + 2 * D, dtype=torch.bool)
        outside[max(0, -row0):min(L + 2 * D, n1x - row0)] = False
        assert outside.any()
        assert not got_b[outside].any() and not got_t[outside].any()


@pytest.mark.parametrize("tile_rows", [None, 1])
def test_tiled_block_mode_first_and_last_block(cuda, tile_rows):
    """Block mode of the tiled kernel on the first and last of 4 blocks of
    mesh 64 (rows above the grid; padding rows below it), f64, default
    tiles and 1-row tiles (two stages wrapping): against the plain version
    on every row and the single kernel on the owned rows."""
    p, u2, uo2, uoo2, g2 = _state(cuda, 64)
    p.cfg = dataclasses.replace(p.cfg, **CHEBY)
    kw = p.fused_step_kwargs()
    whole = fs.fused_rv_step(u2, uo2, uoo2, g2, p.sd.M_coef, **kw)[0]
    abs_term = (u2 - u2.mean()).abs().max().reshape(1)
    blocks, L, D = _blocks(p, (u2, uo2, uoo2, g2), 4)
    n1x, n1y = p._shape2
    bkw = {k: v for k, v in kw.items() if k not in ("nx", "ny")}
    for d in (0, 3):
        row0, ext = blocks[d]
        got = ts.tiled_rv_step(*ext, row0_base=row0, n_rows=n1x,
                               abs_term=abs_term, tile_rows=tile_rows, **bkw)
        ref = fs.fused_rv_block_step_plain(*ext, row0, abs_term, n_rows=n1x,
                                           n_cols=n1y, **bkw)
        torch.testing.assert_close(got, ref, rtol=0, atol=F64_TOL)
        own = slice(D, D + min(L, n1x - d * L))
        torch.testing.assert_close(got[own],
                                   whole[d * L:d * L + own.stop - D],
                                   rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("solver,frozen,tile_rows", [
    ("bicgstab", True, 8), ("cheby", False, 1), ("cheby", True, None)])
def test_tiled_bf16_kernel_matches_plain(cuda, solver, frozen, tile_rows):
    """The tiled kernel's bf16-plane instance against its plain version, f32
    mid-trajectory state at mesh 64 (257 columns: odd, so the bf16 planes'
    rows are padded to 258), whole grid, then block mode on the first and
    an interior block of 4 (Chebyshev); 1e-4 of max|plain|, one launch of
    each bf16 key per call. At f64 the flag launches the f64 instance under
    its own key, bit for bit the call without it."""
    p, *f64 = _state(cuda, 64)
    args = [a.float() for a in f64] + [p.sd.M_coef.float()]
    kw = dict(p.fused_step_kwargs(), inner_solver=solver,
              freeze_jacobian=frozen,
              cg_iters=6 if solver == "bicgstab" else 10,
              lin_iters=4 if solver == "bicgstab" else 16)
    plan = ts.card_plan(257, 257, torch.float32, tile_rows,
                        kernel="tiled_bf16")
    assert plan["cols"] % 2 == 0
    before = dict(_build.launches)
    out = ts.tiled_rv_step(*args, tile_rows=tile_rows, bf16_planes=True,
                           **kw)
    assert _build.launches["tiled_rv_step_bf16"] == before.get(
        "tiled_rv_step_bf16", 0) + 1
    ref = ts.tiled_rv_step_plain(*args, bf16_planes=True, **kw)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    f32 = ts.tiled_rv_step(*args, tile_rows=tile_rows, **kw)
    assert float((out - f32).abs().max()) > 0
    # the bf16 mass planes made once by the caller: the same launch
    torch.testing.assert_close(
        ts.tiled_rv_step(*args, tile_rows=tile_rows, bf16_planes=True,
                         mc16=ts.bf16_planes_of(args[4]), **kw),
        out, rtol=0, atol=0)
    f64_args = list(f64) + [p.sd.M_coef]
    n = _build.launches["tiled_rv_step"]
    torch.testing.assert_close(
        ts.tiled_rv_step(*f64_args, tile_rows=tile_rows, bf16_planes=True,
                         **kw),
        ts.tiled_rv_step(*f64_args, tile_rows=tile_rows, **kw), rtol=0,
        atol=0)
    assert _build.launches["tiled_rv_step"] == n + 2
    if solver != "cheby":
        return
    u2 = args[0]
    abs_term = (u2 - u2.mean()).abs().max().reshape(1)
    blocks, L, D = _blocks(p, args[:4], 4)
    bkw = {k: v for k, v in kw.items() if k not in ("nx", "ny")}
    for d in (0, 1):
        row0, ext = blocks[d]
        ext = [a.float() for a in ext]
        got = ts.tiled_rv_step(*ext, row0_base=row0, n_rows=257,
                               abs_term=abs_term, tile_rows=tile_rows,
                               bf16_planes=True, **bkw)
        want = ts.tiled_rv_step_plain(*ext, row0_base=row0, n_rows=257,
                                      abs_term=abs_term, bf16_planes=True,
                                      **bkw)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    assert _build.launches["tiled_rv_step_block_bf16"] == before.get(
        "tiled_rv_step_block_bf16", 0) + 2


@pytest.mark.parametrize("kernel,n_blocks", [("block", 2), ("tiled", 2),
                                             ("block", 1), ("auto", 3)])
def test_sharded_path_launches_block_kernels(cuda, kernel, n_blocks):
    """ShardedFusedStructured over LocalBlocks on the card, mesh 16, f64, 5
    steps: one launch of the chosen kernel per block and step, none of the
    other, and the single kernel's trajectory to 1e-11."""
    from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                     ShardedFusedStructured)

    over = dict(CHEBY, T=0.05, modified_newton=True)
    p = _problem(cuda, 16, "float64", use_kernels=True, **over)
    ref = p.solve().u
    sh = ShardedFusedStructured(_problem(cuda, 16, "float64", **over),
                                LocalBlocks(n_blocks, cuda), kernel=kernel,
                                tile_rows=8 if kernel == "tiled" else None)
    _build.launches.clear()
    got = sh.solve()
    name = ("fused_rv_block_step" if sh.kernel == "block"
            else "tiled_rv_step_block")
    assert dict(_build.launches) == {name: p.num_steps * n_blocks}
    torch.testing.assert_close(got, ref, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("mode", ["split", "tiled"])
def test_main_path_dispatches_to_the_mode_kernel(cuda, monkeypatch, mode):
    """With the mode forced on a mesh-16 f32 bench problem, each step
    launches that mode's kernels, and the result stays within 1e-3 of the
    plain composed path after 10 steps."""
    p = _problem(cuda, 16, "float32", T=0.1, use_kernels=True)
    monkeypatch.setattr(type(p), "_fused_mode", lambda self: mode)
    _build.launches.clear()
    u = p.solve().u
    n = p.num_steps
    want = ({"split_setup": n, "split_newton": 2 * n} if mode == "split"
            else {"tiled_rv_step": n})
    assert dict(_build.launches) == want
    v = _problem(cuda, 16, "float32", T=0.1).solve().u
    assert float((u - v).norm() / v.norm()) < 1e-3


# -- the Burgers instances (csrc/*_burgers.cu): f' = (u, u), f'' = (1, 1),
# RV speed sqrt(2) max|u|; the fixed-iteration config of the JAX package's
# fused Burgers test, from a state with its shocks formed

BURGERS_FIXED = dict(stabilization="rv", cg_iters=10, newton_iters=2,
                     newton_linear_iters=8, modified_newton=True)


def _burgers_state(cuda, mesh_size, steps, **over):
    """(problem, u, u_old, u_old_old, g) after `steps` steps of the plain
    f64 path at mesh_size, g the Dirichlet data of the next step."""
    from conservation_fem_tpu_torch.models import burgers

    p = burgers.build(burgers.BurgersConfig(
        mesh_size=mesh_size, **{**BURGERS_FIXED, **over}), device=cuda)
    carry = (p.u0,) * 3
    times = p.step_times()
    for t in times[:steps]:
        carry, _ = p.step(carry, t)
    u2, uo2, uoo2 = (v.reshape(p._shape2) for v in carry)
    g2 = p.bc_value(p.points, times[steps]).reshape(p._shape2)
    return p, u2, uo2, uoo2, g2


def _burgers_launches(before, name, n):
    """The launch counter of `name`'s Burgers instance went up by n and its
    KPP instance's did not move."""
    key = _build.launch_key(name, "burgers")
    assert _build.launches[key] == before.get(key, 0) + n
    assert _build.launches[name] == before.get(name, 0)


@pytest.mark.parametrize("solver,frozen", [("bicgstab", True),
                                           ("cheby", False)])
def test_burgers_step_kernels_match_plain(cuda, solver, frozen):
    """Mesh 16 f64, 8 steps in: the single kernel, the split kernels (8-row
    tiles: two and a ragged one) and the tiled kernel (8-row tiles), each
    against its plain version with the Burgers flux, through its Burgers
    instance."""
    p, u2, uo2, uoo2, g2 = _burgers_state(cuda, 16, 8)
    assert float(u2.max() - u2.min()) > 1.0
    kw = dict(p.fused_step_kwargs(), inner_solver=solver,
              freeze_jacobian=frozen, newton_iters=3,
              lin_iters=8 if solver == "bicgstab" else 16)
    assert kw["flux"].name == "burgers"
    args = (u2, uo2, uoo2, g2, p.sd.M_coef)
    s = fs.step_args("test", kw)
    sd, body = fs._plain_data(u2, p.sd.M_coef, s), fs._body_kw(s)
    before = dict(_build.launches)
    out = fs.fused_rv_step(*args, **kw)
    _burgers_launches(before, "fused_rv_step", 1)
    for a, b in zip(out, fs.fused_rv_step_plain(*args, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=F64_TOL)
    scr = fs.new_scratch(u2.dtype, u2.device, *u2.shape)
    before = dict(_build.launches)
    setup = fs.split_setup(*args, scratch=scr, tile_rows=8, **kw)
    for a, b in zip(setup, fs._split_setup_plain(sd, u2, uo2, uoo2, g2,
                                                 **body)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
    Kc, aux, uk, F = setup
    new = fs.split_newton(uk, F, u2, g2, p.sd.M_coef, Kc, aux, uk,
                          scratch=scr, tile_rows=8, **kw)
    for a, b in zip(new, fs._split_newton_plain(sd, uk, F, u2, g2, Kc, aux,
                                                uk, **body)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
    _burgers_launches(before, "split_setup", 1)
    _burgers_launches(before, "split_newton", 1)
    before = dict(_build.launches)
    tiled = ts.tiled_rv_step(*args, tile_rows=8, **kw)
    _burgers_launches(before, "tiled_rv_step", 1)
    torch.testing.assert_close(tiled, ts.tiled_rv_step_plain(*args, **kw),
                               rtol=0, atol=1e-10)
    split = fs.fused_rv_step_split(*args, tile_rows=8, **kw)
    assert torch.equal(split, tiled)


def test_burgers_block_kernels_match_plain(cuda):
    """Mesh 16 f64 in 3 uneven blocks, Chebyshev: both block-mode kernels'
    Burgers instances against the plain version on every row."""
    p, u2, uo2, uoo2, g2 = _burgers_state(
        cuda, 16, 8, inner_solver="cheby", newton_linear_iters=12)
    kw = p.fused_step_kwargs()
    abs_term = (u2 - u2.mean()).abs().max().reshape(1)
    blocks, L, D = _blocks(p, (u2, uo2, uoo2, g2), 3)
    n1x, n1y = p._shape2
    bkw = {k: v for k, v in kw.items() if k not in ("nx", "ny")}
    for row0, ext in blocks:
        before = dict(_build.launches)
        got_b = fs.fused_rv_block_step(*ext, row0, abs_term, n_rows=n1x,
                                       n_cols=n1y, **bkw)
        got_t = ts.tiled_rv_step(*ext, row0_base=row0, n_rows=n1x,
                                 abs_term=abs_term, tile_rows=8, **bkw)
        _burgers_launches(before, "fused_rv_block_step", 1)
        _burgers_launches(before, "tiled_rv_step_block", 1)
        ref = fs.fused_rv_block_step_plain(*ext, row0, abs_term, n_rows=n1x,
                                           n_cols=n1y, **bkw)
        for got in (got_b, got_t):
            torch.testing.assert_close(got, ref, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("mode", ["single", "split", "tiled"])
def test_burgers_main_path_dispatches_to_the_mode_kernel(cuda, monkeypatch,
                                                         mode):
    """The Burgers fixed config at mesh 16, f64, T 0.1 with use_kernels and
    the mode forced: each step launches that mode's Burgers instance with
    the Dirichlet data of its own t, and the trajectory is the plain
    path's."""
    from conservation_fem_tpu_torch.models import burgers

    cfg = burgers.BurgersConfig(mesh_size=16, T=0.1, use_kernels=True,
                                **BURGERS_FIXED)
    p = burgers.build(cfg, device=cuda)
    monkeypatch.setattr(type(p), "_fused_mode", lambda self: mode)
    _build.launches.clear()
    u = p.solve().u
    n = p.num_steps
    key = lambda name: _build.launch_key(name, "burgers")
    want = {"single": {key("fused_rv_step"): n},
            "split": {key("split_setup"): n, key("split_newton"): 2 * n},
            "tiled": {key("tiled_rv_step"): n}}[mode]
    assert dict(_build.launches) == want
    monkeypatch.undo()
    ref = burgers.build(dataclasses.replace(cfg, use_kernels=False),
                        device=cuda).solve().u
    torch.testing.assert_close(u, ref, rtol=0, atol=1e-10)


def _band_case(cuda, flux, mesh_size, dtype, **over):
    """(problem, [u, u_old, u_old_old, g, mass planes]) of a band-kernel
    case in dtype: the KPP initial state with the default Dirichlet data,
    or Burgers 4 steps in (mesh 2 and 4: 1 step)."""
    dt = getattr(torch, dtype)
    if flux == "kpp":
        p = _problem(cuda, mesh_size, "float64", T=0.0, **over)
        u2 = p.u0.reshape(p._shape2)
        fields = (u2, u2, u2, torch.full_like(u2, np.pi / 4))
    else:
        p, *fields = _burgers_state(cuda, mesh_size,
                                    1 if mesh_size <= 4 else 4, **over)
    return p, [f.to(dt) for f in fields] + [p.sd.M_coef.to(dt)]


def _tol(dtype):
    return F64_TOL if dtype == "float64" else 1e-4


@pytest.mark.parametrize("flux", ["kpp", "burgers"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mesh", [2, 4, 12, 16])
def test_band_single_kernel_matches_plain(cuda, monkeypatch, flux, dtype,
                                          mesh):
    """The single kernel's resident bands where they are thin and few (mesh
    2: 2 CTAs of 4 and 5 nodes; 4: 4 CTAs) and split unevenly (mesh 12:
    169 nodes in 12 bands, 16: 289 in 16), as many as the rows allow
    (BAND_MIN_NODES 1), both fluxes, both dtypes, BiCGStab with a frozen
    Jacobian and Chebyshev with a fresh one, 2 substeps (the reductions'
    partial buffers alternate across them)."""
    monkeypatch.setattr(fs, "BAND_MIN_NODES", 1)
    plan = fs.band_plan(mesh + 1, mesh + 1, 8, 132)
    sizes = np.diff(plan["starts"])
    assert plan["ctas"] == max(1, (mesh + 1) ** 2 // (mesh + 2))
    if mesh >= 12:
        assert sizes.max() - sizes.min() == 1
    p, args = _band_case(cuda, flux, mesh, dtype)
    key = _build.launch_key("fused_rv_step", flux)
    for solver, frozen in (("bicgstab", True), ("cheby", False)):
        kw = dict(p.fused_step_kwargs(), inner_solver=solver,
                  freeze_jacobian=frozen, n_substeps=2,
                  lin_iters=4 if solver == "bicgstab" else 12)
        before = _build.launches[key]
        out = fs.fused_rv_step(*args, **kw)
        assert _build.launches[key] == before + 1
        for a, b in zip(out, fs.fused_rv_step_plain(*args, **kw)):
            torch.testing.assert_close(a, b, rtol=0, atol=_tol(dtype))


@pytest.mark.parametrize("flux", ["kpp", "burgers"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mesh,n_blocks,which", [(2, 2, (0, 1)),
                                                 (4, 2, (0, 1)),
                                                 (16, 3, (0, 1, 2)),
                                                 (64, 4, (0, 3))])
def test_band_block_kernel_matches_plain(cuda, monkeypatch, flux, dtype,
                                         mesh, n_blocks, which):
    """The block kernel's bands on the first and last blocks of a sharded
    grid (rows above the grid; padding rows below it) and an interior one,
    mesh 2 to 64, both fluxes and dtypes, Chebyshev, rv, as many bands as
    the rows allow (BAND_MIN_NODES 1): against the plain version on every
    row, zero outside the grid."""
    monkeypatch.setattr(fs, "BAND_MIN_NODES", 1)
    p, args = _band_case(cuda, flux, mesh, dtype, **CHEBY)
    kw = p.fused_step_kwargs()
    u2 = args[0]
    abs_term = (u2 - u2.mean()).abs().max().reshape(1)
    blocks, L, D = _blocks(p, args[:4], n_blocks)
    blocks = [(row0, [a.to(u2.dtype) for a in ext])
              for row0, ext in blocks]
    n1x, n1y = p._shape2
    bkw = {k: v for k, v in kw.items() if k not in ("nx", "ny")}
    key = _build.launch_key("fused_rv_block_step", flux)
    for d in which:
        row0, ext = blocks[d]
        before = _build.launches[key]
        got = fs.fused_rv_block_step(*ext, row0, abs_term, n_rows=n1x,
                                     n_cols=n1y, **bkw)
        assert _build.launches[key] == before + 1
        ref = fs.fused_rv_block_step_plain(*ext, row0, abs_term, n_rows=n1x,
                                           n_cols=n1y, **bkw)
        torch.testing.assert_close(got, ref, rtol=0, atol=_tol(dtype))
        lo, hi = fs.block_rows(L + 2 * D, row0, n1x)
        assert not got[:lo].any() and not got[hi:].any()


def test_band_kernels_repeat_and_ablations_match(cuda):
    """Both band kernels give the same bits launch after launch at mesh 64
    (132 CTAs; BiCGStab's reductions over all of them); each ablation
    instance of the single kernel (KPP f32) stays within 1e-4 of the plain
    version, each of the block kernel within 1e-4 of the full kernel."""
    p, args = _band_case(cuda, "kpp", 64, "float32")
    kw = p.fused_step_kwargs()
    a = fs.fused_rv_step(*args, **kw)
    b = fs.fused_rv_step(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref = fs.fused_rv_step_plain(*args, **kw)
    for name, design in fs.BAND_ABLATIONS.items():
        out = fs.fused_rv_step_ablated(design, *args, **kw)
        torch.testing.assert_close(out[0], ref[0], rtol=0, atol=1e-4,
                                   msg=name)
    p.cfg = dataclasses.replace(p.cfg, **CHEBY)
    kw = p.fused_step_kwargs()
    u2 = args[0]
    abs_term = (u2 - u2.mean()).abs().max().reshape(1)
    blocks, L, D = _blocks(p, args[:4], 4)
    row0, ext = blocks[1]
    ext = [t.float() for t in ext]
    bkw = {k: v for k, v in kw.items() if k not in ("nx", "ny")}
    run = lambda: fs.fused_rv_block_step(*ext, row0, abs_term,
                                         n_rows=p._shape2[0],
                                         n_cols=p._shape2[1], **bkw)
    got = run()
    assert torch.equal(got, run())
    for name, design in fs.BLOCK_ABLATIONS.items():
        out = fs.fused_rv_block_step_ablated(
            design, *ext, row0, abs_term, n_rows=p._shape2[0],
            n_cols=p._shape2[1], **bkw)
        torch.testing.assert_close(out, got, rtol=0, atol=1e-4, msg=name)
