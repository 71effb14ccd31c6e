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


def _state(cuda, mesh_size):
    """A mid-trajectory f64 history at mesh_size: (problem, u, u_old,
    u_old_old, g)."""
    p = _problem(cuda, mesh_size, "float64", T=0.2)
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


def test_step_kernels_refuse_bad_arguments(cuda):
    """On CUDA tensors: bf16 planes, block mode with BiCGStab or (rv)
    without abs_term, and a flux other than KPP for every step kernel,
    raise before a launch."""
    p = _problem(cuda, 4, "float64", T=0.0)
    u2 = p.u0.reshape(p._shape2)
    args = (u2, u2, u2, u2, p.sd.M_coef)
    kw = p.fused_step_kwargs()
    before = sum(_build.launches.values())
    for bad in (dict(row0_base=0, n_rows=17, abs_term=0.0),
                dict(bf16_planes=True)):
        with pytest.raises(NotImplementedError):
            ts.tiled_rv_step(*args, **kw, **bad)
    with pytest.raises(ValueError, match="abs_term"):
        ts.tiled_rv_step(*args, **dict(kw, inner_solver="cheby"),
                         row0_base=0, n_rows=17)
    other = dict(kw, flux=kw["flux"]._replace(name="burgers"))
    for fn in (fs.fused_rv_step, fs.fused_rv_step_split, fs.split_setup,
               ts.tiled_rv_step):
        with pytest.raises(NotImplementedError, match="KPP"):
            fn(*args, **other)
    block_kw = {k: v for k, v in dict(other, inner_solver="cheby").items()
                if k not in ("nx", "ny")}
    with pytest.raises(NotImplementedError, match="KPP"):
        fs.fused_rv_block_step(*args, 0, 1.0, n_rows=17, n_cols=17,
                               **block_kw)
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
