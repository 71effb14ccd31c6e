"""The tiled step of the port (conservation_fem_tpu_torch/ops/tiled_step)
against the JAX fixed-iteration XLA step — the reference the JAX
package's own tiled tests (test_pallas_tiled.py) hold its kernel to — f64,
mesh 6 (a 25-row grid: with 8-row tiles the last tile is ragged, 3 x 8 +
1). Tolerances as in those tests: 1e-11 with Chebyshev inner solves, 1e-10
with PCG/BiCGStab (their dots are summed in another order). The JAX tiled
kernel itself takes minutes in interpret mode and is not run here.

Also: the card-side tile geometry, the refusals of what is not ported or
not possible in block mode, and the model's dispatch to the split and tiled
wrappers. Block mode itself is held to the JAX package in
test_torch_sharded_fused.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import fused_step as fs
from conservation_fem_tpu_torch.ops import tiled_step as ts

CASES = {
    # name: (KPPConfig overrides, atol)
    "cheby_frozen": (dict(cg_iters=10, newton_iters=2,
                          newton_linear_iters=12, modified_newton=True,
                          inner_solver="cheby"), 1e-11),
    "cheby_exact_odd": (dict(cg_iters=10, newton_iters=3,
                             newton_linear_iters=12, modified_newton=False,
                             inner_solver="cheby"), 1e-11),
    "bicgstab_frozen": (dict(cg_iters=6, newton_iters=2,
                             newton_linear_iters=4, modified_newton=True,
                             inner_solver="bicgstab"), 1e-10),
    "bicgstab_exact_odd": (dict(cg_iters=6, newton_iters=3,
                                newton_linear_iters=4, modified_newton=False,
                                inner_solver="bicgstab"), 1e-10),
    "gfem_cheby": (dict(cg_iters=10, newton_iters=2, newton_linear_iters=12,
                        modified_newton=True, inner_solver="cheby",
                        stabilization="gfem"), 1e-11),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_tiled_step_matches_jax_fixed_step(name):
    """Two steps from u0 (the second from the JAX history), 8-row tiles."""
    over, atol = CASES[name]
    cfg = dict(mesh_size=6, T=0.05, **over)
    pj = jkpp.build(jkpp.KPPConfig(backend="stencil", **cfg))
    pt = tkpp.build(tkpp.KPPConfig(**cfg), device="cpu")
    kw = pt.fused_step_kwargs()
    sh = pt._shape2
    carry = (pj.u0,) * 3
    for k in range(2):
        (u_x, _, _), _ = pj.step(carry, jnp.asarray(pj.dt))
        u2, uo2, uoo2 = (torch.tensor(np.asarray(c)).reshape(sh)
                         for c in carry)
        got = ts.tiled_rv_step(u2, uo2, uoo2, torch.full_like(u2, np.pi / 4),
                               pt.sd.M_coef, tile_rows=8, **kw)
        np.testing.assert_allclose(got.reshape(-1).numpy(), np.asarray(u_x),
                                   rtol=0, atol=atol, err_msg=f"step {k}")
        carry = (u_x, carry[0], carry[1])


def test_tile_geometry():
    """tile_rows rows by balanced column tiles of at most 64 columns, cut
    to fit the staged shared memory; the default balances the rounds of
    tiles over the SMs against the halo."""
    assert ts.tile_geometry(25, 25, 8, 8) == (8, 25)
    assert ts.tile_geometry(65, 65, 8, 8) == (8, 33)
    assert ts.tile_geometry(1025, 1025, 4, 32) == (32, 61)
    assert ts.tile_geometry(2049, 2049, 4, 64) == (64, 63)
    rows, cols = ts.tile_geometry(2049, 2049, 8, 128)
    assert rows == 128 and 1 <= cols < 63
    assert ts.STAGED * (rows + 2) * (cols + 2) * 8 <= ts.STAGE_BYTES
    for bad in (0, 10**5):
        with pytest.raises(ValueError):
            ts.tile_geometry(65, 65, 8, bad)
    # mesh 256 on the H100 SXM's 132 SMs: 16-row tiles make 1105 tiles, 9
    # rounds of 132 (32-row: 561 tiles, 5 rounds of mostly idle blocks at
    # twice the tile area)
    for n1, itemsize, rows in ((65, 8, 8), (513, 4, 8), (1025, 4, 16),
                               (2049, 4, 32), (2049, 8, 32)):
        assert ts.default_tile_rows(n1, n1, itemsize, 132) == rows


def test_tiled_refuses_what_is_not_ported():
    """bf16 planes raise, naming their ROADMAP item, before any device
    dispatch; so do block mode with BiCGStab (its dots span the grid) or,
    for rv, without abs_term, and an inner solver the TPU kernel does not
    have. Block mode itself is ported: on the whole grid it is the step."""
    p = tkpp.build(tkpp.KPPConfig(mesh_size=2, cg_iters=6, newton_iters=2),
                   device="cpu")
    u2 = p.u0.reshape(p._shape2)
    args = (u2, u2, u2, u2, p.sd.M_coef)
    kw = p.fused_step_kwargs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.tiled_rv_step(*args, **kw, bf16_planes=True)
    with pytest.raises(NotImplementedError, match="cheby"):
        ts.tiled_rv_step(*args, **kw, row0_base=0, n_rows=9, abs_term=0.0)
    cheby = dict(kw, inner_solver="cheby")
    with pytest.raises(ValueError, match="abs_term"):
        ts.tiled_rv_step(*args, **cheby, row0_base=0, n_rows=9)
    abs_term = (u2 - u2.mean()).abs().max()
    torch.testing.assert_close(
        ts.tiled_rv_step(*args, **cheby, row0_base=0, n_rows=9,
                         abs_term=abs_term),
        ts.tiled_rv_step(*args, **cheby), rtol=0, atol=1e-13)
    with pytest.raises(NotImplementedError):
        ts.tiled_rv_step(*args, **dict(kw, inner_solver="gmres"))
    with pytest.raises(TypeError):
        ts.tiled_rv_step(*args, **dict(kw, fprime=None))


@pytest.mark.parametrize("mode", ["split", "tiled"])
def test_model_dispatches_by_mode(monkeypatch, mode):
    """With the mode forced, each step goes through that mode's wrapper
    once (on CPU tensors: its plain version), and the trajectory is the
    single-kernel one."""
    cfg = tkpp.KPPConfig(mesh_size=4, T=0.03, use_kernels=True, cg_iters=6,
                         newton_iters=2, newton_linear_iters=4,
                         modified_newton=True, newton_final_residual=False)
    p = tkpp.build(cfg, device="cpu")
    assert p._fused_mode() == "single"
    ref = p.solve().u
    mod, name = ((fs, "fused_rv_step_split") if mode == "split"
                 else (ts, "tiled_rv_step"))
    calls = []
    wrapped = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    monkeypatch.setattr(type(p), "_fused_mode", lambda self: mode)
    assert not p._fused_multistep_ok()
    p.cfg = dataclasses.replace(p.cfg, fused_substeps=3)
    assert not p._fused_multistep_ok()    # K steps per launch: single only
    got = p.solve().u
    assert len(calls) == p.num_steps == 3
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-13)
