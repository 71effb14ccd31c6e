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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run shares the cores among several
    pytest worker processes, where torch's thread pool only
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    until two stages of the largest sweep fit the shared memory a block may
    use; the default weighs the rounds of tiles over the resident blocks
    against the halo."""
    assert ts.tile_geometry(25, 25, 8, 8) == (8, 25)
    assert ts.tile_geometry(65, 65, 8, 8) == (8, 33)
    assert ts.tile_geometry(1025, 1025, 4, 32) == (32, 41)
    assert ts.tile_geometry(2049, 2049, 4, 64) == (64, 20)
    rows, cols = ts.tile_geometry(2049, 2049, 8, 128)
    assert rows == 128 and 1 <= cols < 9
    assert ts.smem_bytes(rows, cols, 8) <= ts.smem_budget(8)
    for bad in (0, 10**5):
        with pytest.raises(ValueError):
            ts.tile_geometry(65, 65, 8, bad)
    # one block per SM (the kernel's registers) on the H100 SXM's 132 SMs:
    # at mesh 256 in f32 8-row tiles make 2193 tiles, 17 rounds of 1584
    # sectors; 16-row tiles 9 rounds of 3096; at mesh 512 16-row tiles 33
    # rounds of 3168, 32-row tiles (41 columns) 25 rounds of 4760
    for n1, itemsize, rows in ((65, 8, 8), (513, 4, 32), (1025, 4, 16),
                               (2049, 4, 16), (2049, 8, 16)):
        assert ts.default_tile_rows(n1, n1, itemsize, 132,
                                    lambda smem: 1) == rows


def _covered(lo, hi, n1x, n1y, rows, cols):
    """How often the kernel's tiles (tile_origins, masked to rows [lo, hi)
    and the grid's columns) visit each node of an (n1x, n1y) buffer."""
    seen = np.zeros((n1x, n1y), dtype=int)
    origins = ts.tile_origins(lo, hi, n1y, rows, cols)
    for r0, c0 in origins:
        seen[r0:min(r0 + rows, hi), c0:min(c0 + cols, n1y)] += 1
    return seen, origins


# (name, buffer rows, row0 of the block or None for the whole grid, grid
# rows, n1y, tile rows, tile cols): mesh 16 (17 x 17) whole and in 3
# blocks of L 6 with a 4-row halo (B 14): the first block's rows above the
# grid, an interior block, the last block's padding rows below it; ragged
# last rows of tiles, and a ragged last column of tiles where cols does
# not divide 17
COVER = [("whole", 17, None, 17, 17, 8, 17),
         ("whole ragged columns", 17, None, 17, 17, 8, 5),
         ("first block", 14, -4, 17, 17, 8, 17),
         ("interior block", 14, 2, 17, 17, 4, 6),
         ("last block", 14, 8, 17, 17, 8, 5)]


@pytest.mark.parametrize("name,B,row0,n_rows,n1y,rows,cols", COVER,
                         ids=[c[0] for c in COVER])
def test_tiles_cover_rows_once(name, B, row0, n_rows, n1y, rows, cols):
    """Every node of rows [lo, hi) in the grid and every column is in
    exactly one tile; no tile starts outside them."""
    lo, hi = (0, B) if row0 is None else fs.block_rows(B, row0, n_rows)
    if row0 is not None:
        assert (lo > 0) == (row0 < 0) and (hi < B) == (row0 + B > n_rows)
    seen, origins = _covered(lo, hi, B, n1y, rows, cols)
    assert (seen[lo:hi] == 1).all()
    assert not seen[:lo].any() and not seen[hi:].any()
    assert all(lo <= r0 < hi and 0 <= c0 < n1y for r0, c0 in origins)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rows", [8, 16, 32, 64])
def test_two_stages_fit_shared_memory(itemsize, rows):
    """Two stages of the largest sweep (4 fields with their halo, 17 values
    per node) fit the block's shared memory at every width, or the tile
    narrows until they do, and no further than that."""
    for n1y in (17, 65, 257, 1025, 2049):
        r, cols = ts.tile_geometry(1025, n1y, itemsize, rows)
        assert r == rows and 1 <= cols <= min(n1y, ts.MAX_TILE_COLS)
        assert ts.smem_bytes(rows, cols, itemsize) <= ts.smem_budget(itemsize)
        assert ts.smem_budget(itemsize) + ts.STATIC_VALUES * itemsize < (
            227 * 1024)
        # the fewest column tiles: one fewer would be too wide or too big
        n_tiles = -(-n1y // cols)
        if n_tiles > 1:
            wider = -(-n1y // (n_tiles - 1))
            assert (wider > ts.MAX_TILE_COLS or ts.smem_bytes(
                rows, wider, itemsize) > ts.smem_budget(itemsize))


def _one_per_sm(smem):
    return 1


def _two_small(smem):
    """Two blocks on an SM when their shared memory allows it."""
    return min(2, ts.SMEM_OPTIN // (smem + ts.STATIC_VALUES * 4))


@pytest.mark.parametrize("n1x,n1y,itemsize,per_sm", [
    (17, 17, 8, _one_per_sm), (129, 65, 4, _one_per_sm),
    (381, 1025, 4, _one_per_sm), (1025, 1025, 4, _one_per_sm),
    (1025, 1025, 8, _one_per_sm), (2049, 2049, 4, _one_per_sm),
    (1025, 1025, 4, _two_small), (2049, 2049, 4, _two_small)])
def test_default_tile_rows_minimises_rounds(n1x, n1y, itemsize, per_sm):
    """default_tile_rows takes, of 64, 32, 16 and 8 rows, the tile whose
    rounds over the resident blocks times the sectors a stage touches and
    a tile's fixed cost are least (ties: the larger tile), the rounds
    counted here from the tiles themselves."""
    def staged(rows):
        r, cols = ts.tile_geometry(n1x, n1y, itemsize, rows)
        tiles = len(ts.tile_origins(0, n1x, n1y, r, cols))
        resident = 132 * per_sm(ts.smem_bytes(r, cols, itemsize))
        rounds = -(-tiles // min(resident, tiles))
        plan = ts.tile_plan(n1x, n1y, itemsize, rows, 132, per_sm)
        assert (plan["tiles"], plan["rounds"]) == (tiles, rounds)
        return rounds * (ts.stage_sectors(r, cols, itemsize)
                         + ts.TILE_SECTORS)

    costs = {rows: staged(rows) for rows in (64, 32, 16, 8)}
    best = min(costs.values())
    assert ts.default_tile_rows(n1x, n1y, itemsize, 132, per_sm) == max(
        rows for rows, c in costs.items() if c == best)


# (n1, itemsize, tile plan): the measured default plans at mesh 256 and 512, one
# block per SM on the H100 SXM's 132 SMs (f64 tiles narrow to 40 columns
# so that two stages fit)
PINNED_PLANS = [
    (1025, 4, dict(rows=16, cols=61, tiles=1105, blocks=132, rounds=9)),
    (2049, 4, dict(rows=16, cols=63, tiles=4257, blocks=132, rounds=33)),
    (1025, 8, dict(rows=16, cols=40, tiles=1690, blocks=132, rounds=13)),
    (2049, 8, dict(rows=16, cols=40, tiles=6708, blocks=132, rounds=51)),
]


@pytest.mark.parametrize("n1,itemsize,want", PINNED_PLANS,
                         ids=["mesh256-f32", "mesh512-f32", "mesh256-f64",
                              "mesh512-f64"])
def test_default_plans_at_mesh_256_and_512(n1, itemsize, want):
    """The tiled main paths keep their measured plans: 16-row tiles."""
    rows = ts.default_tile_rows(n1, n1, itemsize, 132, _one_per_sm)
    plan = ts.tile_plan(n1, n1, itemsize, rows, 132, _one_per_sm)
    assert {k: plan[k] for k in want} == want


@pytest.mark.parametrize("kernel,per_sm", [("tiled", 1), ("split_setup", 1),
                                           ("split_newton", 1),
                                           ("split_newton", 2)])
def test_card_plan_takes_the_launched_kernels_occupancy(monkeypatch, kernel,
                                                        per_sm):
    """card_plan at mesh 128 (513 x 513, f32) asks the occupancy of the
    kernel it is given (a fake card here: 132 SMs, per_sm blocks each),
    and its plan is tile_plan's with that occupancy and the default rows;
    one plan serves all of a split step's launches."""
    asked = []

    def fake_occupancy(dtype, smem, device_index=0, kernel="tiled"):
        asked.append(kernel)
        return dict(blocks_per_sm=per_sm)

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(ts, "occupancy", fake_occupancy)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: Props())
    ts._card_plan.cache_clear()
    try:
        plan = ts.card_plan(513, 513, torch.float32, kernel=kernel)
        fixed = ts.card_plan(513, 513, torch.float32, 8, kernel=kernel)
    finally:
        ts._card_plan.cache_clear()
    assert asked and set(asked) == {kernel}
    fake = lambda smem: per_sm
    rows = ts.default_tile_rows(513, 513, 4, 132, fake)
    assert plan == ts.tile_plan(513, 513, 4, rows, 132, fake)
    assert plan["resident"] == 132 * per_sm
    assert (fixed["rows"], fixed["cols"]) == ts.tile_geometry(513, 513, 4, 8)


def test_tiled_refuses_what_is_not_ported():
    """Block mode with BiCGStab (its dots span the grid) or, for rv,
    without abs_term, and an inner solver the TPU kernel does not have
    raise before any device dispatch. Block mode itself is ported: on the
    whole grid it is the step; so are bf16 planes, which change nothing at
    f64."""
    p = tkpp.build(tkpp.KPPConfig(mesh_size=2, cg_iters=6, newton_iters=2),
                   device="cpu")
    u2 = p.u0.reshape(p._shape2)
    args = (u2, u2, u2, u2, p.sd.M_coef)
    kw = p.fused_step_kwargs()
    torch.testing.assert_close(ts.tiled_rv_step(*args, **kw, bf16_planes=True),
                               ts.tiled_rv_step(*args, **kw), rtol=0, atol=0)
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
