"""bf16 operator planes in the port (``xla_bf16_planes``,
``tiled_bf16_planes``) against the JAX package, on the CPU.

Two variants, each the JAX package's:
  * the composed stencil step (structured.sweep_form): the fixed-iteration
    mass solve and the Newton inner solves read bf16 copies of their
    planes, the Jacobi diagonals stay exact;
  * the tiled kernel's (pallas_tiled.tiled_rv_step bf16_planes), whose
    plain version is fused_step._step_body_plain with bf16_planes: the same
    solves on bf16 planes with both Jacobi diagonals rounded as those.

Tolerances: the composed run within 1e-4 max(1, |u|) of JAX's, and within
a tenth of JAX's own bf16-against-f32 move (so the test tells the variant
from the f32 run); the tiled step within the envelope the JAX package's
own test_tiled_bf16_planes grants its kernel (2e-3 of the field against
the f32-plane step, 5e-3 against the f64 step); f64 bit for bit with
either flag. The JAX tiled kernel in interpret mode (~45 s a call) runs
only in the test marked slow.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import structured as st
from conservation_fem_tpu_torch.ops import tiled_step as ts
from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                 ShardedFusedStructured)

# tests/test_structured.py::test_xla_bf16_planes
COMPOSED = dict(mesh_size=4, T=0.05, backend="stencil", cg_iters=6,
                newton_iters=2, newton_linear_iters=4)
# test_torch_tiled_step.CASES: the Chebyshev and BiCGStab solver cases
TILED = {
    "cheby_frozen": dict(cg_iters=10, newton_iters=2, newton_linear_iters=12,
                         modified_newton=True, inner_solver="cheby"),
    "bicgstab_frozen": dict(cg_iters=6, newton_iters=2,
                            newton_linear_iters=4, modified_newton=True,
                            inner_solver="bicgstab"),
    "bicgstab_exact_odd": dict(cg_iters=6, newton_iters=3,
                               newton_linear_iters=4, modified_newton=False,
                               inner_solver="bicgstab"),
}
# the JAX package's test_tiled_bf16_planes envelope, times max|u|
TO_F32_STEP, TO_F64_STEP = 2e-3, 5e-3
TRIM = dict(modified_newton=True, inner_solver="cheby", cg_iters=4,
            newton_iters=2, newton_linear_iters=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run shares the cores among several
    pytest worker processes, where torch's thread pool only
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sweep_form_rounds_as_jax():
    """sweep_form's bf16 copy is JAX's astype(bfloat16) bit for bit (ties
    to even, subnormals kept), f32 in, f64 and enable=False left alone; a
    stencil product on it promotes each plane to f32 (no bf16 product)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(4096).astype(np.float32) * np.float32(3.0)
    bits = x.view(np.uint32)
    # exact ties below the kept 16 bits, half of them on an odd last bit
    bits[:512] = (bits[:512] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    bits[:256] |= np.uint32(0x10000)
    sub = np.array([1e-40, -3e-39, 1.4e-45, 9.2e-41, 0.0, -0.0],
                   np.float32)
    sub_ties = (np.arange(1, 65, dtype=np.uint32) << 16) | 0x8000
    x = np.concatenate([bits.view(np.float32), sub, sub_ties.view(np.float32),
                        np.array([3.4e38, -1e30, 1e-30], np.float32)])
    got = st.sweep_form(torch.from_numpy(x.copy()), True)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    t = torch.from_numpy(x.copy())
    assert st.sweep_form(t, False) is t
    assert st.sweep_form(t.double(), True).dtype == torch.float64

    p = tkpp.build(tkpp.KPPConfig(mesh_size=4, dtype="float32"), device="cpu")
    coef16 = st.sweep_form(p.sd.M_coef, True)
    u2 = p.u0.reshape(p._shape2)
    y = st.constrained_matvec(p.sd, coef16, u2)
    assert y.dtype == torch.float32
    torch.testing.assert_close(
        y, st.constrained_matvec(p.sd, coef16.float(), u2), rtol=0, atol=0)


def test_cli_reaches_both_options(capsys):
    """--tiled_bf16_planes and --xla_bf16_planes reach KPPConfig through the
    CLI's parser, and the kpp workload runs with them (its recorded
    metrics take the composed step, which reads xla_bf16_planes)."""
    from conservation_fem_tpu_torch import __main__ as tmain

    cfg, device = tmain._parse(tkpp.KPPConfig, "kpp", [
        "--tiled_bf16_planes", "true", "--xla_bf16_planes", "1",
        "--device", "cpu"])
    assert cfg.tiled_bf16_planes and cfg.xla_bf16_planes and device == "cpu"
    assert tmain.main(["kpp", "--mesh_size", "2", "--T", "0.02", "--dtype",
                       "float32", "--cg_iters", "6", "--newton_iters", "2",
                       "--newton_linear_iters", "4", "--xla_bf16_planes",
                       "true", "--tiled_bf16_planes", "true", "--device",
                       "cpu"]) == 0
    assert '"num_steps": 2' in capsys.readouterr().out


@functools.lru_cache(maxsize=None)
def _jax_composed(bf16):
    cfg = jkpp.KPPConfig(dtype="float32", xla_bf16_planes=bf16, **COMPOSED)
    return np.asarray(jkpp.build(cfg).solve().u)


def test_composed_bf16_matches_jax():
    """KPP mesh 4, f32, fixed counts (JAX's test_xla_bf16_planes config):
    the port's xla_bf16_planes run against JAX's."""
    ref, ref_f32 = _jax_composed(True), _jax_composed(False)
    p = tkpp.build(tkpp.KPPConfig(dtype="float32", xla_bf16_planes=True,
                                  **COMPOSED), device="cpu")
    got = p.solve().u.numpy()
    moved = np.abs(ref - ref_f32).max()
    diff = np.abs(got - ref).max()
    assert np.isfinite(got).all() and moved > 0
    assert diff <= 1e-4 * max(1.0, np.abs(ref).max()), diff
    assert diff < 0.1 * moved, (diff, moved)


def test_f64_ignores_both_flags():
    """At f64 both options are no-ops, bit for bit: the composed solve, and
    the tiled step's plain version and wrapper on the CPU."""
    cfg = dict(COMPOSED, dtype="float64")
    base = tkpp.build(tkpp.KPPConfig(**cfg), device="cpu").solve().u
    for flag in ("xla_bf16_planes", "tiled_bf16_planes"):
        got = tkpp.build(tkpp.KPPConfig(**cfg, **{flag: True}),
                         device="cpu").solve().u
        torch.testing.assert_close(got, base, rtol=0, atol=0)
    p = tkpp.build(tkpp.KPPConfig(mesh_size=6, **TILED["cheby_frozen"]),
                   device="cpu")
    u2 = p.u0.reshape(p._shape2)
    args = (u2, 1.01 * u2, u2, torch.full_like(u2, np.pi / 4), p.sd.M_coef)
    kw = p.fused_step_kwargs()
    off = ts.tiled_rv_step_plain(*args, **kw)
    for fn in (ts.tiled_rv_step_plain, ts.tiled_rv_step):
        torch.testing.assert_close(fn(*args, bf16_planes=True, **kw), off,
                                   rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _jax_fixed_steps(name, dtype):
    """Two JAX fixed-iteration XLA steps of TILED[name] at mesh 6 from u0
    (the second from the JAX history): [(carry, u_{n+1})]."""
    pj = jkpp.build(jkpp.KPPConfig(backend="stencil", mesh_size=6, T=0.05,
                                   dtype=dtype, **TILED[name]))
    carry, out = (pj.u0,) * 3, []
    for _ in range(2):
        (u, _, _), _ = pj.step(carry, jnp.asarray(pj.dt, pj.u0.dtype))
        out.append((carry, np.asarray(u, np.float64)))
        carry = (u, carry[0], carry[1])
    return out


@pytest.mark.parametrize("name", sorted(TILED))
def test_tiled_plain_bf16_within_jax_envelope(name):
    """The tiled step's plain version with bf16 planes, f32, mesh 6, two
    steps on the JAX f32 history: within 2e-3 of the field of JAX's
    f32-plane step, within 5e-3 of its f64 step, and not the port's own
    f32-plane step."""
    pt = tkpp.build(tkpp.KPPConfig(mesh_size=6, T=0.05, dtype="float32",
                                   **TILED[name]), device="cpu")
    kw = pt.fused_step_kwargs()
    f64 = _jax_fixed_steps(name, "float64")
    for k, (carry, u32) in enumerate(_jax_fixed_steps(name, "float32")):
        fields = [torch.tensor(np.asarray(c)).reshape(pt._shape2)
                  for c in carry]
        g2 = torch.full_like(fields[0], np.pi / 4)
        on = ts.tiled_rv_step_plain(*fields, g2, pt.sd.M_coef,
                                    bf16_planes=True, **kw)
        off = ts.tiled_rv_step_plain(*fields, g2, pt.sd.M_coef, **kw)
        got = on.reshape(-1).double().numpy()
        scale = np.abs(u32).max()
        assert np.abs(got - u32).max() <= TO_F32_STEP * scale, f"step {k}"
        assert np.abs(got - f64[k][1]).max() <= TO_F64_STEP * scale
        assert float((on - off).abs().max()) > 0, f"step {k}: no move"


def test_sharded_tiled_bf16_matches_single_device_plain():
    """ShardedFusedStructured on LocalBlocks(4), the tiled kernel's block
    mode with bf16 planes, f32 mesh 16, three steps: every owned row equal
    to the single-device plain bf16 step's trajectory within the f32
    kernel gate (1e-4), and apart from the f32-plane sharded run."""
    cfg = tkpp.KPPConfig(mesh_size=16, T=0.03, dtype="float32",
                         tiled_bf16_planes=True, **TRIM)
    p = tkpp.build(cfg, device="cpu")
    sh = ShardedFusedStructured(p, LocalBlocks(4, "cpu"), kernel="tiled",
                                tile_rows=8)
    assert sh.kernel == "tiled" and p.num_steps == 3
    got = sh.solve()
    kw = p.fused_step_kwargs()
    carry = tuple(c.reshape(p._shape2) for c in p._initial_carry())
    for g in p.step_dirichlet(p.step_times()):
        u = ts.tiled_rv_step_plain(*carry, g, p.sd.M_coef, bf16_planes=True,
                                   **kw)
        carry = (u, carry[0], carry[1])
    torch.testing.assert_close(got, carry[0].reshape(-1), rtol=0, atol=1e-4)
    q = tkpp.build(dataclasses.replace(cfg, tiled_bf16_planes=False),
                   device="cpu")
    off = ShardedFusedStructured(q, LocalBlocks(4, "cpu"), kernel="tiled",
                                 tile_rows=8).solve()
    assert float((got - off).abs().max()) > 0


@pytest.mark.slow
def test_tiled_plain_bf16_matches_pallas_interpret():
    """The plain bf16 step against the JAX tiled kernel itself with
    bf16_planes, in interpret mode (one call, ~45 s): mesh 6, f32, 16-row
    tiles (two tiles over the 25-row grid), the Chebyshev frozen case."""
    from conservation_fem_tpu.ops.pallas_tiled import tiled_rv_step

    pj = jkpp.build(jkpp.KPPConfig(backend="stencil", mesh_size=6, T=0.05,
                                   **TILED["cheby_frozen"]))
    pt = tkpp.build(tkpp.KPPConfig(mesh_size=6, T=0.05, dtype="float32",
                                   **TILED["cheby_frozen"]), device="cpu")
    sd, cfg = pj.sd, pj.cfg
    u2 = jnp.asarray(pj.u0.reshape(pt._shape2), jnp.float32)
    g2 = jnp.asarray(pj.bc_value(pj.mesh.points, pj.dt).reshape(pt._shape2),
                     jnp.float32)
    ref = tiled_rv_step(
        u2, u2, u2, g2, jnp.asarray(sd.M_coef, jnp.float32), nx=sd.nx,
        ny=sd.ny, dt=pj.dt, area=float(sd.area), h=float(sd.h_cg2[0, 0]),
        grads=np.asarray(sd.grads), phi=np.asarray(sd.phi),
        qw=np.asarray(sd.qw), Cvel=cfg.Cvel, CRV=cfg.CRV,
        fprime=pj.flux_prime, fprime_norm=pj.flux_prime_norm,
        fprime_xy=getattr(pj, "flux_prime_xy", None),
        cg_iters=cfg.cg_iters, newton_iters=cfg.newton_iters,
        lin_iters=cfg.newton_linear_iters,
        freeze_jacobian=cfg.modified_newton,
        stabilization=cfg.stabilization, inner_solver=cfg.inner_solver,
        mass_bounds=cfg.cheby_mass_bounds, lin_bounds=cfg.cheby_lin_bounds,
        interpret=True, tile_rows=16, bf16_planes=True)
    t = lambda a: torch.tensor(np.asarray(a))
    got = ts.tiled_rv_step_plain(t(u2), t(u2), t(u2), t(g2), pt.sd.M_coef,
                                 bf16_planes=True, **pt.fused_step_kwargs())
    ref = np.asarray(ref, np.float64)
    assert np.abs(got.double().numpy() - ref).max() <= 1e-4 * np.abs(
        ref).max()
