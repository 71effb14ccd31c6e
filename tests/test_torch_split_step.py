"""The split step of the port (conservation_fem_tpu_torch/ops/fused_step:
fused_rv_step_split and its two stages, split_setup and split_newton)
against the JAX package, f64: the JAX Pallas kernel
pallas_fused.fused_rv_step_split in interpret mode from a mid-trajectory
KPP state, and the JAX fixed-iteration XLA step from u0 with a frozen and a
fresh Jacobian.

Tolerance 1e-11 absolute on O(1-10) fields: the bound of the JAX
package's own fused-vs-XLA identity tests; the port sums the same terms in
another order. The stages chained by hand must give the port's own single
step to 1e-13 (the same plain arithmetic), and the stages chained as the
wrapper chains them on the card (no relinearisation after the first
frozen iteration, no residual after the last) the default chain bit for
bit. Interpret mode costs ~5 s per launch here, so it runs one case at
mesh 4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops.pallas_fused import (
    fused_rv_step_split as jax_split)
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import fused_step as fs

TOL = 1e-11
BENCH = dict(cg_iters=6, newton_iters=2, newton_linear_iters=4,
             modified_newton=True, newton_final_residual=False)


@pytest.fixture(scope="module")
def state():
    """A mid-trajectory history (u_n, u_old, u_old_old) at mesh 4: 20
    steps of the port's plain path, then the two steps after it."""
    p = tkpp.build(tkpp.KPPConfig(mesh_size=4, T=0.2, **BENCH), device="cpu")
    carry = (p.solve().u,) * 3
    for _ in range(2):
        carry, _ = p.step(carry, p.dt)
    sh = p._shape2
    u2, uo2, uoo2 = (v.reshape(sh) for v in carry)
    assert float(u2.max() - u2.min()) > 5.0      # the wave is there
    return p, u2, uo2, uoo2, torch.full_like(u2, np.pi / 4)


def _kwargs(p, **over):
    """The problem's step arguments without the flux, which the two
    packages pass in different forms."""
    kw = dict(p.fused_step_kwargs(), **over)
    del kw["flux"]
    return kw


def test_plain_split_step_matches_pallas_interpret(state):
    """Bench config (frozen Jacobian, 2 x BiCGStab(4)): the port's plain
    split step against the JAX split kernel run in interpret mode."""
    p, *fields = state
    kw = _kwargs(p)
    ref = jax_split(*(jnp.asarray(a.numpy()) for a in fields),
                    jnp.asarray(p.sd.M_coef.numpy()),
                    fprime=jkpp.flux_prime, fprime_norm=jkpp.flux_prime_norm,
                    fprime_xy=jkpp.flux_prime_xy, interpret=True, **kw)
    got = fs.fused_rv_step_split_plain(*fields, p.sd.M_coef, flux=tkpp.FLUX,
                                       **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)
    assert np.abs(got.numpy() - fields[0].numpy()).max() > 1e-2
    # the wrapper on CPU tensors is the plain version
    again = fs.fused_rv_step_split(*fields, p.sd.M_coef, flux=tkpp.FLUX,
                                   **kw)
    assert torch.equal(again, got)


@pytest.mark.parametrize("frozen", [True, False])
def test_plain_split_step_matches_jax_fixed_step(frozen):
    """One step from u0 against the JAX fixed-iteration XLA step (the path
    the JAX tests hold their split kernel's single twin to), 3 Newton
    iterations with a frozen and with a fresh Jacobian."""
    cfg = dict(BENCH, mesh_size=4, T=0.01, newton_iters=3,
               modified_newton=frozen)
    pj = jkpp.build(jkpp.KPPConfig(**cfg))
    (ref, _, _), _ = pj.step((pj.u0,) * 3, jnp.asarray(pj.dt))
    pt = tkpp.build(tkpp.KPPConfig(**cfg), device="cpu")
    u2 = pt.u0.reshape(pt._shape2)
    got = fs.fused_rv_step_split_plain(
        u2, u2, u2, torch.full_like(u2, np.pi / 4), pt.sd.M_coef,
        **pt.fused_step_kwargs())
    np.testing.assert_allclose(got.reshape(-1).numpy(), np.asarray(ref),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("solver,frozen", [("bicgstab", True),
                                           ("cheby", False)])
def test_split_stages_compose_to_the_single_step(state, solver, frozen):
    """split_setup then one split_newton per Newton iteration (on CPU
    tensors: the plain stages), linearised at uk0 for a frozen Jacobian
    and at the iterate otherwise, give the single step; the stages'
    outputs have the kernels' shapes, and the last F is the residual at
    the result."""
    p, u2, uo2, uoo2, g2 = state
    kw = dict(p.fused_step_kwargs(), inner_solver=solver,
              freeze_jacobian=frozen, newton_iters=3,
              lin_iters=4 if solver == "bicgstab" else 16)
    Mc = p.sd.M_coef
    Kc, aux, uk, F = fs.split_setup(u2, uo2, uoo2, g2, Mc, **kw)
    n1 = u2.shape
    assert Kc.shape == (7, *n1) and aux.shape == (2, *n1)
    assert uk.shape == n1 and F.shape == n1
    torch.testing.assert_close(uk, torch.where(p.sd.bc2, g2, u2), rtol=0,
                               atol=0)
    w0 = uk
    for _ in range(kw["newton_iters"]):
        uk, F = fs.split_newton(uk, F, u2, g2, Mc, Kc, aux,
                                w0 if frozen else uk, **kw)
    ref = fs.fused_rv_step_plain(u2, uo2, uoo2, g2, Mc, **kw)[0]
    torch.testing.assert_close(uk, ref, rtol=0, atol=1e-13)
    # F(uk) from the frozen terms: zero where the result meets the data
    assert float(F[p.sd.bc2].abs().max()) == 0.0
    assert float(F.abs().max()) < float(
        fs.split_setup(u2, uo2, uoo2, g2, Mc, **kw)[3].abs().max())


@pytest.mark.parametrize("frozen", [True, False])
def test_split_newton_keywords_keep_the_chain(state, frozen):
    """The chain fused_rv_step_split runs on the card — relinearize=False
    after the first iteration of a frozen Jacobian, residual=False on the
    last — gives the default chain's iterate bit for bit (on CPU tensors:
    the plain stages), and the last stage returns no residual. Without a
    scratch to take the Jacobian from, relinearize=False raises."""
    p, u2, uo2, uoo2, g2 = state
    kw = dict(p.fused_step_kwargs(), freeze_jacobian=frozen, newton_iters=3)
    Mc = p.sd.M_coef
    Kc, aux, uk0, F0 = fs.split_setup(u2, uo2, uoo2, g2, Mc, tile_rows=8,
                                      **kw)
    scr = fs.new_scratch(u2.dtype, u2.device, *u2.shape)
    iters = kw["newton_iters"]
    (uk, F), (vk, G) = (uk0, F0), (uk0, F0)
    for it in range(iters):
        w_u, w_v = (uk0, uk0) if frozen else (uk, vk)
        uk, F = fs.split_newton(uk, F, u2, g2, Mc, Kc, aux, w_u, **kw)
        vk, G = fs.split_newton(vk, G, u2, g2, Mc, Kc, aux, w_v,
                                scratch=scr, tile_rows=8,
                                relinearize=not (frozen and it > 0),
                                residual=it + 1 < iters, **kw)
        assert (G is None) == (it + 1 == iters)
    assert torch.equal(vk, uk)
    assert torch.equal(fs.fused_rv_step_split(u2, uo2, uoo2, g2, Mc, **kw),
                       uk)
    with pytest.raises(ValueError, match="scratch"):
        fs.split_newton(uk0, F0, u2, g2, Mc, Kc, aux, uk0, relinearize=False,
                        **kw)
