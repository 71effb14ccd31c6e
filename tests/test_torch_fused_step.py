"""The plain fused step of the port (conservation_fem_tpu_torch/ops/
fused_step.fused_rv_step_plain) against the JAX Pallas kernel
pallas_fused.fused_rv_step run in interpret mode, from a mid-trajectory
KPP state (after the shock has formed), f64.

Tolerance 1e-11 absolute on O(1-10) fields: the bound of the JAX
package's own fused-vs-XLA identity tests (test_pallas_fused.py); the
port sums the same terms in another order. Interpret mode costs ~5 s per
substep here, so these cases stay few and small (mesh 4, 17x17 grid)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops.pallas_fused import fused_rv_step as jax_fused
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import fused_step as fs

TOL = 1e-11
BENCH = dict(cg_iters=6, newton_iters=2, newton_linear_iters=4,
             modified_newton=True, newton_final_residual=False)


@pytest.fixture(scope="module")
def state():
    """A mid-trajectory history (u_n, u_old, u_old_old) at mesh 4: 20
    steps of the port's plain path, then the two steps after it."""
    p = tkpp.build(tkpp.KPPConfig(mesh_size=4, T=0.2, **BENCH))
    carry = (p.solve().u,) * 3
    for _ in range(2):
        carry, _ = p.step(carry, p.dt)
    sh = p._shape2
    u2, uo2, uoo2 = (v.reshape(sh).numpy() for v in carry)
    assert u2.max() - u2.min() > 5.0      # the wave is there
    return p, u2, uo2, uoo2


def _kwargs(p, **over):
    """The problem's fused-step arguments without the flux, which the two
    packages pass in different forms."""
    kw = dict(p.fused_step_kwargs(), **over)
    del kw["flux"]
    return kw


CASES = {
    "bicgstab_frozen_2sub": dict(n_substeps=2),
    "bicgstab_fresh": dict(freeze_jacobian=False, newton_iters=3),
    "cheby_frozen": dict(inner_solver="cheby", cg_iters=10, lin_iters=16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fused_step_matches_pallas_interpret(state, case):
    p, u2, uo2, uoo2 = state
    kw = _kwargs(p, **CASES[case])
    g2 = np.full_like(u2, np.pi / 4)
    ref = jax_fused(*(jnp.asarray(a) for a in (u2, uo2, uoo2, g2)),
                    jnp.asarray(p.sd.M_coef.numpy()),
                    fprime=jkpp.flux_prime, fprime_norm=jkpp.flux_prime_norm,
                    fprime_xy=jkpp.flux_prime_xy, interpret=True, **kw)
    args = [torch.tensor(a) for a in (u2, uo2, uoo2, g2)] + [p.sd.M_coef]
    got = fs.fused_rv_step_plain(*args, flux=tkpp.FLUX, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)
    # the step moved the state (not a trivial identity)
    assert np.abs(got[0].numpy() - u2).max() > 1e-2
    # the wrapper on CPU tensors is the plain version
    again = fs.fused_rv_step(*args, flux=tkpp.FLUX, **kw)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stabilization,scheme", [
    ("rv", "bdf1"), ("gfem", "bdf2")])
def test_plain_fused_step_matches_jax_fixed_step(stabilization, scheme):
    """The other stabilization and residual scheme, against the JAX
    fixed-iteration XLA step (the path the JAX tests hold its fused kernel
    to at 1e-11), from u0: one step, 1e-11."""
    cfg = dict(mesh_size=4, T=0.01, stabilization=stabilization, **BENCH)
    pj = jkpp.build(jkpp.KPPConfig(**cfg))
    pj.cfg = dataclasses.replace(pj.cfg, residual_scheme=scheme)
    (ref, _, _), _ = pj.step((pj.u0,) * 3, jnp.asarray(pj.dt))
    pt = tkpp.build(tkpp.KPPConfig(**cfg))
    sh = pt._shape2
    u2 = pt.u0.reshape(sh)
    got = fs.fused_rv_step_plain(
        u2, u2, u2, torch.full_like(u2, np.pi / 4), pt.sd.M_coef,
        flux=tkpp.FLUX, **_kwargs(pt, residual_scheme=scheme,
                                  stabilization=stabilization))[0]
    np.testing.assert_allclose(got.reshape(-1).numpy(), np.asarray(ref),
                               rtol=0, atol=TOL)


def test_cuda_step_refuses_what_it_does_not_compile_in(state):
    """The CUDA step compiles in the KPP flux and the listed schemes; any
    other raises before a launch. Tensors neither all on the CPU nor all
    on a card raise too (no fallback to the plain version)."""
    p, u2, _, _ = state
    with pytest.raises(NotImplementedError, match="KPP"):
        fs._check_kernel_options(tkpp.FLUX._replace(name="burgers"), "bdf2",
                                 "rv", "bicgstab")
    for bad in (("bdf3", "rv", "bicgstab"), ("bdf2", "si", "bicgstab"),
                ("bdf2", "rv", "gmres")):
        with pytest.raises(ValueError):
            fs._check_kernel_options(tkpp.FLUX, *bad)
    fs._check_kernel_options(tkpp.FLUX, "bdf2", "rv", "bicgstab")
    meta = torch.empty(u2.shape, device="meta")
    with pytest.raises(ValueError):
        fs.fused_rv_step(meta, meta, meta, meta, p.sd.M_coef,
                         flux=tkpp.FLUX, **_kwargs(p))
