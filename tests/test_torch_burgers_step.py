"""The port's Burgers path through the step kernels' wrappers, f64, on the
CPU (the wrappers then run their plain versions): the plain step with the
Burgers flux against the JAX Pallas kernel in interpret mode, and the
sharded path against the single-device path (the fixed-iteration config
through the whole-step dispatch: test_torch_burgers.py, which shares its
JAX build).

Tolerance 1e-11 absolute on O(1) fields: the bound of the JAX package's
own fused-vs-XLA and sharded identity tests (test_pallas_fused.py,
test_structured_fused_sharded.py); the port sums the same terms in
another order. Interpret mode costs ~5 s per step here, so that case
stays at mesh 4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import burgers as jb
from conservation_fem_tpu.ops.pallas_fused import fused_rv_step as jax_fused
from conservation_fem_tpu_torch.models import burgers as tb
from conservation_fem_tpu_torch.ops import fused_step as fs
from conservation_fem_tpu_torch.parallel import (LocalBlocks,
                                                 ShardedFusedStructured)

TOL = 1e-11
# the fixed-iteration config of the JAX fused-kernel test
# (test_pallas_fused.py:test_fused_burgers_solve_matches_plain)
FIXED = dict(mesh_size=16, T=0.1, stabilization="rv", cg_iters=10,
             newton_iters=2, newton_linear_iters=8, modified_newton=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these grids are small, and the test run shares
    the cores among several pytest worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mid_state():
    """A mid-trajectory history at mesh 4 (the fixed config, 2 of its 4
    steps taken, shocks formed) and the Dirichlet data of step 3."""
    p = tb.build(tb.BurgersConfig(**{**FIXED, "mesh_size": 4, "T": 0.5}),
                 device="cpu")
    carry = (p.u0,) * 3
    times = p.step_times()
    for t in times[:2]:
        carry, _ = p.step(carry, t)
    sh = p._shape2
    g2 = p.dirichlet_grid(p.dirichlet_frames(times[2:3])[0])
    return p, [v.reshape(sh).numpy() for v in carry] + [g2.numpy()]


def test_plain_step_matches_pallas_interpret(mid_state):
    """fused_rv_step_plain with the Burgers flux against the JAX Pallas
    kernel with burgers.flux_prime_xy, interpret mode, one step."""
    p, fields = mid_state
    # interpret mode costs per pass: the fixed config's counts, trimmed to
    # one Newton iteration (its Jacobian holds f'', its residual f')
    kw = dict(p.fused_step_kwargs(), cg_iters=4, lin_iters=4,
              newton_iters=1)
    del kw["flux"]
    ref = jax_fused(*(jnp.asarray(a) for a in fields),
                    jnp.asarray(p.sd.M_coef.numpy()),
                    fprime=jb.flux_prime, fprime_norm=jb.flux_prime_norm,
                    fprime_xy=jb.flux_prime_xy, interpret=True, **kw)
    args = [torch.tensor(a) for a in fields] + [p.sd.M_coef]
    got = fs.fused_rv_step_plain(*args, flux=tb.FLUX, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)
    assert np.abs(got[0].numpy() - fields[0]).max() > 1e-2


def test_sharded_path_matches_single_device():
    """ShardedFusedStructured on 2 row blocks (the block kernel's and the
    tiled kernel's block mode's plain version) against the single-device
    plain fused path: the problem's flux and the Dirichlet data of each
    step's t reach every block; and from the single-device state after 2
    of the 4 steps, set with set_carry(..., start_step=2), to the same
    end."""
    cfg = tb.BurgersConfig(**{**FIXED, "inner_solver": "cheby",
                              "newton_linear_iters": 12})
    p = tb.build(dataclasses.replace(cfg, use_kernels=True), device="cpu")
    ref = p.solve().u
    assert p.num_steps == 4
    carry = (p.u0,) * 3
    for t in p.step_times()[:2]:
        carry, _ = p.step(carry, t)
    for kernel in ("block", "tiled"):
        sh = ShardedFusedStructured(tb.build(cfg, device="cpu"),
                                    LocalBlocks(2, "cpu"), kernel=kernel)
        np.testing.assert_allclose(sh.solve().numpy(), ref.numpy(), rtol=0,
                                   atol=TOL)
        sh.set_carry(*carry, start_step=2)
        np.testing.assert_allclose(sh.solve().numpy(), ref.numpy(), rtol=0,
                                   atol=TOL)
    with pytest.raises(ValueError, match="start_step"):
        sh.set_carry(*carry, start_step=5)
