"""Each structured stencil op of the port against its JAX counterpart
(conservation_fem_tpu_torch/ops/structured.py vs
conservation_fem_tpu/ops/structured.py), f64, numpy-seeded inputs.

Tolerance 1e-12 absolute: the same formulas in f64 on O(1)-O(10) inputs;
only the order of a few sums differs (einsum, mean), which moves results
by ~1e-15."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.ops import structured as jst
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import structured as tst

TOL = 1e-12
N = 8


@pytest.fixture(scope="module")
def setup():
    sdj = jst.build_structured(
        jmesh.rectangle_mesh((-2, -2), (2, 2), nx=N, ny=N), N, N,
        jnp.float64)
    sdt = tst.build_structured(
        tmesh.rectangle_mesh((-2, -2), (2, 2), nx=N, ny=N), N, N,
        torch.float64, "cpu")
    rng = np.random.default_rng(0)
    n1 = N + 1
    inputs = dict(
        u=np.pi / 4 + 3.0 * rng.random((n1, n1)),
        eps=0.05 * rng.random((n1, n1)),
        coef=rng.normal(size=(7, n1, n1)),
        loc=rng.normal(size=(2, N, N, 3, 3)),
        vals=rng.normal(size=(2, N, N, 3)),
        rh=rng.normal(size=(n1, n1)),
    )
    return sdj, sdt, inputs


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.tensor(a)


# (name, jax call, port call) on (sd, inputs-converter, inputs)
OPS = {
    "matvec": (lambda sd, x, I: jst.matvec(sd, x(I["coef"]), x(I["u"])),
               lambda sd, x, I: tst.matvec(sd, x(I["coef"]), x(I["u"]))),
    "constrained_matvec": (
        lambda sd, x, I: jst.constrained_matvec(sd, x(I["coef"]), x(I["u"])),
        lambda sd, x, I: tst.constrained_matvec(sd, x(I["coef"]),
                                                x(I["u"]))),
    "mass_matvec": (lambda sd, x, I: jst.mass_matvec(sd, x(I["u"])),
                    lambda sd, x, I: tst.mass_matvec(sd, x(I["u"]))),
    "cell_gather": (lambda sd, x, I: jst.cell_gather(sd, x(I["u"])),
                    lambda sd, x, I: tst.cell_gather(sd, x(I["u"]))),
    "node_scatter": (lambda sd, x, I: jst.node_scatter(sd, x(I["vals"])),
                     lambda sd, x, I: tst.node_scatter(sd, x(I["vals"]))),
    "local_to_stencil": (
        lambda sd, x, I: jst.local_to_stencil(sd, x(I["loc"])),
        lambda sd, x, I: tst.local_to_stencil(sd, x(I["loc"]))),
    "quad_values": (lambda sd, x, I: jst.quad_values(sd, x(I["u"])),
                    lambda sd, x, I: tst.quad_values(sd, x(I["u"]))),
    "cell_grad": (lambda sd, x, I: jst.cell_grad(sd, x(I["u"])),
                  lambda sd, x, I: tst.cell_grad(sd, x(I["u"]))),
    "nonlinear_rhs": (
        lambda sd, x, I: jst.nonlinear_rhs(sd, x(I["u"]), jkpp.flux_prime,
                                           jkpp.flux_prime_xy),
        lambda sd, x, I: tst.nonlinear_rhs(sd, x(I["u"]), tkpp.FLUX)),
    "nonlinear_rhs_stacked_flux": (
        lambda sd, x, I: jst.nonlinear_rhs(sd, x(I["u"]), jkpp.flux_prime),
        lambda sd, x, I: tst.nonlinear_rhs(sd, x(I["u"]), tkpp.FLUX)),
    "keps_coef": (lambda sd, x, I: jst.keps_coef(sd, x(I["eps"])),
                  lambda sd, x, I: tst.keps_coef(sd, x(I["eps"]))),
    "flux_jacobian_coef": (
        lambda sd, x, I: jst.flux_jacobian_coef(
            sd, x(I["u"]), jkpp.flux_prime, jkpp.flux_prime_xy),
        lambda sd, x, I: tst.flux_jacobian_coef(sd, x(I["u"]), tkpp.FLUX)),
    "patch_max": (
        lambda sd, x, I: jst._patch_reduce(x(I["u"]), jnp.maximum, -np.inf),
        lambda sd, x, I: tst._patch_reduce(x(I["u"]), torch.maximum,
                                           -np.inf)),
    "patch_min": (
        lambda sd, x, I: jst._patch_reduce(x(I["u"]), jnp.minimum, np.inf),
        lambda sd, x, I: tst._patch_reduce(x(I["u"]), torch.minimum,
                                           np.inf)),
    "rv_epsilon": (
        lambda sd, x, I: jst.rv_epsilon(sd, 0.5, 4.0, x(I["u"]), x(I["rh"]),
                                        jkpp.flux_prime_norm),
        lambda sd, x, I: tst.rv_epsilon(sd, 0.5, 4.0, x(I["u"]), x(I["rh"]),
                                        tkpp.flux_prime_norm)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_structured_op_matches_jax(setup, op):
    sdj, sdt, inputs = setup
    jax_fn, port_fn = OPS[op]
    ref = np.asarray(jax_fn(sdj, _j, inputs))
    got = port_fn(sdt, _t, inputs).numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_rv_epsilon_constant_state_hair_trigger(setup):
    """A constant u makes u_max - u_min = 0 everywhere; n_i then equals
    abs_term = 0 and the tiny guard keeps eps finite (Cvel h branch)."""
    sdj, sdt, _ = setup
    u = np.full((N + 1, N + 1), np.pi / 4)
    rh = np.random.default_rng(1).normal(size=u.shape)
    ref = np.asarray(jst.rv_epsilon(sdj, 0.5, 4.0, _j(u), _j(rh),
                                    jkpp.flux_prime_norm))
    got = tst.rv_epsilon(sdt, 0.5, 4.0, _t(u), _t(rh),
                         tkpp.flux_prime_norm).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
