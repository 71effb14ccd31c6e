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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run shares the cores among several
    pytest worker processes, where torch's thread pool only
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    "lumped_mass_grid": (lambda sd, x, I: jst.lumped_mass_grid(sd),
                         lambda sd, x, I: tst.lumped_mass_grid(sd)),
    "stiffness_bc_coef": (lambda sd, x, I: jst.stiffness_bc_coef(sd),
                          lambda sd, x, I: tst.stiffness_bc_coef(sd)),
    "si_epsilon_grid": (
        lambda sd, x, I: jst.si_epsilon_grid(
            sd, 0.5, jst.stiffness_bc_coef(sd), x(I["u"]), x(I["eps"]) + 1),
        lambda sd, x, I: tst.si_epsilon_grid(
            sd, 0.5, tst.stiffness_bc_coef(sd), x(I["u"]), x(I["eps"]) + 1)),
    "rv_epsilon_system_grid": (
        lambda sd, x, I: jst.rv_epsilon_system_grid(
            sd, 0.5, 4.0, x(I["u"]), x(I["rh"]), x(I["eps"]) + 1),
        lambda sd, x, I: tst.rv_epsilon_system_grid(
            sd, 0.5, 4.0, x(I["u"]), x(I["rh"]), x(I["eps"]) + 1)),
    "smooth_vector_grid": (
        lambda sd, x, I: jst.smooth_vector_grid(sd, x(I["u"]), 4.0),
        lambda sd, x, I: tst.smooth_vector_grid(sd, x(I["u"]), 4.0)),
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


# -- the port's stencil backend against its own ELL backend on the same
# rectangle (cf. tests/test_structured.py, the JAX package's identity) --


@pytest.fixture(scope="module")
def stencil_and_ell():
    from conservation_fem_tpu_torch.ops import assembly as tasm

    host = tmesh.rectangle_mesh((-2, -2), (2, 2), nx=12, ny=12)
    m = host.device_arrays(torch.float64, "cpu")
    sd = tst.build_structured(host, 12, 12, torch.float64, "cpu")
    x = torch.tensor(np.random.default_rng(0).normal(size=host.n_nodes))
    return m, sd, x, tasm


def _grid(v):
    return v.reshape(13, 13)


@pytest.mark.parametrize("op", ["mass", "nonlinear_rhs", "keps",
                                "flux_jacobian", "rv_epsilon", "si_epsilon",
                                "smooth_vector", "lumped_mass"])
def test_stencil_op_matches_ell(stencil_and_ell, op):
    from conservation_fem_tpu_torch.ops import bc as tbc
    from conservation_fem_tpu_torch.ops import stabilization as tstab
    from conservation_fem_tpu_torch.ops.spmv import ell_matvec

    m, sd, x, asm = stencil_and_ell
    v, eps = torch.sin(x), x.abs() * 0.01
    if op == "mass":
        got = tst.mass_matvec(sd, _grid(x))
        ref = ell_matvec(m, asm.assemble_mass(m), x)
    elif op == "nonlinear_rhs":
        got = tst.nonlinear_rhs(sd, _grid(x), tkpp.FLUX)
        ref = asm.convection_rhs_flux(m, x, tkpp.FLUX)
    elif op == "keps":
        got = tst.matvec(sd, tst.keps_coef(sd, _grid(eps)), _grid(v))
        ref = ell_matvec(m, asm.assemble_eps_stiffness(m, eps), v)
    elif op == "flux_jacobian":
        got = tst.matvec(sd, tst.flux_jacobian_coef(sd, _grid(x), tkpp.FLUX),
                         _grid(v))
        ref = ell_matvec(m, asm.assemble_flux_jacobian(m, x, tkpp.FLUX), v)
    elif op == "rv_epsilon":
        Rh = torch.sin(5 * x)
        got = tst.rv_epsilon(sd, 0.5, 4.0, _grid(x), _grid(Rh),
                             tkpp.flux_prime_norm)
        ref = tstab.rv_epsilon_nonlinear(m, 0.5, 4.0, x, x,
                                         tkpp.flux_prime_norm, Rh,
                                         sd.h_cg2.reshape(-1))
    elif op == "si_epsilon":
        K = tbc.ell_with_bc(m, asm.assemble_stiffness(m), m.boundary_mask)
        got = tst.si_epsilon_grid(sd, 0.5, tst.stiffness_bc_coef(sd),
                                  _grid(x), _grid(eps + 1))
        ref = tstab.si_epsilon(m, 0.5, K, x, eps + 1,
                               sd.h_cg2.reshape(-1)).epsilon
    elif op == "smooth_vector":
        got = tst.smooth_vector_grid(sd, _grid(x), 4.0)
        ref = tstab.smooth_vector(m, x, 4.0)
    else:
        got = tst.lumped_mass_grid(sd)
        ref = asm.lumped_mass(m)
    torch.testing.assert_close(got.reshape(-1), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("over", [dict(), dict(stabilization="si"),
                                  dict(stabilization="gfem", smooth_l=2.0)])
def test_full_kpp_solve_stencil_matches_ell(over):
    """End to end, the port's two backends on the KPP mesh 4 (5 steps):
    within 1e-10, the JAX package's bound for its own pair."""
    cfg = dict(mesh_size=4, T=0.05, **over)
    a = tkpp.build(tkpp.KPPConfig(backend="stencil", **cfg), device="cpu")
    b = tkpp.build(tkpp.KPPConfig(backend="ell", **cfg), device="cpu")
    assert hasattr(a, "sd") and not hasattr(b, "sd")
    torch.testing.assert_close(a.solve().u, b.solve().u, rtol=0, atol=1e-10)
