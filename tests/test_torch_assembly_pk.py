"""The port's Pk assembly (ops/assembly_pk.py) and nodal h against the JAX
package's, f64 on the CPU, at k = 2 and 3 on disk_mesh(1/4) with the
curved boundary (isoparametric boundary cells) and on a straight
rectangle: every form within 1e-13 of the largest entry (the same
quadrature sums in other orders), from numpy-seeded fields, with the
Burgers and the KPP flux (whose f'' is not constant)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import advection_ho as jho
from conservation_fem_tpu.ops import assembly_pk as japk
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.ops import spaces as jsp
from conservation_fem_tpu_torch.models import advection_ho as tho
from conservation_fem_tpu_torch.models import burgers as tburgers
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import assembly_pk as tapk
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import spaces as tsp

TOL = 1e-13
# the JAX package's f' of each flux, beside the port's Flux
JAX_FPRIME = {
    "burgers": lambda u: jnp.stack([u, u], axis=-1),
    "kpp": lambda u: jnp.stack([jnp.cos(u), -jnp.sin(u)], axis=-1),
}
T_FLUX = {"burgers": tburgers.FLUX, "kpp": tkpp.FLUX}
CASES = [(2, "disk"), (3, "disk"), (2, "rect"), (3, "rect")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run shares the cores among several
    pytest worker processes, where torch's thread pool only
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _spaces(k, mesh):
    if mesh == "disk":
        proj = tho.unit_disk_projector
        js = jsp.build_space(jmesh.disk_mesh(1 / 4), k,
                             boundary_projector=proj)
        ts = tsp.build_space(tmesh.disk_mesh(1 / 4), k,
                             boundary_projector=proj)
    else:
        js = jsp.build_space(jmesh.rectangle_mesh((0, 0), (1, 1), nx=3), k)
        ts = tsp.build_space(tmesh.rectangle_mesh((0, 0), (1, 1), nx=3), k)
    rng = np.random.default_rng(10 * k + len(mesh))
    fields = dict(u=rng.uniform(-1, 2, ts.ndof),
                  eps=rng.uniform(0, 0.1, ts.ndof),
                  w=rng.normal(size=(ts.ndof, 2)))
    return js.device_arrays(jnp.float64), ts.device_arrays(torch.float64,
                                                           "cpu"), fields


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= TOL * scale, (err, scale)


def _both(name, k, mesh, *field_names):
    ja, ta, f = _spaces(k, mesh)
    jargs = [jnp.asarray(f[n]) for n in field_names]
    targs = [torch.as_tensor(f[n]) for n in field_names]
    return getattr(tapk, name)(ta, *targs), getattr(japk, name)(ja, *jargs)


@pytest.mark.parametrize("k,mesh", CASES)
@pytest.mark.parametrize("form,fields", [
    ("assemble_mass", ()), ("assemble_stiffness", ()),
    ("assemble_convection", ("w",)), ("assemble_eps_stiffness", ("eps",)),
    ("mass_apply", ("u",)), ("lumped_mass", ()), ("quad_coords", ()),
])
def test_linear_forms_match_jax(form, fields, k, mesh):
    _close(*_both(form, k, mesh, *fields))


@pytest.mark.parametrize("k,mesh", CASES)
@pytest.mark.parametrize("flux", ["burgers", "kpp"])
def test_flux_forms_match_jax(flux, k, mesh):
    ja, ta, f = _spaces(k, mesh)
    u = f["u"]
    _close(tapk.convection_rhs_flux(ta, torch.as_tensor(u), T_FLUX[flux]),
           japk.convection_rhs_flux(ja, jnp.asarray(u), JAX_FPRIME[flux]))
    _close(tapk.assemble_flux_jacobian(ta, torch.as_tensor(u), T_FLUX[flux]),
           japk.assemble_flux_jacobian(ja, jnp.asarray(u), JAX_FPRIME[flux]))


@pytest.mark.parametrize("k,mesh", CASES)
def test_jacobian_is_the_derivative_of_the_rhs(k, mesh):
    """J v = d/ds N(u + s v) at s = 0, by a central difference (KPP)."""
    _, ta, f = _spaces(k, mesh)
    u = torch.as_tensor(f["u"])
    v = torch.as_tensor(np.random.default_rng(k).normal(size=u.shape))
    J = tapk.assemble_flux_jacobian(ta, u, tkpp.FLUX)
    Jv = (J * v[ta.patch_cols]).sum(dim=1)
    s = 1e-6
    fd = (tapk.convection_rhs_flux(ta, u + s * v, tkpp.FLUX)
          - tapk.convection_rhs_flux(ta, u - s * v, tkpp.FLUX)) / (2 * s)
    assert float((Jv - fd).abs().max()) <= 1e-7 * float(Jv.abs().max())


@pytest.mark.parametrize("k,mesh", CASES)
def test_l2_error_and_nodal_h_match_jax(k, mesh):
    ja, ta, f = _spaces(k, mesh)
    u = f["u"]
    jfn = lambda x, y: jnp.sin(x) * y
    tfn = lambda x, y: torch.sin(x) * y
    _close(tapk.l2_error_vs_function(ta, torch.as_tensor(u), tfn),
           japk.l2_error_vs_function(ja, jnp.asarray(u), jfn))
    jfn_t = lambda x, y, t: x * t + y
    tfn_t = lambda x, y, t: x * t + y
    _close(tapk.l2_error_vs_function(ta, torch.as_tensor(u), tfn_t, t=0.3),
           japk.l2_error_vs_function(ja, jnp.asarray(u), jfn_t, t=0.3))
    _close(tho.get_nodal_h_pk(ta), jho.get_nodal_h_pk(ja))


def test_assembly_exactness():
    """The mass integrates 1 to the domain's area and the stiffness
    annihilates constants (straight rectangle, exact to roundoff)."""
    _, ta, _ = _spaces(3, "rect")
    M = tapk.assemble_mass(ta)
    one = torch.ones(ta.patch_cols.shape[0], dtype=torch.float64)
    Mone = (M * one[ta.patch_cols]).sum(dim=1)
    assert abs(float(Mone.sum()) - 1.0) < 1e-14
    assert abs(float(tapk.lumped_mass(ta).sum()) - 1.0) < 1e-14
    K = tapk.assemble_stiffness(ta)
    assert float((K * one[ta.patch_cols]).sum(dim=1).abs().max()) < 1e-12
