"""Port geometry against the JAX package: rectangle meshes, quadrature
tables and the structured stencil data (conservation_fem_tpu_torch
ops/mesh, ops/assembly, ops/structured.build_structured)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.ops import assembly as jasm
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.ops import structured as jst
from conservation_fem_tpu_torch.ops import assembly as tasm
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import structured as tst

FIELDS = ("points", "cells", "boundary_mask", "area", "grads", "h_cell")


@pytest.mark.parametrize("mesh_size", [2, 5, 8])
def test_rectangle_mesh_matches_jax_exactly(mesh_size):
    """The KPP meshes (4 * mesh_size cells a side on [-2,2]^2). Exact: the
    same numpy f64 arithmetic on the same inputs."""
    n = 4 * mesh_size
    ref = jmesh.rectangle_mesh((-2, -2), (2, 2), nx=n, ny=n)
    got = tmesh.rectangle_mesh((-2, -2), (2, 2), nx=n, ny=n)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)


@pytest.mark.parametrize("mesh_size", [2, 8])
def test_rectangle_mesh_lean_matches_jax_exactly(mesh_size):
    """Exact, and identical to the full constructor (same exemplar cells)."""
    n = 4 * mesh_size
    ref = jmesh.rectangle_mesh_lean((-2, -2), (2, 2), nx=n, ny=n)
    got = tmesh.rectangle_mesh_lean((-2, -2), (2, 2), nx=n, ny=n)
    full = tmesh.rectangle_mesh((-2, -2), (2, 2), nx=n, ny=n)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(full, f),
                                      err_msg=f)


def test_quadrature_tables_and_local_mass_exact():
    """Exact: the tables are the same f64 literals and arithmetic."""
    np.testing.assert_array_equal(tasm._DUN4_W, np.asarray(jasm._DUN4_W))
    np.testing.assert_array_equal(tasm._quad_basis(),
                                  np.asarray(jasm._quad_basis()))
    area = np.random.default_rng(0).random(5)
    np.testing.assert_array_equal(
        tasm.local_mass(torch.tensor(area)).numpy(),
        np.asarray(jasm.local_mass(jnp.asarray(area))))


def _jax_sd(n):
    host = jmesh.rectangle_mesh((-2, -2), (2, 2), nx=n, ny=n)
    return host, jst.build_structured(host, n, n, jnp.float64)


def _fields(sd):
    return {k: (v if isinstance(v, int) else np.asarray(v))
            for k, v in sd._asdict().items()}


@pytest.mark.parametrize("n", [4, 8])
def test_build_structured_matches_jax(n):
    """Same sums in the same order: equal to f64 roundoff (1e-15 on
    stencil entries of size ~area)."""
    _, sdj = _jax_sd(n)
    host = tmesh.rectangle_mesh((-2, -2), (2, 2), nx=n, ny=n)
    sdt = tst.build_structured(host, n, n, torch.float64, "cpu")
    ref, got = _fields(sdj), _fields(sdt)
    for k in ("nx", "ny"):
        assert got[k] == ref[k]
    for k in ("grads", "area", "bc2", "phi", "qw", "h_cg2"):
        np.testing.assert_array_equal(got[k], ref[k],
                                      err_msg=k)
    for k in ("M_coef", "diagM2"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-15, err_msg=k)


def test_structured_data_from_numpy_carries_jax_fields():
    """The JAX operator set crosses into the port unchanged (exact)."""
    _, sdj = _jax_sd(4)
    sdt = tst.structured_data_from_numpy(_fields(sdj), "cpu", torch.float64)
    for k, v in _fields(sdj).items():
        got = getattr(sdt, k)
        if isinstance(v, int):
            assert got == v
        else:
            np.testing.assert_array_equal(got.numpy(), v, err_msg=k)
    assert sdt.bc2.dtype == torch.bool
