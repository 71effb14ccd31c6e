"""The port's ELL assembly, products and boundary conditions against the
JAX package's (conservation_fem_tpu_torch/ops/{assembly,spmv,bc,helpers}.py
vs conservation_fem_tpu/ops/...), f64 on irregular_mesh(nx=8, seed=1),
numpy-seeded fields.

Tolerance 1e-13 absolute: the same formulas on O(1)-O(10) values; the
einsum and segment-sum orders differ at most in the last bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import burgers as jburgers
from conservation_fem_tpu.models import kpp as jkpp
from conservation_fem_tpu.ops import assembly as jasm
from conservation_fem_tpu.ops import bc as jbc
from conservation_fem_tpu.ops import helpers as jhelpers
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.ops import spmv as jspmv
from conservation_fem_tpu_torch.models import burgers as tburgers
from conservation_fem_tpu_torch.models import kpp as tkpp
from conservation_fem_tpu_torch.ops import assembly as tasm
from conservation_fem_tpu_torch.ops import bc as tbc
from conservation_fem_tpu_torch.ops import helpers as thelpers
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import spmv as tspmv

TOL = 1e-13


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
def sides():
    jm = jmesh.irregular_mesh((-2, -2), (2, 2), nx=8, seed=1)
    tm = tmesh.irregular_mesh((-2, -2), (2, 2), nx=8, seed=1)
    rng = np.random.default_rng(0)
    n, M = tm.n_nodes, tm.n_cells
    K = tm.max_patch
    inputs = dict(
        u=np.pi / 4 + 3.0 * rng.random(n), v=rng.normal(size=n),
        eps=0.05 * rng.random(n), w=rng.normal(size=(n, 2)),
        A=rng.normal(size=(n, K)) * tm.patch_mask,
        cellmat=rng.normal(size=(M, 3, 3)), cellvec=rng.normal(size=(M, 3)),
        bc=tm.boundary_mask)
    J = dict(m=jm.device_arrays(jnp.float64), x=jnp.asarray, np=jnp,
             asm=jasm, spmv=jspmv, bc=jbc,
             kpp=jkpp.flux_prime, burgers=jburgers.flux_prime)
    T = dict(m=tm.device_arrays(torch.float64, "cpu"), x=torch.tensor,
             np=torch, asm=tasm, spmv=tspmv, bc=tbc,
             kpp=tkpp.FLUX, burgers=tburgers.FLUX)
    return J, T, inputs


def _f(S, I, k):
    return S["x"](I[k])


# name: call(side, inputs) -> array or tuple of arrays
OPS = {
    "local_mass": lambda S, I: S["asm"].local_mass(S["m"].area),
    "local_stiffness": lambda S, I: S["asm"].local_stiffness(
        S["m"].area, S["m"].grads),
    "local_convection": lambda S, I: S["asm"].local_convection(
        S["m"].area, S["m"].grads, _f(S, I, "w")[S["m"].cells]),
    "local_eps_stiffness": lambda S, I: S["asm"].local_eps_stiffness(
        S["m"].area, S["m"].grads, _f(S, I, "eps")[S["m"].cells]),
    "scatter_matrix": lambda S, I: S["asm"].scatter_matrix(
        S["m"], _f(S, I, "cellmat")),
    "scatter_vector": lambda S, I: S["asm"].scatter_vector(
        S["m"], _f(S, I, "cellvec")),
    "assemble_mass": lambda S, I: S["asm"].assemble_mass(S["m"]),
    "assemble_stiffness": lambda S, I: S["asm"].assemble_stiffness(S["m"]),
    "assemble_convection": lambda S, I: S["asm"].assemble_convection(
        S["m"], _f(S, I, "w")),
    "assemble_eps_stiffness": lambda S, I: S["asm"].assemble_eps_stiffness(
        S["m"], _f(S, I, "eps")),
    "assemble_directional_convection": lambda S, I:
        S["asm"].assemble_directional_convection(S["m"]),
    "lumped_mass": lambda S, I: S["asm"].lumped_mass(S["m"]),
    "convection_rhs_flux_kpp": lambda S, I: S["asm"].convection_rhs_flux(
        S["m"], _f(S, I, "u"), S["kpp"]),
    "convection_rhs_flux_burgers": lambda S, I:
        S["asm"].convection_rhs_flux(S["m"], _f(S, I, "v"), S["burgers"]),
    "assemble_flux_jacobian_kpp": lambda S, I:
        S["asm"].assemble_flux_jacobian(S["m"], _f(S, I, "u"), S["kpp"]),
    "assemble_flux_jacobian_burgers": lambda S, I:
        S["asm"].assemble_flux_jacobian(S["m"], _f(S, I, "v"),
                                        S["burgers"]),
    "mass_apply_cellwise": lambda S, I: S["asm"].mass_apply_cellwise(
        S["m"], _f(S, I, "v")),
    "l2_norm_sq": lambda S, I: S["asm"].l2_norm_sq(S["m"], _f(S, I, "v")),
    "l2_error_vs_function": lambda S, I: S["asm"].l2_error_vs_function(
        S["m"], _f(S, I, "u"),
        lambda x, y, t: S["np"].sin(x + 2 * t) * S["np"].cos(y), 0.3),
    "ell_matvec": lambda S, I: S["spmv"].ell_matvec(
        S["m"], _f(S, I, "A"), _f(S, I, "v")),
    "ell_diag": lambda S, I: S["spmv"].ell_diag(S["m"], _f(S, I, "A")),
    "ell_transpose_matvec": lambda S, I: S["spmv"].ell_transpose_matvec(
        S["m"], _f(S, I, "A"), _f(S, I, "v")),
    "ell_add": lambda S, I: S["spmv"].ell_add(
        _f(S, I, "A"), 2.0 * _f(S, I, "A"), _f(S, I, "A")),
    "constrained_matvec": lambda S, I: S["bc"].constrained_matvec(
        S["m"], _f(S, I, "A"), _f(S, I, "v"), _f(S, I, "bc")),
    "lift_rhs": lambda S, I: S["bc"].lift_rhs(
        S["m"], _f(S, I, "A"), _f(S, I, "v"), _f(S, I, "u"), _f(S, I, "bc")),
    "ell_with_bc": lambda S, I: S["bc"].ell_with_bc(
        S["m"], _f(S, I, "A"), _f(S, I, "bc")),
    "constrain_residual": lambda S, I: S["bc"].constrain_residual(
        _f(S, I, "v"), _f(S, I, "u"), _f(S, I, "eps"), _f(S, I, "bc")),
}


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(a) for a in x])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("op", sorted(OPS))
def test_assembly_op_matches_jax(sides, op):
    J, T, I = sides
    ref = _np(OPS[op](J, I))
    got = _np(OPS[op](T, I))
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_scatter_is_the_sorted_sequential_sum(sides):
    """The segmented sum adds each target's contributions from 0 in the
    mesh's sorted order: the same bits as an index_add_ in that order (the
    JAX package's sorted segment_sum on the CPU)."""
    _, T, I = sides
    m = T["m"]
    vals = torch.tensor(I["cellmat"])
    got = tasm.scatter_matrix(m, vals).reshape(-1)
    ref = torch.zeros_like(got).index_add_(
        0, m.mat_segs, vals.reshape(-1)[m.mat_perm])
    assert torch.equal(got, ref)


def test_get_nodal_h_ell_matches_jax(sides):
    J, T, _ = sides
    ref = np.asarray(jhelpers.get_nodal_h(J["m"]))
    got = thelpers.get_nodal_h_ell(T["m"]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert 0.1 < got.min() and got.max() < 0.7
