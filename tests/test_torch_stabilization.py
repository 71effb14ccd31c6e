"""The port's stabilisation library against the JAX package's
(conservation_fem_tpu_torch/ops/stabilization.py vs
conservation_fem_tpu/ops/stabilization.py): the five RV variants, SI
(alpha, psi, epsilon), the sigmoid and the Jacobi smoothing, f64 on
irregular_mesh(nx=8, seed=1) with numpy-seeded fields, within 1e-13; and
the reference behaviours kept on purpose (the tiny guard, last-cell-wins
in file cell order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.models import burgers as jburgers
from conservation_fem_tpu.ops import assembly as jasm
from conservation_fem_tpu.ops import bc as jbc
from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.ops import stabilization as jstab
from conservation_fem_tpu_torch.models import burgers as tburgers
from conservation_fem_tpu_torch.ops import assembly as tasm
from conservation_fem_tpu_torch.ops import bc as tbc
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import stabilization as tstab

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
    rng = np.random.default_rng(1)
    n, M = tm.n_nodes, tm.n_cells
    I = dict(u=np.pi / 4 + 3.0 * rng.random(n), un=np.pi / 4 + 3.0 * rng.random(n),
             rh=rng.normal(size=n), h=0.3 + 0.2 * rng.random(n),
             w=rng.normal(size=(n, 2)), beta=0.5 + rng.random(n),
             beta_cell=0.5 + rng.random(M), h_cell=tm.h_cell,
             alpha=rng.random(n))
    J = dict(m=jm.device_arrays(jnp.float64), x=jnp.asarray, stab=jstab,
             one=jnp.ones_like, burgers=jburgers.flux_prime_norm)
    T = dict(m=tm.device_arrays(torch.float64, "cpu"), x=torch.tensor,
             stab=tstab, one=torch.ones_like,
             burgers=tburgers.flux_prime_norm)
    J["K"] = jbc.ell_with_bc(J["m"], jasm.assemble_stiffness(J["m"]),
                             J["m"].boundary_mask)
    T["K"] = tbc.ell_with_bc(T["m"], tasm.assemble_stiffness(T["m"]),
                             T["m"].boundary_mask)
    return J, T, I


def _f(S, I, k):
    return S["x"](I[k])


OPS = {
    "inf_norm_centered": lambda S, I: S["stab"].inf_norm_centered(
        _f(S, I, "u")),
    "rv_epsilon": lambda S, I: S["stab"].rv_epsilon(
        0.5, 4.0, _f(S, I, "h"), _f(S, I, "rh"), _f(S, I, "beta")),
    "rv_epsilon_1storder": lambda S, I: S["stab"].rv_epsilon_1storder(
        _f(S, I, "h"), _f(S, I, "beta")),
    "rv_epsilon_nonlinear_kpp": lambda S, I: S["stab"].rv_epsilon_nonlinear(
        S["m"], 0.5, 4.0, _f(S, I, "u"), _f(S, I, "un"), S["one"],
        _f(S, I, "rh"), _f(S, I, "h")),
    "rv_epsilon_nonlinear_burgers": lambda S, I:
        S["stab"].rv_epsilon_nonlinear(
            S["m"], 0.5, 10.0, _f(S, I, "u") - 2.0, _f(S, I, "un"),
            S["burgers"], _f(S, I, "rh"), _f(S, I, "h")),
    "rv_epsilon_linear": lambda S, I: S["stab"].rv_epsilon_linear(
        S["m"], 0.5, 4.0, _f(S, I, "u"), _f(S, I, "un"), _f(S, I, "w"),
        _f(S, I, "rh"), _f(S, I, "h")),
    "rv_epsilon_linear_simple": lambda S, I:
        S["stab"].rv_epsilon_linear_simple(
            0.5, 4.0, _f(S, I, "w"), _f(S, I, "rh"), _f(S, I, "un"),
            _f(S, I, "h")),
    "rv_epsilon_system": lambda S, I: S["stab"].rv_epsilon_system(
        S["m"], 0.5, 4.0, _f(S, I, "u"), _f(S, I, "beta"), _f(S, I, "rh"),
        _f(S, I, "h")),
    "rv_epsilon_cell_last": lambda S, I: S["stab"].rv_epsilon_cell(
        S["m"], 0.5, 4.0, _f(S, I, "rh"), _f(S, I, "beta_cell"),
        _f(S, I, "h_cell")),
    "rv_epsilon_cell_max": lambda S, I: S["stab"].rv_epsilon_cell(
        S["m"], 0.5, 4.0, _f(S, I, "rh"), _f(S, I, "beta_cell"),
        _f(S, I, "h_cell"), scatter="max"),
    "sigmoid_activation": lambda S, I: S["stab"].sigmoid_activation(
        _f(S, I, "alpha")),
    "si_alpha": lambda S, I: S["stab"].si_alpha(S["m"], S["K"],
                                                _f(S, I, "u")),
    "si_epsilon": lambda S, I: tuple(S["stab"].si_epsilon(
        S["m"], 0.5, S["K"], _f(S, I, "u"), _f(S, I, "beta"),
        _f(S, I, "h"))),
    "smooth_vector": lambda S, I: S["stab"].smooth_vector(
        S["m"], _f(S, I, "u"), 4.0),
}


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(a) for a in x])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("op", sorted(OPS))
def test_stabilization_op_matches_jax(sides, op):
    J, T, I = sides
    ref, got = _np(OPS[op](J, I)), _np(OPS[op](T, I))
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_rv_tiny_guard_on_a_constant_state(sides):
    """A constant state gives n_i = 0 at every node: the tiny floor keeps
    R_i finite (huge), so eps is Cvel h beta everywhere — the reference's
    hair trigger, kept on purpose."""
    J, T, I = sides
    u = np.full(T["m"].points.shape[0], np.pi / 4)
    args = lambda S: (S["m"], 0.5, 4.0, S["x"](u), S["x"](u), S["one"],
                      _f(S, I, "rh"), _f(S, I, "h"))
    got = tstab.rv_epsilon_nonlinear(*args(T)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jstab.rv_epsilon_nonlinear(*args(J))), rtol=0,
        atol=TOL)
    np.testing.assert_allclose(got, 0.5 * I["h"], rtol=1e-15, atol=0)


def test_rv_epsilon_cell_last_cell_wins(sides):
    """Every node takes the eps of its highest-numbered cell (file order):
    checked against a plain loop over the cells."""
    _, T, I = sides
    m = T["m"]
    eps = tstab.rv_epsilon_cell(m, 0.5, 4.0, _f(T, I, "rh"),
                                _f(T, I, "beta_cell"),
                                _f(T, I, "h_cell")).numpy()
    R_cell = np.abs(I["rh"][m.cells.numpy()]).max(axis=1)
    eps_k = np.minimum(0.5 * I["h_cell"] * I["beta_cell"],
                       4.0 * I["h_cell"] ** 2 * R_cell)
    want = np.zeros_like(eps)
    for k, cell in enumerate(m.cells.numpy()):
        want[cell] = eps_k[k]
    np.testing.assert_array_equal(eps, want)
