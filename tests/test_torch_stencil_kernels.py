"""The plain versions of the stencil kernels against the JAX Pallas kernels
run in interpret mode (conservation_fem_tpu_torch/ops/stencil_kernels.py
vs conservation_fem_tpu/ops/pallas_stencil.py), and the wrappers'
device dispatch on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.ops import pallas_stencil as pk
from conservation_fem_tpu.ops import structured as jst
from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops import stencil_kernels as sk

N = 12


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
    host = jmesh.rectangle_mesh((-2, -2), (2, 2), nx=N, ny=N)
    sd = jst.build_structured(host, N, N, jnp.float64)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N + 1, N + 1))
    coef = rng.normal(size=(7, N + 1, N + 1))
    return sd, x, coef


@pytest.mark.parametrize("which", ["random", "mass"])
def test_stencil_matvec_plain_matches_pallas(setup, which):
    """1e-14: the same 7 products summed in the same order."""
    sd, x, coef = setup
    if which == "mass":
        coef = np.asarray(sd.M_coef)
    ref = np.asarray(pk.stencil_matvec(jnp.asarray(coef), jnp.asarray(x),
                                       interpret=True))
    got = sk.stencil_matvec_plain(torch.tensor(coef), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14)
    # on CPU tensors the wrapper is the plain version
    np.testing.assert_array_equal(
        sk.stencil_matvec(torch.tensor(coef), torch.tensor(x)).numpy(),
        got.numpy())


@pytest.mark.parametrize("rtol", [1e-12, 1e-5])
def test_cg_solve_plain_matches_pallas(setup, rtol):
    """Same adaptive stopping test, so the same iteration count; the
    solutions agree to 1e-11 on an O(1e2) solution (f64 reduction order)."""
    sd, x, _ = setup
    b = jnp.where(sd.bc2, 0.0, jnp.asarray(x))
    ref = np.asarray(pk.cg_solve(sd.M_coef, b, sd.bc2, sd.diagM2, rtol=rtol,
                                 interpret=True))
    args = (torch.tensor(np.asarray(sd.M_coef)), torch.tensor(np.asarray(b)),
            torch.tensor(np.asarray(sd.bc2)),
            torch.tensor(np.asarray(sd.diagM2)))
    got = sk.cg_solve_plain(*args, rtol=rtol)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-11)
    np.testing.assert_array_equal(sk.cg_solve(*args, rtol=rtol).numpy(),
                                  got.numpy())
    # it solves the pinned system
    r = args[1] - torch.where(args[2], got, sk.stencil_matvec_plain(
        args[0], torch.where(args[2], 0.0, got)))
    assert float(r.norm() / args[1].norm()) < 10 * rtol


def test_cg_solve_plain_matches_pallas_on_the_burgers_mass_matrix():
    """The mass solve of the Burgers reference config (unit square, mesh
    12, rtol 1e-12): the plain version against the Pallas kernel in
    interpret mode, on a right-hand side pinned to 0 on the frame. Same
    stopping test, so the same iterations; 1e-12 on an O(1) solution (f64
    reduction order)."""
    host = jmesh.rectangle_mesh((0.0, 0.0), (1.0, 1.0), nx=N, ny=N)
    sd = jst.build_structured(host, N, N, jnp.float64)
    rng = np.random.default_rng(12)
    b = jnp.where(sd.bc2, 0.0, jnp.asarray(rng.normal(size=(N + 1, N + 1))
                                          / N ** 2))
    ref = np.asarray(pk.cg_solve(sd.M_coef, b, sd.bc2, sd.diagM2,
                                 rtol=1e-12, interpret=True))
    args = (torch.tensor(np.asarray(sd.M_coef)), torch.tensor(np.asarray(b)),
            torch.tensor(np.asarray(sd.bc2)),
            torch.tensor(np.asarray(sd.diagM2)))
    got = sk.cg_solve_plain(*args, rtol=1e-12)
    assert float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


def test_wrappers_refuse_mixed_or_unknown_devices(setup):
    """No silent fallback: a tensor that is neither all-CPU nor all-CUDA
    raises instead of reaching the plain version."""
    _, x, coef = setup
    meta = torch.empty((N + 1, N + 1), device="meta")
    with pytest.raises(ValueError):
        sk.stencil_matvec(torch.tensor(coef), meta)
    with pytest.raises(ValueError):
        _build.on_cpu("probe", torch.tensor(x), meta)


def test_build_without_nvcc_raises(monkeypatch):
    """Where no nvcc is found the build raises; nothing is downloaded and
    no prebuilt library is looked for."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda path: False if path.endswith("nvcc")
                        else os.path.lexists(path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert len(_build.source_hash()) == 64
    assert any(p.endswith("fused_step.cu") for p in _build._sources())
