"""The ELL step and the stabilisation library on the card against the same
code on the CPU. Marked ``cuda``: every test takes the ``cuda`` fixture,
which skips when no CUDA device is present. On a machine with a card:
``python -m pytest --noconftest tests/test_torch_cuda_ell.py -m cuda``.

These paths launch no hand-written kernel (the JAX package runs them as
XLA gathers and segment sums): plain PyTorch gathers, torch.segment_reduce
and scatter_reduce on CUDA tensors, held to the CPU in f64 within 1e-10
after a few steps (the sums of a reduction run in other orders there),
and the scatters to their own bits on a second call (no atomics)."""

import numpy as np
import pytest
import torch

from conservation_fem_tpu_torch.models import burgers, kpp
from conservation_fem_tpu_torch.ops import _build, assembly
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import stabilization as stab

pytestmark = pytest.mark.cuda

TOL = 1e-10
FIXED = dict(modified_newton=True, cg_iters=10, newton_iters=3,
             newton_linear_iters=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def irr():
    m = tmesh.irregular_mesh((-2, -2), (2, 2), nx=24, seed=1)
    return tmesh.reorder_mesh(m, tmesh.rcm_permutation(m))


@pytest.mark.parametrize("stabilization", ["rv", "si", "gfem"])
@pytest.mark.parametrize("solvers", ["adaptive", "fixed"])
def test_kpp_ell_step_card_matches_cpu(cuda, irr, stabilization, solvers):
    cfg = kpp.KPPConfig(stabilization=stabilization, backend="ell",
                        dt=0.01, T=0.03,
                        **(FIXED if solvers == "fixed" else {}))
    before = dict(_build.launches)
    got = kpp.build(cfg, device=cuda, host_mesh=irr).solve().u
    assert dict(_build.launches) == before
    ref = kpp.build(cfg, device="cpu", host_mesh=irr).solve().u
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("backend", ["stencil", "ell"])
def test_burgers_si_smoothing_card_matches_cpu(cuda, backend):
    cfg = burgers.BurgersConfig(mesh_size=16, T=0.125, stabilization="si",
                                smooth_l=4.0, backend=backend)
    got = burgers.build(cfg, device=cuda).solve().u
    ref = burgers.build(cfg, device="cpu").solve().u
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=TOL)


def test_scatter_is_deterministic_on_the_card(cuda, irr):
    m = irr.device_arrays(torch.float64, cuda)
    rng = np.random.default_rng(0)
    vals = torch.tensor(rng.normal(size=(irr.n_cells, 3, 3)), device=cuda)
    a = assembly.scatter_matrix(m, vals)
    assert torch.equal(a, assembly.scatter_matrix(m, vals))
    ref = assembly.scatter_matrix(irr.device_arrays(torch.float64, "cpu"),
                                  vals.cpu())
    torch.testing.assert_close(a.cpu(), ref, rtol=0, atol=1e-13)
    r = torch.tensor(rng.normal(size=irr.n_nodes), device=cuda)
    beta = torch.ones(irr.n_cells, dtype=torch.float64, device=cuda)
    h = torch.as_tensor(irr.h_cell, device=cuda)
    eps = stab.rv_epsilon_cell(m, 0.5, 4.0, r, beta, h)
    mc = irr.device_arrays(torch.float64, "cpu")
    assert torch.equal(eps.cpu(), stab.rv_epsilon_cell(
        mc, 0.5, 4.0, r.cpu(), beta.cpu(), h.cpu()))
