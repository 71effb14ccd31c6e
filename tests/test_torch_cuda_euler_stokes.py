"""Compressible Euler, Stokes/IPCS and the lattice backend on the card
against the same code on the CPU. Marked ``cuda``: every test takes the
``cuda`` fixture, which skips when no CUDA device is present. On a
machine with a card: ``python -m pytest --noconftest
tests/test_torch_cuda_euler_stokes.py -m cuda``.

These paths launch no hand-written kernel (the JAX package runs them as
XLA): plain PyTorch stencil slices, gathers, segment sums and lattice
planes on CUDA tensors, held to the CPU in f64 within 1e-12 (Euler: Sod
nx 16 and riemann2d nx 12 on both backends; Stokes: ell and lattice at nx
4, lattice with multigrid at nx 8; Burgers P2 SI on the lattice
backend)."""

import pytest
import torch

from conservation_fem_tpu_torch.models import burgers
from conservation_fem_tpu_torch.models import euler
from conservation_fem_tpu_torch.models import stokes
from conservation_fem_tpu_torch.ops import _build

pytestmark = pytest.mark.cuda

TOL = 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("problem,nx", [("sod", 16), ("riemann2d", 12)])
@pytest.mark.parametrize("backend", ["auto", "ell"])
def test_euler_card_matches_cpu(cuda, problem, nx, backend):
    cfg = euler.EulerConfig(problem=problem, nx=nx, backend=backend)
    before = dict(_build.launches)
    got = euler.run(cfg, device=cuda)
    assert dict(_build.launches) == before
    ref = euler.run(cfg, device="cpu")
    assert (got.dt, got.num_steps) == (ref.dt, ref.num_steps)
    torch.testing.assert_close(got.U.cpu(), ref.U, rtol=0, atol=TOL)


@pytest.mark.parametrize("over", [
    dict(nx=4, num_steps=5, T=0.1),
    dict(nx=4, num_steps=5, T=0.1, backend="lattice"),
    dict(nx=8, num_steps=4, T=0.08, backend="lattice", multigrid=True),
    dict(nx=4, num_steps=5, T=0.1, backend="lattice", krylov_iters=6),
])
def test_stokes_card_matches_cpu(cuda, over):
    before = dict(_build.launches)
    got = stokes.solve(cfg=stokes.StokesConfig(**over), device=cuda)
    assert dict(_build.launches) == before
    ref = stokes.solve(cfg=stokes.StokesConfig(**over), device="cpu")
    torch.testing.assert_close(got.u.cpu(), ref.u, rtol=0, atol=TOL)
    torch.testing.assert_close(got.p.cpu(), ref.p, rtol=0, atol=TOL)
    assert abs(got.error_l2 - ref.error_l2) <= TOL


def test_burgers_lattice_backend_card_matches_cpu(cuda):
    cfg = burgers.BurgersConfig(mesh_size=6, degree=2, stabilization="si",
                                T=0.05, ell_matvec_backend="lattice")
    got = burgers.build(cfg, device=cuda).solve().u
    ref = burgers.build(cfg, device="cpu").solve().u
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-10)
