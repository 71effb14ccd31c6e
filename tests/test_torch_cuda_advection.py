"""Linear advection, the Pk layer and Pk Burgers on the card against the
same code on the CPU. Marked ``cuda``: every test takes the ``cuda``
fixture, which skips when no CUDA device is present. On a machine with a
card: ``python -m pytest --noconftest tests/test_torch_cuda_advection.py
-m cuda``.

These paths launch no hand-written kernel (the JAX package runs them as
XLA gathers and segment sums): plain PyTorch gathers, einsums and
torch.segment_reduce on CUDA tensors, held to the CPU in f64 within 1e-10
after a few steps (the reductions sum in other orders there), and the Pk
assembly to its own bits on a second call (no atomics)."""

import numpy as np
import pytest
import torch

from conservation_fem_tpu_torch.models import advection_ho as ho
from conservation_fem_tpu_torch.models import burgers
from conservation_fem_tpu_torch.models import linear_advection as la
from conservation_fem_tpu_torch.models import kpp
from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops import assembly_pk as apk
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import spaces as tsp

pytestmark = pytest.mark.cuda

TOL = 1e-10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("stabilization", ["gfem", "rv_node", "rv_cell",
                                           "rv_node_simple", "si", "rk4"])
def test_linear_advection_card_matches_cpu(cuda, stabilization):
    cfg = la.AdvectionConfig(mesh_size=8, T=0.1, stabilization=stabilization)
    before = dict(_build.launches)
    got = la.run(cfg, device=cuda)
    assert dict(_build.launches) == before
    ref = la.run(cfg, device="cpu")
    assert (got.dt, got.num_steps) == (ref.dt, ref.num_steps)
    torch.testing.assert_close(got.u.cpu(), ref.u, rtol=0, atol=TOL)


@pytest.mark.parametrize("over", [
    dict(degree=2, stabilization="rv"),
    dict(degree=3, stabilization="rv_simple", curved_boundary=True),
    dict(degree=2, stabilization="si", cg_iters=8, krylov_iters=12,
         inner_solver="cheby"),
])
def test_advection_ho_card_matches_cpu(cuda, over):
    cfg = ho.HOAdvectionConfig(mesh_size=4, T=0.1, **over)
    _, got, _ = ho.run(cfg, device=cuda)
    _, ref, _ = ho.run(cfg, device="cpu")
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("degree,stabilization", [(2, "si"), (2, "rv"),
                                                  (3, "si")])
def test_pk_burgers_card_matches_cpu(cuda, degree, stabilization):
    cfg = burgers.BurgersConfig(mesh_size=8, degree=degree, T=0.05,
                                stabilization=stabilization)
    before = dict(_build.launches)
    got = burgers.build(cfg, device=cuda).solve().u
    assert dict(_build.launches) == before
    ref = burgers.build(cfg, device="cpu").solve().u
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=TOL)


def test_pk_assembly_is_deterministic_on_the_card(cuda):
    space = tsp.build_space(tmesh.disk_mesh(1 / 8), 3,
                            boundary_projector=ho.unit_disk_projector)
    sp = space.device_arrays(torch.float64, cuda)
    spc = space.device_arrays(torch.float64, "cpu")
    rng = np.random.default_rng(0)
    u = torch.tensor(rng.uniform(-1, 2, space.ndof), device=cuda)
    eps = torch.tensor(rng.uniform(0, 0.1, space.ndof), device=cuda)
    for fn, args in ((apk.assemble_flux_jacobian, (u, kpp.FLUX)),
                     (apk.convection_rhs_flux, (u, kpp.FLUX)),
                     (apk.assemble_eps_stiffness, (eps,)),
                     (apk.assemble_mass, ())):
        a = fn(sp, *args)
        assert torch.equal(a, fn(sp, *args)), fn.__name__
        ref = fn(spc, *(x.cpu() if isinstance(x, torch.Tensor) else x
                        for x in args))
        scale = max(1.0, float(ref.abs().max()))
        assert float((a.cpu() - ref).abs().max()) <= 1e-13 * scale
