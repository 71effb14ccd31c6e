"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, with the launch counters. Marked ``cuda``: every test takes the
``cuda`` fixture, which skips when no CUDA device is present (the card
is looked for when a test runs, never at import). On a machine with a
card: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.

f64 bound 1e-11: kernel and plain version sum in different orders (the
bound of the JAX package's own fused identity tests); f32 is checked
loosely (1e-3 relative) since reduction order is chaotic there."""

import numpy as np
import pytest
import torch

from conservation_fem_tpu_torch.models import kpp
from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops import fused_step as fs
from conservation_fem_tpu_torch.ops import stencil_kernels as sk

pytestmark = pytest.mark.cuda

F64_TOL = 1e-11
BENCH = dict(cg_iters=6, newton_iters=2, newton_linear_iters=4,
             modified_newton=True, newton_final_residual=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_matvec_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    coef = torch.tensor(rng.normal(size=(7, 65, 65)), dtype=dtype,
                        device=cuda)
    x = torch.tensor(rng.normal(size=(65, 65)), dtype=dtype, device=cuda)
    before = _build.launches["stencil_matvec"]
    y = sk.stencil_matvec(coef, x)
    assert _build.launches["stencil_matvec"] == before + 1
    tol = F64_TOL if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(y, sk.stencil_matvec_plain(coef, x), rtol=0,
                               atol=tol)


def test_kernel_wrappers_check_inputs(cuda):
    x = torch.zeros((9, 9), device=cuda)
    with pytest.raises(TypeError):
        sk.stencil_matvec(torch.zeros((7, 9, 9), device=cuda,
                                      dtype=torch.float64), x)
    with pytest.raises(ValueError):
        sk.stencil_matvec(torch.zeros((7, 9, 8), device=cuda), x)
    with pytest.raises(ValueError):
        sk.stencil_matvec(torch.zeros((7, 9, 9), device=cuda), x.t())
    with pytest.raises(ValueError):
        sk.stencil_matvec(torch.zeros((7, 9, 9)), x)


def _problem(cuda, mesh_size, dtype, **over):
    return kpp.build(kpp.KPPConfig(mesh_size=mesh_size, dtype=dtype,
                                   **{**BENCH, **over}), device=cuda)


def test_cg_solve_kernel_matches_plain(cuda):
    p = _problem(cuda, 16, "float64", T=0.0)
    sd = p.sd
    x_true = torch.tensor(np.random.default_rng(1).normal(size=sd.bc2.shape),
                          dtype=torch.float64, device=cuda)
    b = torch.where(sd.bc2, 0.0, sk.stencil_matvec_plain(
        sd.M_coef, torch.where(sd.bc2, 0.0, x_true)))
    args = (sd.M_coef, b, sd.bc2, sd.diagM2)
    before = _build.launches["cg_solve"]
    x = sk.cg_solve(*args, rtol=1e-10)
    assert _build.launches["cg_solve"] == before + 1
    torch.testing.assert_close(x, sk.cg_solve_plain(*args, rtol=1e-10),
                               rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("solver,frozen,stabilization,scheme", [
    ("bicgstab", True, "rv", "bdf2"), ("bicgstab", False, "rv", "bdf2"),
    ("cheby", True, "rv", "bdf2"), ("bicgstab", True, "gfem", "bdf2"),
    ("bicgstab", True, "rv", "bdf1")])
def test_fused_rv_step_kernel_matches_plain(cuda, solver, frozen,
                                            stabilization, scheme):
    p = _problem(cuda, 8, "float64", T=0.2)
    u = p.solve().u.reshape(p._shape2)
    g2 = torch.full_like(u, np.pi / 4)
    kw = dict(p.fused_step_kwargs(),
              cg_iters=6 if solver == "bicgstab" else 10,
              lin_iters=4 if solver == "bicgstab" else 16,
              freeze_jacobian=frozen, inner_solver=solver, n_substeps=3,
              stabilization=stabilization, residual_scheme=scheme)
    before = _build.launches["fused_rv_step"]
    out = fs.fused_rv_step(u, u, u, g2, p.sd.M_coef, **kw)
    assert _build.launches["fused_rv_step"] == before + 1
    ref = fs.fused_rv_step_plain(u, u, u, g2, p.sd.M_coef, **kw)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=F64_TOL)


def test_main_path_goes_through_the_fused_kernel(cuda):
    """One fused launch per step on the bench config, and the f32 result
    stays within 1e-3 of the plain composed path after 10 steps."""
    p = _problem(cuda, 16, "float32", T=0.1, use_kernels=True)
    before = _build.launches["fused_rv_step"]
    u = p.solve().u
    assert _build.launches["fused_rv_step"] == before + p.num_steps
    q = _problem(cuda, 16, "float32", T=0.1)
    v = q.solve().u
    assert float((u - v).norm() / v.norm()) < 1e-3


def test_kernels_repeat_bit_for_bit(cuda):
    """The cooperative kernels reduce in a fixed order: two launches on the
    same inputs give identical bits."""
    p = _problem(cuda, 16, "float32", T=0.1, use_kernels=True)
    a = p.solve().u
    b = p.solve().u
    assert torch.equal(a, b)
    sd = p.sd
    rhs = torch.where(sd.bc2, 0.0, torch.ones_like(sd.diagM2))
    x1 = sk.cg_solve(sd.M_coef, rhs, sd.bc2, sd.diagM2, rtol=1e-5)
    x2 = sk.cg_solve(sd.M_coef, rhs, sd.bc2, sd.diagM2, rtol=1e-5)
    assert torch.equal(x1, x2)
