"""solve()'s checkpoint, resume and streaming on the card: through the
single step kernel at KPP mesh 64 (f32 bench config) and through the ELL
kernels A-D on the blocked backend at irr140, the checkpointed and the
stopped-and-resumed solves are bit-equal to the plain solve and launch the
same kernels as often (phase 11 of chip_smoke.py at smaller sizes).
Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
no CUDA device is present. On a machine with a card:
``python -m pytest --noconftest tests/test_torch_cuda_utils.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from conservation_fem_tpu_torch.models import kpp
from conservation_fem_tpu_torch.ops import _build
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.utils.checkpoint import load_checkpoint
from conservation_fem_tpu_torch.utils.streaming import StreamingSink

pytestmark = pytest.mark.cuda

BENCH = dict(dtype="float32", dt=0.01, modified_newton=True, cg_iters=6,
             newton_iters=2, newton_linear_iters=4,
             newton_final_residual=False, inner_solver="bicgstab",
             use_kernels=True)
IRR_FIXED = dict(dtype="float32", dt=0.005, T=0.5, backend="ell",
                 ell_matvec_backend="blocked", modified_newton=True,
                 cg_iters=10, newton_iters=3, newton_linear_iters=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counted(fn):
    _build.launches.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.launches)


def _check_checkpoint_bits(p, every, tmp_path):
    p._force_lazy_operators()        # the mass: set-up, not a step
    n = p.num_steps
    u, counts = _counted(lambda: p.solve().u)
    assert counts and all(counts.values())
    path = str(tmp_path / "chunked.npz")
    uc, c_ck = _counted(
        lambda: p.solve(checkpoint_path=path, checkpoint_every=every).u)
    assert load_checkpoint(path).step == n
    assert torch.equal(uc, u) and c_ck == counts
    path2 = str(tmp_path / "stopped")

    def stop_and_resume():
        p.num_steps = n // 2
        try:
            p.solve(checkpoint_path=path2, checkpoint_every=every)
        finally:
            p.num_steps = n
        return p.solve(checkpoint_path=path2, checkpoint_every=every,
                       resume=True).u

    ur, c_res = _counted(stop_and_resume)
    assert torch.equal(ur, u) and c_res == counts
    return u


def test_checkpoint_bits_single_kernel_mesh64(cuda, tmp_path):
    p = kpp.build(kpp.KPPConfig(mesh_size=64, **BENCH), device=cuda)
    assert p._fused_mode() == "single" and p.num_steps == 100
    u = _check_checkpoint_bits(p, 25, tmp_path)
    # streamed frames: every step's time and the final u, bit for bit
    frames = []
    v = p.solve(stream=StreamingSink(lambda f, t: frames.append((f, t)))).u
    assert torch.equal(v, u) and [t for _, t in frames] == p.step_times()
    assert np.array_equal(frames[-1][0], u.cpu().numpy())


def test_checkpoint_bits_blocked_irr140(cuda, tmp_path):
    m = tmesh.irregular_mesh((-2, -2), (2, 2), nx=140, seed=1)
    m = tmesh.reorder_mesh(m, tmesh.rcm_permutation(m))
    p = kpp.build(kpp.KPPConfig(**IRR_FIXED), device=cuda, host_mesh=m)
    p.num_steps = 20
    _check_checkpoint_bits(p, 5, tmp_path)
    assert set(_build.launches) >= {"ell_spmv", "ell_assemble",
                                    "p1_newton_locals", "ell_rv_epsilon"}
