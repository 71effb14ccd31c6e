"""conservation_fem_tpu_torch — the PyTorch + CUDA port of conservation_fem_tpu.

The JAX package (``conservation_fem_tpu``) is the reference; this package
keeps its module paths and function names so each counterpart is found by
the same name. It imports torch and numpy only — never jax and never the
JAX package — and imports without nvcc, triton or a GPU: the hand-written
Hopper kernels under ``csrc/`` are compiled at first use
(``ops/_build.py``), and every kernel wrapper picks the kernel or its plain
PyTorch version by the device of the tensors it is given.

Precision policy: TF32 is off. The JAX package keeps ``einsum_exact``
because the TPU's default matmul rounds f32 operands to bf16; TF32 is the
H100's version of the same hazard, so it is disabled here and asserted.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def assert_no_tf32():
    """Raise if anything switched TF32 back on after import."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 is enabled: f32 contractions would keep ~3 decimal digits")


assert_no_tf32()


def get_device(device=None) -> torch.device:
    """Resolve a device argument. "cuda" without a card raises — nothing
    here falls back to the CPU."""
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    return dev
