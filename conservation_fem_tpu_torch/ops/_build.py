"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` source compiles, with nvcc and a plain C interface,
to an object file — one nvcc process per source, all started together —
and the objects link into one shared library that is loaded with ctypes
(no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o _build/obj/<name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libcft_kernels.so _build/obj/*.o

The build runs at first use into ``_build/`` beside this package (listed
in .gitignore) and again whenever the SHA-256 of the sources changes.
Nothing here runs at import time, so the package imports on a machine
without nvcc or a GPU.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code. The step
kernels have one instance per compiled flux (``FLUXES``): the KPP entry
points are ``cft_<name>_f32`` / ``_f64``, the Burgers ones
``cft_<name>_burgers_f32`` / ``_f64``, built from ``csrc/*_burgers.cu``.
``launches`` counts kernel launches by wrapper name — the wrappers add one
exactly where they launch (the tiled kernel's block-mode launches count
as ``tiled_rv_step_block``, apart from its whole-grid ones), and a
Burgers instance's launches under ``<name>/burgers`` (``launch_key``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libcft_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

launches: collections.Counter = collections.Counter()
# the fluxes the step kernels compile in (csrc/fused_step.cuh Kpp, Burgers)
# and the infix of each one's C entry points
FLUXES = {"kpp": "", "burgers": "_burgers"}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# (name, argtypes) of every C entry point; the f32 and f64 instantiations
# share a signature, and so do the flux instances of a step kernel
# (FLUX_ENTRIES)
_SIGNATURES = {
    "cft_stencil_matvec": [_P, _P, _P, _I, _I, _P],
    "cft_cg_solve": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _D, _I, _P],
    "cft_fused_rv_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "cft_split_setup": [_P] * 12 + [_I] * 8 + [_P],
    "cft_split_newton": [_P] * 13 + [_I] * 8 + [_P],
    "cft_tiled_rv_step": [_P] * 10 + [_I] * 14 + [_P],
    # (dynamic shared memory, int[5] out) of each tile-pipeline kernel
    "cft_tiled_occupancy": [_I, _P],
    "cft_split_setup_occupancy": [_I, _P],
    "cft_split_newton_occupancy": [_I, _P],
    "cft_fused_rv_block_step": [_P] * 9 + [_I] * 10 + [_P],
}
FLUX_ENTRIES = frozenset(_SIGNATURES) - {"cft_stencil_matvec",
                                         "cft_cg_solve"}
# reduction partials of the cooperative kernels: 2 buffers x kMaxRed x
# kMaxGrid (csrc/stencil.cuh)
PART_SIZE = 2 * 4 * 2048

_lock = threading.Lock()
_lib = None
build_log = ""   # compiler output of the last build (-Xptxas -v when verbose)


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into BUILD_DIR/LIB_NAME unless a library built
    from the same sources is there; returns its path. The sources compile
    in parallel, one nvcc each; ``build_log`` keeps the compiler output."""
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = os.path.join(BUILD_DIR, LIB_NAME + ".sha256")
    digest = source_hash()
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == digest:
                return lib_path
    nvcc = _nvcc()
    obj_dir = os.path.join(BUILD_DIR, f"obj.{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    procs = []
    for src in [path for path in _sources() if path.endswith(".cu")]:
        obj = os.path.join(obj_dir, os.path.basename(src)[:-3] + ".o")
        cmd = ([nvcc] + ARCH_FLAGS
               + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c"]
               + (["-Xptxas", "-v"] if verbose else []) + ["-o", obj, src])
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    outputs, failed = [], False
    for _, proc in procs:
        out, _ = proc.communicate()
        outputs.append(out)
        failed |= proc.returncode != 0
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    if not failed:
        res = subprocess.run([nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp]
                             + [obj for obj, _ in procs],
                             capture_output=True, text=True)
        outputs.append(res.stdout + res.stderr)
        failed = res.returncode != 0
    shutil.rmtree(obj_dir, ignore_errors=True)
    build_log = "".join(outputs)
    if verbose or failed:
        print(build_log, flush=True)
    if failed:
        raise RuntimeError("nvcc failed: the CUDA kernels did not build")
    os.replace(tmp, lib_path)
    with open(stamp, "w") as fh:
        fh.write(digest)
    return lib_path


def lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for base, argtypes in _SIGNATURES.items():
                infixes = FLUXES.values() if base in FLUX_ENTRIES else [""]
                for infix in infixes:
                    for dt in ("_f32", "_f64"):
                        fn = getattr(handle, base + infix + dt)
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def entry(base: str, dtype, flux: str = "kpp"):
    """The C entry point ``base`` instantiated for ``dtype`` and, for a step
    kernel, for the flux named ``flux`` (a key of FLUXES)."""
    infix = FLUXES[flux]
    if dtype == torch.float32:
        return getattr(lib(), base + infix + "_f32")
    if dtype == torch.float64:
        return getattr(lib(), base + infix + "_f64")
    raise TypeError(f"{base}: kernels take float32 or float64, not {dtype}")


def launch_key(name: str, flux: str = "kpp") -> str:
    """The key of ``launches`` under which wrapper ``name`` counts a launch
    of its kernel's instance for ``flux``: the name for KPP, the name and
    the flux (``fused_rv_step/burgers``) for another."""
    return name if flux == "kpp" else f"{name}/{flux}"


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def on_cpu(name: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version), False when every one lies on a CUDA device (it launches
    the kernel); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{name}: tensors on {sorted(kinds)}; expected all on "
                     "the CPU or all on one CUDA device")


def check_cuda_args(name: str, *tensors, shapes=None):
    """Device, dtype and contiguity checks for a kernel launch: every
    tensor on one CUDA device, contiguous, of one floating dtype (bool
    masks excepted)."""
    dev = tensors[0].device
    fdtype = None
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
        if t.dtype == torch.bool:
            continue
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: dtype {t.dtype} not supported")
        if fdtype is None:
            fdtype = t.dtype
        elif t.dtype != fdtype:
            raise TypeError(f"{name}: mixed dtypes {fdtype} and {t.dtype}")
    if shapes is not None:
        for t, s in zip(tensors, shapes):
            if tuple(t.shape) != tuple(s):
                raise ValueError(
                    f"{name}: shape {tuple(t.shape)} != expected {tuple(s)}")
    return fdtype
