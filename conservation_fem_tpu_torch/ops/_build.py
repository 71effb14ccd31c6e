"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` source (the ablation units apart) compiles, with nvcc
and a plain C interface,
to an object file — one nvcc process per source, all started together —
and the objects link into one shared library that is loaded with ctypes
(no PyTorch headers, so a build takes seconds, not minutes). The
ablation instances of the band kernels (``csrc/*_ablate.cu``) link into
a second library, ``libcft_ablate.so``, built only when ``ablate_lib``
is first called:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o _build/obj/<name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libcft_kernels.so _build/obj/*.o

A build runs at first use into ``_build/`` beside this package (listed
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
as ``tiled_rv_step_block``, apart from its whole-grid ones, and those of
its bf16-plane instance as ``tiled_rv_step_bf16`` and
``tiled_rv_step_block_bf16``; that instance is KPP f32 alone,
``F32_ENTRIES``), and a Burgers instance's launches under
``<name>/burgers`` (``launch_key``).
"""

from __future__ import annotations

import collections
import contextlib
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
# the libraries built from csrc/ and the suffix of each one's units: the
# kernels, and the ablation instances of the band kernels
LIBS = {"kernels": ("libcft_kernels.so", None),
        "ablate": ("libcft_ablate.so", "_ablate.cu")}
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
    # coef, b, bc, diag, x, work, part (work and part null in the cluster
    # instance); n1x, n1y, rtol, maxiter; the plan: cluster, ctas,
    # resident; stream
    "cft_cg_solve": [_P] * 7 + [_I, _I, _D, _I] + [_I] * 3 + [_P],
    # (n1x, n1y, ctas, int out): clusters the card can place
    "cft_cg_cluster_occupancy": [_I, _I, _I, _P],
    "cft_fused_rv_step": [_P] * 9 + [_I] * 15 + [_P],
    "cft_split_setup": [_P] * 12 + [_I] * 8 + [_P],
    "cft_split_newton": [_P] * 13 + [_I] * 8 + [_P],
    "cft_tiled_rv_step": [_P] * 10 + [_I] * 14 + [_P],
    # (dynamic shared memory, int[5] out) of each tile-pipeline kernel
    "cft_tiled_occupancy": [_I, _P],
    "cft_split_setup_occupancy": [_I, _P],
    "cft_split_newton_occupancy": [_I, _P],
    "cft_fused_rv_block_step": [_P] * 9 + [_I] * 15 + [_P],
    # the ELL kernels (csrc/ell.cu), each ending in the device's index and
    # the stream: A, cols, x, bc (null: unconstrained), y, n, K, the tile
    # plan (rows, stride, shared memory), int16 columns; vals, perm, off,
    # base, tiles, out, n_out, group width, tile count, the plan (groups a
    # tile, perm a stage, shared memory), matrix mode; cells,
    # area, grads, u, eps (null: none), dt/2, rhs, jac (null: rhs only), M,
    # shared memory; cols, u_n, Rh, u_h, h, abs_term, valid (null: all),
    # Cvel, CRV, tiny, eps, n, K, the tile plan, int16 columns
    "cft_ell_spmv": [_P] * 5 + [_I] * 7 + [_P],
    "cft_ell_assemble": [_P] * 6 + [_I] * 8 + [_P],
    "cft_p1_newton_locals": [_P] * 5 + [_D, _P, _P, _I, _I, _I, _P],
    "cft_ell_rv_epsilon": [_P] * 7 + [_D] * 3 + [_P] + [_I] * 7 + [_P],
}
FLUX_ENTRIES = frozenset(_SIGNATURES) - {"cft_stencil_matvec",
                                         "cft_cg_solve",
                                         "cft_cg_cluster_occupancy",
                                         "cft_ell_spmv", "cft_ell_assemble"}
# entry points built for KPP in f32 alone: the tiled kernel's bf16-plane
# instance (csrc/tiled_step_bf16.cu), whose arguments are the tiled
# kernel's with the bf16 mass planes after Mc and the bf16 Jacobian
# region after the work fields
F32_ENTRIES = {
    "cft_tiled_rv_step_bf16": [_P] * 12 + [_I] * 14 + [_P],
    "cft_tiled_occupancy_bf16": [_I, _P],
}
# the entry points of the ablation library, KPP f32 alone: (design, the
# arguments of the kernel's own entry point)
_ABLATE_SIGNATURES = {
    "cft_fused_rv_step_ablate_f32":
        [_I] + _SIGNATURES["cft_fused_rv_step"],
    "cft_fused_rv_block_step_ablate_f32":
        [_I] + _SIGNATURES["cft_fused_rv_block_step"],
}
# values reduced together at most (csrc/stencil.cuh kMaxRed) and the CTAs
# of a reduction over a grid (one partial per thread of a block)
MAX_RED = 4
MAX_GRID_CTAS = 256
# reduction partials of the step kernels: 2 buffers x kMaxRed x kMaxGrid
# (csrc/stencil.cuh)
PART_SIZE = 2 * MAX_RED * 2048

_lock = threading.Lock()
_lib = None
_ablate_lib = None
# compiler output of the kernels library's build (-Xptxas -v when verbose)
build_log = ""


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _units(which: str):
    """The translation units of library ``which`` (a key of LIBS)."""
    suffix, ablate = LIBS[which][1], LIBS["ablate"][1]
    return [path for path in _sources() if path.endswith(".cu")
            and (path.endswith(suffix) if suffix
                 else not path.endswith(ablate))]


def source_hash() -> str:
    """SHA-256 of every source in csrc/ (an ablation unit includes a
    kernel's source, so each library depends on all of them)."""
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


def build(verbose: bool = False, force: bool = False,
          which: str = "kernels") -> str:
    """Compile the units of library ``which`` (a key of LIBS) into
    BUILD_DIR unless a library built from the same sources is there (or
    ``force``); returns its path. The sources compile in parallel, one
    nvcc each; for the kernels library ``build_log`` keeps the compiler
    output, also of the build that made a library found there (each
    library's log is BUILD_DIR/<library>.log)."""
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_name = LIBS[which][0]
    lib_path = os.path.join(BUILD_DIR, lib_name)
    stamp = lib_path + ".sha256"
    log_path = lib_path[:-len(".so")] + ".log"
    digest = source_hash()
    if not force and os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == digest:
                if which == "kernels" and os.path.exists(log_path):
                    with open(log_path) as lf:
                        build_log = lf.read()
                return lib_path
    nvcc = _nvcc()
    obj_dir = os.path.join(BUILD_DIR, f"obj.{which}.{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    procs = []
    for src in _units(which):
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
    log = "".join(outputs)
    if which == "kernels":
        build_log = log
    if verbose or failed:
        print(log, flush=True)
    if failed:
        raise RuntimeError(f"nvcc failed: the {which} library did not build")
    os.replace(tmp, lib_path)
    with open(log_path, "w") as fh:
        fh.write(log)
    with open(stamp, "w") as fh:
        fh.write(digest)
    return lib_path


def lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            # an empty kernel of one warp on a stream: a launch floor
            handle.cft_empty_launch.argtypes = [_P]
            handle.cft_empty_launch.restype = ctypes.c_int
            for base, argtypes in _SIGNATURES.items():
                infixes = FLUXES.values() if base in FLUX_ENTRIES else [""]
                for infix in infixes:
                    for dt in ("_f32", "_f64"):
                        fn = getattr(handle, base + infix + dt)
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
            for base, argtypes in F32_ENTRIES.items():
                fn = getattr(handle, base + "_f32")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def ablate_lib():
    """The loaded library of the band kernels' ablation instances (built
    at first use, apart from the kernels library)."""
    global _ablate_lib
    with _lock:
        if _ablate_lib is None:
            handle = ctypes.CDLL(build(which="ablate"))
            for name, argtypes in _ABLATE_SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _ablate_lib = handle
        return _ablate_lib


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


# the raw cudaStream_t of a device's current stream, without the Stream
# object torch.cuda.current_stream builds (several µs a call)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_NO_SWITCH = contextlib.nullcontext()


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of t's CUDA device, as the address a C entry
    point takes."""
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t: torch.Tensor):
    """A context in which t's CUDA device is the current one: a null
    context where it already is (torch.cuda.device costs several µs a
    call)."""
    index = t.get_device()
    if index == torch.cuda.current_device():
        return _NO_SWITCH
    return torch.cuda.device(index)


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
