"""Where an iteration of cg_solve's cluster instance spends its cycles.

    python3 scripts/torch_cg_phases.py [MESH ...]

Builds conservation_fem_tpu_torch/csrc/stencil.cu with -DCG_PHASES, which
turns on its CG_PHASE probes: thread 0 of the cluster's CTA 0 writes
clock64() at the phase boundaries of each iteration and, inside each
reduction, when it reaches and passes the cluster barrier, into the buffer
the cluster instance takes as ``work`` (it needs none). The library is
built with nvcc into the package's build directory (git-ignored) apart
from the kernels' own and launched through ctypes on the mass solve of the
Burgers reference config (f64, rtol 1e-12, b = M x_true, x_true ~ N(0, 1)
on the interior, seeded) at each MESH (default 50 100), with clusters of
4, 8 and 16 CTAs where they hold the state. Prints, per shape and
cluster, the median cycles of an iteration and of each phase over the
iterations after the first, the SM clock, and the card's name and power
limit. The result is checked against the plain solve. Needs a CUDA device
and nvcc.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = ["own p", "halo p", "block barrier", "matvec", "reduction 1",
          "x, r", "reduction 2", "scalars"]
CLUSTERS = (4, 8, 16)
ITERS = 60    # iterations probed at most (csrc/stencil.cu kPhaseIters)
REDS = 120    # reductions probed at most (kPhaseReds)


def build():
    from conservation_fem_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_DIR, "cg_phases")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libcg_phases.so")
    subprocess.run([_build._nvcc()] + _build.ARCH_FLAGS
                   + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-DCG_PHASES", "-o", lib,
                      os.path.join(_build.CSRC, "stencil.cu")], check=True)
    fn = ctypes.CDLL(lib).cft_cg_solve_f64
    fn.argtypes = _build._SIGNATURES["cft_cg_solve"]
    fn.restype = ctypes.c_int
    return fn


def main(argv):
    import torch

    from conservation_fem_tpu_torch.models import burgers
    from conservation_fem_tpu_torch.ops import stencil_kernels as sk

    if not torch.cuda.is_available():
        raise SystemExit("torch_cg_phases.py needs a CUDA device")
    fn = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for mesh in [int(a) for a in argv[1:]] or [50, 100]:
        p = burgers.build(burgers.BurgersConfig(mesh_size=mesh),
                          device="cuda")
        sd = p.sd
        rng = np.random.default_rng(mesh)
        x_true = torch.where(sd.bc2, 0.0, torch.tensor(
            rng.normal(size=sd.bc2.shape), dtype=torch.float64,
            device="cuda"))
        b = torch.where(sd.bc2, 0.0,
                        sk.stencil_matvec_plain(sd.M_coef, x_true))
        n1 = b.shape[0]
        ref = sk.cg_solve_plain(sd.M_coef, b, sd.bc2, sd.diagM2, rtol=1e-12)
        for C in CLUSTERS:
            try:   # a cluster of C CTAs holds the state
                sk.cg_plan(n1, n1, 8, sms, instance="cluster", ctas=C)
            except ValueError:
                continue
            sk.cluster_occupancy(0, torch.float64, n1, n1, C)
            trace = torch.zeros(4096, dtype=torch.int64, device="cuda")
            x = torch.empty_like(b)
            for _ in range(3):
                code = fn(sd.M_coef.data_ptr(), b.data_ptr(),
                          sd.bc2.data_ptr(), sd.diagM2.data_ptr(),
                          x.data_ptr(), trace.data_ptr(), None, n1, n1,
                          1e-12, 200, 1, C, 1,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"cg_solve probed: CUDA error {code}")
            torch.cuda.synchronize()
            err = float((x - ref).abs().max())
            if not err <= 1e-11:
                raise AssertionError(f"probed cg_solve differs by {err}")
            t = trace.cpu().numpy()
            iters = int(np.count_nonzero(t[:16 * ITERS:16]))
            rows = t[:16 * iters].reshape(iters, 16)[:, :9]
            phases = np.median(np.diff(rows, axis=1)[1:], axis=0)
            red = t[1024:1024 + 4 * REDS].reshape(REDS, 4)[1:2 * iters + 1]
            barrier = np.median(red[:, 1] - red[:, 0])
            print(f"burgers {n1}^2, cluster of {C} CTAs: {iters} iterations, "
                  f"|x - plain| {err:.2e}; cycles an iteration "
                  f"{np.median(np.diff(rows[:, 0])):.0f}; "
                  + ", ".join(f"{n} {m:.0f}" for n, m in zip(PHASES, phases))
                  + "; in a reduction, thread 0 from the cluster barrier's "
                  f"arrival to its pass {barrier:.0f}",
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
