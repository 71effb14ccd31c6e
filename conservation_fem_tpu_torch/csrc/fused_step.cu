// Hopper kernel for the whole stabilised RV time step (KPP, Burgers).
//
// Replaces pallas_fused.fused_rv_step (conservation_fem_tpu/ops/
// pallas_fused.py:416, the step of _step_body :333 and _make_lib :97):
// n_substeps full steps, each one
//   1. BDF1/BDF2 residual projection: fixed-iteration Jacobi-CG (or
//      Chebyshev) on the pinned mass stencil;
//   2. RV epsilon: global max|u - mean u|, patch max/min of u, |RH| and
//      |f'(u)| (fills of -inf/+inf outside the grid), eps = min(Cvel h beta,
//      CRV h^2 |Rh_i / max(n_i, tiny)|);
//   3. eps-stiffness planes from cell-mean eps, N(u_n), K u_n;
//   4. CN Newton: F(v) = M(v-u) + dt/2 (N(v)+N(u)) + dt/2 (K v + K u),
//      v|bc = g, Jacobian M + dt/2 (K + C(w)) frozen at uk0 = where(bc,g,u)
//      or fresh per iteration, solved by fixed BiCGStab (safe_div guards)
//      or Chebyshev; F recomputed after every iteration that is followed
//      by another.
// The flux is compiled in (fused_step.cuh Kpp, Burgers): this source
// builds the KPP instance, fused_step_burgers.cu the Burgers one.
//
// What bounds it on the H100: at mesh 64 a step moves a few MB (the 7
// mass planes, 7 eps-stiffness and 7 Jacobian planes and ~20 fields, all in
// the 50 MB L2) and does four quadrature passes; neither is the limit. The
// step is a chain of 44 dependent passes (40 of them end in a global
// reduction: the CG and BiCGStab dots, the mean and max of u) with the
// bench iteration counts, so the cost is the latency of each pass: its
// barrier, its reduction, its dependent L2 round trips and, in four of
// them, the quadrature. Design: ONE cooperative persistent kernel per call
// (no launch and no host round trip between passes), over the resident
// bands of band_sweep.cuh: each CTA owns one contiguous band of nodes for
// the whole launch, with its operator planes and the quadrature of its
// triangles in shared memory; a reduction is a warp-shuffle tree in each
// block, partials in alternating buffers, one grid.sync(), then a shuffle
// tree over the partials, identical from run to run. Cells are indexed directly: the TPU kernel's roll +
// iota-mask layout is not carried over. Scalars (alpha, omega, rho) live
// in registers, identical in every thread; nothing crosses to the host.
// The phases themselves are in fused_step.cuh (StepPhases), shared with
// the split, tiled and block kernels; a phase that reads a combination at
// neighbours, such as the next BiCGStab direction, forms it where it reads
// it instead of storing it in a phase of its own. The band plan (nodes per
// CTA, what is staged, the quadrature chunk) comes from
// ops/fused_step.band_plan. fused_step_ablate.cu builds the instances that
// leave one design element out (BandDesign) into a library of their own,
// for the ablation.

#include "band_sweep.cuh"

namespace cft {

template <typename T> struct StepParams {
  const T* u_in;
  const T* uo_in;
  const T* uoo_in;
  const T* g;
  const T* Mc;
  T* ring;   // 4 fields: the solution history, rotated per substep
  T* work;   // N_FIELDS fields
  T* part;   // reduction partials
  const double* consts;
  GridShape gs;
  BandPlan plan;
  int n_sub, cg_iters, newton_iters, lin_iters;
  int bdf2, rv, freeze, cheby;
};

template <typename T, typename Fl, int D>
__global__ void __launch_bounds__(kBlock, 1)
fused_rv_step_kernel(StepParams<T> P) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  __shared__ RedScratch<T> scratch;
  __shared__ BandShared<T> sh;
  __shared__ StepConsts<T> C;
  if (threadIdx.x == 0) load_consts(C, P.consts);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  using Sweep = BandSweep<T, Fl, D>;
  StepPhases<T, Sweep, Fl> S(
      grid, scratch, P.part, C, P.gs,
      Sweep(C, P.gs, P.plan, reinterpret_cast<T*>(band_smem), P.part, sh,
            grid),
      P.Mc, P.g, P.cheby, P.work);
  const int N = S.N;

  for (int n = S.first; n < S.last; n += S.stride) {
    P.ring[n] = P.uoo_in[n];
    P.ring[N + n] = P.uo_in[n];
    P.ring[2 * N + n] = P.u_in[n];
  }
  grid.sync();

  for (int sub = 0; sub < P.n_sub; ++sub) {
    const T* u = P.ring + (size_t)((sub + 2) & 3) * N;
    const T* uo = P.ring + (size_t)((sub + 1) & 3) * N;
    const T* uoo = P.ring + (size_t)(sub & 3) * N;
    T* uk = P.ring + (size_t)((sub + 3) & 3) * N;
    const T mean_u = S.project(u, uo, uoo, P.bdf2, P.cg_iters);
    S.rv_eps(u, P.rv ? S.abs_term_of(u, mean_u) : T(0), P.rv);
    S.planes(u, uk, P.newton_iters > 0 ? S.F : nullptr);
    S.newton(u, uk, P.newton_iters, P.lin_iters, P.freeze);
  }
}

template <typename T, typename Fl, int D>
int fused_rv_step(const void* u, const void* uo, const void* uoo,
                  const void* gvals, const void* Mc, void* ring, void* work,
                  void* part, const void* consts, int n1x,
                  int n1y, int n_sub, int cg_iters, int newton_iters,
                  int lin_iters, int bdf2, int rv, int freeze, int cheby,
                  int ctas, int staged, int chunk, int cap, int smem,
                  void* stream) {
  StepParams<T> P{(const T*)u, (const T*)uo, (const T*)uoo, (const T*)gvals,
                  (const T*)Mc, (T*)ring, (T*)work, (T*)part,
                  (const double*)consts,
                  GridShape::whole(n1x, n1y),
                  BandPlan{ctas, staged, chunk, cap, smem}, n_sub, cg_iters,
                  newton_iters, lin_iters, bdf2, rv, freeze, cheby};
  return launch_bands(fused_rv_step_kernel<T, Fl, D>, P, P.plan, stream);
}

}  // namespace cft

#define CFT_STEP_ARGS                                                      \
  const void *u, const void *uo, const void *uoo, const void *g,           \
      const void *Mc, void *ring, void *work, void *part,                  \
      const void *consts, int n1x, int n1y, int n_sub, int cg_iters,       \
      int newton_iters, int lin_iters, int bdf2, int rv, int freeze,       \
      int cheby, int ctas, int staged, int chunk, int cap, int smem,       \
      void *stream
#define CFT_STEP_CALL                                                      \
  u, uo, uoo, g, Mc, ring, work, part, consts, n1x, n1y, n_sub,            \
      cg_iters, newton_iters, lin_iters, bdf2, rv, freeze, cheby, ctas,    \
      staged, chunk, cap, smem, stream

extern "C" {

#ifndef CFT_BAND_ABLATE
int CFT_ENTRY(fused_rv_step, f32)(CFT_STEP_ARGS) {
  return cft::fused_rv_step<float, cft::CFT_FLUX, cft::kBandAll>(
      CFT_STEP_CALL);
}
int CFT_ENTRY(fused_rv_step, f64)(CFT_STEP_ARGS) {
  return cft::fused_rv_step<double, cft::CFT_FLUX, cft::kBandAll>(
      CFT_STEP_CALL);
}
#else
// The KPP f32 instances without one design element each, and without all
// three (design: the BandDesign bits kept).
int cft_fused_rv_step_ablate_f32(int design, CFT_STEP_ARGS) {
  using cft::Kpp;
  constexpr int kAll = cft::kBandAll;
  switch (design) {
    case kAll & ~cft::kStagePlanes:
      return cft::fused_rv_step<float, Kpp, kAll & ~cft::kStagePlanes>(
          CFT_STEP_CALL);
    case kAll & ~cft::kShflReduce:
      return cft::fused_rv_step<float, Kpp, kAll & ~cft::kShflReduce>(
          CFT_STEP_CALL);
    case kAll & ~cft::kTriQuad:
      return cft::fused_rv_step<float, Kpp, kAll & ~cft::kTriQuad>(
          CFT_STEP_CALL);
    case 0:
      return cft::fused_rv_step<float, Kpp, 0>(CFT_STEP_CALL);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif

}  // extern "C"
