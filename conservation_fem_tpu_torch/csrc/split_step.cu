// Hopper kernels for the split stabilised KPP-RV time step: one step in
// 1 + newton_iters launches.
//
// Replaces pallas_fused.fused_rv_step_split (conservation_fem_tpu/ops/
// pallas_fused.py:561):
//   * setup (setup_kernel, :585): residual projection, RV epsilon,
//     eps-stiffness planes Kc, N(u_n), K u_n, uk0 = where(bc, g, u) and
//     F0 = F(uk0) -> Kc (7, n1x, n1y), aux = (N(u_n), K u_n), uk, F;
//   * Newton (newton_kernel, :634), once per Newton iteration: the Jacobian
//     M + dt/2 (Kc + C(w)) at the linearisation point w (uk0 for a frozen
//     Jacobian, the current uk otherwise), the fixed BiCGStab or Chebyshev
//     inner solve of J dx = -F, uk' = uk + dx and F' = F(uk').
// Kc, aux, uk and F live in device memory between launches.
//
// What bounds them on the H100: the same chain of dependent grid-wide
// phases as the single step (fused_step.cu) — the setup is the single
// step's phases up to F(uk0), a Newton launch one of its Newton iterations
// with the residual of the new iterate — so at the split sizes (mesh
// 128 in f32: 1.05 MB per field, ~20 fields and 21 planes, all in the 50 MB
// L2) the cost is grid-sync latency, plus one launch per Newton iteration.
// Design: each kernel is one cooperative persistent launch built from the
// phases of fused_step.cuh (StepPhases), so its arithmetic and its
// deterministic two-level reductions are those of the single step; the TPU
// split exists because the single kernel's live set outgrew VMEM, which
// has no counterpart here, so the split is kept for the dispatch rule and
// its launch structure.

#include "fused_step.cuh"

namespace cft {

template <typename T> struct SplitSetupParams {
  const T *u, *uo, *uoo, *g, *Mc;
  T *Kc, *aux, *uk, *F;  // outputs
  T *work, *part;
  const double* consts;
  GridShape gs;
  int cg_iters, bdf2, rv, cheby;
};

template <typename T> struct SplitNewtonParams {
  const T *uk, *F, *u, *g, *Mc, *Kc, *aux, *w;
  T *uk_out, *F_out;
  T *work, *part;
  const double* consts;
  GridShape gs;
  int lin_iters, cheby;
};

template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
split_setup_kernel(SplitSetupParams<T> P) {
  __shared__ RedScratch<T> scratch;
  __shared__ StepConsts<T> C;
  if (threadIdx.x == 0) load_consts(C, P.consts);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  StepPhases<T, GridSweep<T>> S(grid, scratch, P.part, C, P.gs,
                                GridSweep<T>{P.gs}, P.Mc, P.g, P.cheby,
                                P.work);
  S.kc = P.Kc;
  S.nun = P.aux;
  S.kun = P.aux + S.N;
  const T mean_u = S.project(P.u, P.uo, P.uoo, P.bdf2, P.cg_iters);
  S.rv_eps(P.u, P.rv ? S.abs_term_of(P.u, mean_u) : T(0), P.rv);
  S.planes(P.u, P.uk, P.F);
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
split_newton_kernel(SplitNewtonParams<T> P) {
  __shared__ RedScratch<T> scratch;
  __shared__ StepConsts<T> C;
  if (threadIdx.x == 0) load_consts(C, P.consts);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  StepPhases<T, GridSweep<T>> S(grid, scratch, P.part, C, P.gs,
                                GridSweep<T>{P.gs}, P.Mc, P.g, P.cheby,
                                P.work);
  // read only here: the planes and frozen terms of the setup
  S.kc = const_cast<T*>(P.Kc);
  S.nun = const_cast<T*>(P.aux);
  S.kun = const_cast<T*>(P.aux) + S.N;
  const T rho = S.linearize(P.w, P.F);
  S.inner_solve(rho, P.lin_iters);
  S.update(P.u, P.uk, P.uk_out, P.F_out);
}

template <typename Params>
int launch_coop(void (*kernel)(Params), Params& P, int n_nodes,
                void* stream) {
  void* args[] = {&P};
  const int grid = coop_grid(kernel, n_nodes);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)kernel, grid, kBlock, args, 0, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <typename T>
int split_setup(const void* u, const void* uo, const void* uoo,
                const void* gvals, const void* Mc, void* Kc, void* aux,
                void* uk, void* F, void* work, void* part,
                const void* consts, int n1x, int n1y, int cg_iters, int bdf2,
                int rv, int cheby, void* stream) {
  SplitSetupParams<T> P{(const T*)u, (const T*)uo, (const T*)uoo,
                        (const T*)gvals, (const T*)Mc, (T*)Kc, (T*)aux,
                        (T*)uk, (T*)F, (T*)work, (T*)part,
                        (const double*)consts, GridShape::whole(n1x, n1y),
                        cg_iters, bdf2, rv, cheby};
  return launch_coop(split_setup_kernel<T>, P, n1x * n1y, stream);
}

template <typename T>
int split_newton(const void* uk, const void* F, const void* u,
                 const void* gvals, const void* Mc, const void* Kc,
                 const void* aux, const void* w, void* uk_out, void* F_out,
                 void* work, void* part, const void* consts, int n1x,
                 int n1y, int lin_iters, int cheby, void* stream) {
  SplitNewtonParams<T> P{(const T*)uk, (const T*)F, (const T*)u,
                         (const T*)gvals, (const T*)Mc, (const T*)Kc,
                         (const T*)aux, (const T*)w, (T*)uk_out, (T*)F_out,
                         (T*)work, (T*)part, (const double*)consts,
                         GridShape::whole(n1x, n1y), lin_iters, cheby};
  return launch_coop(split_newton_kernel<T>, P, n1x * n1y, stream);
}

}  // namespace cft

extern "C" {

int cft_split_setup_f32(const void* u, const void* uo, const void* uoo,
                        const void* g, const void* Mc, void* Kc, void* aux,
                        void* uk, void* F, void* work, void* part,
                        const void* consts, int n1x, int n1y, int cg_iters,
                        int bdf2, int rv, int cheby, void* stream) {
  return cft::split_setup<float>(u, uo, uoo, g, Mc, Kc, aux, uk, F, work,
                                 part, consts, n1x, n1y, cg_iters, bdf2, rv,
                                 cheby, stream);
}
int cft_split_setup_f64(const void* u, const void* uo, const void* uoo,
                        const void* g, const void* Mc, void* Kc, void* aux,
                        void* uk, void* F, void* work, void* part,
                        const void* consts, int n1x, int n1y, int cg_iters,
                        int bdf2, int rv, int cheby, void* stream) {
  return cft::split_setup<double>(u, uo, uoo, g, Mc, Kc, aux, uk, F, work,
                                  part, consts, n1x, n1y, cg_iters, bdf2, rv,
                                  cheby, stream);
}
int cft_split_newton_f32(const void* uk, const void* F, const void* u,
                         const void* g, const void* Mc, const void* Kc,
                         const void* aux, const void* w, void* uk_out,
                         void* F_out, void* work, void* part,
                         const void* consts, int n1x, int n1y, int lin_iters,
                         int cheby, void* stream) {
  return cft::split_newton<float>(uk, F, u, g, Mc, Kc, aux, w, uk_out, F_out,
                                  work, part, consts, n1x, n1y, lin_iters,
                                  cheby, stream);
}
int cft_split_newton_f64(const void* uk, const void* F, const void* u,
                         const void* g, const void* Mc, const void* Kc,
                         const void* aux, const void* w, void* uk_out,
                         void* F_out, void* work, void* part,
                         const void* consts, int n1x, int n1y, int lin_iters,
                         int cheby, void* stream) {
  return cft::split_newton<double>(uk, F, u, g, Mc, Kc, aux, w, uk_out,
                                   F_out, work, part, consts, n1x, n1y,
                                   lin_iters, cheby, stream);
}

}  // extern "C"
