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
// What bounds it on the H100: at mesh 64 a step moves a few MB — the 7
// mass planes, 7 eps-stiffness and 7 Jacobian planes and ~20 fields, all of
// which stay in the 50 MB L2 — and does four quadrature passes of 36
// sincos per node. Neither is the limit: the step is a chain of 44
// dependent phases (40 of them end in a global reduction: the CG and
// BiCGStab dots, the mean and max of u) with the bench iteration counts,
// so the cost is grid-wide synchronisation latency. Design: ONE cooperative
// persistent kernel per call (every block resident, grid-stride loops over
// nodes, grid.sync() between phases) so no launch and no host round trip
// sits between phases; dots are deterministic two-level reductions
// (stencil.cuh GridReducer), identical from run to run. Cells are indexed
// directly — the TPU kernel's roll + iota-mask layout is not carried over:
// each node gathers the contributions of its (up to) six triangles, so no
// scatter and no atomics are needed, at the price of recomputing a cell's
// quadrature at each of its three corners. Scalars (alpha, omega, rho) live
// in registers, identical in every thread; nothing crosses to the host.
// The phases themselves are in fused_step.cuh (StepPhases over a
// grid-stride sweep), shared with the split and tiled kernels; a phase
// that reads a combination at neighbours, such as the next BiCGStab
// direction, forms it where it reads it instead of storing it in a phase
// of its own.

#include "fused_step.cuh"

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
  int n_sub, cg_iters, newton_iters, lin_iters;
  int bdf2, rv, freeze, cheby;
};

template <typename T, typename Fl>
__global__ void __launch_bounds__(kBlock, 1)
fused_rv_step_kernel(StepParams<T> P) {
  __shared__ RedScratch<T> scratch;
  __shared__ StepConsts<T> C;
  if (threadIdx.x == 0) load_consts(C, P.consts);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  StepPhases<T, GridSweep<T>, Fl> S(grid, scratch, P.part, C, P.gs,
                                    GridSweep<T>{P.gs}, P.Mc, P.g, P.cheby,
                                    P.work);
  const int N = S.N;

  for (int n = S.first; n < N; n += S.stride) {
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

template <typename T, typename Fl>
int fused_rv_step(const void* u, const void* uo, const void* uoo,
                  const void* gvals, const void* Mc, void* ring, void* work,
                  void* part, const void* consts, int n1x, int n1y,
                  int n_sub, int cg_iters, int newton_iters, int lin_iters,
                  int bdf2, int rv, int freeze, int cheby, void* stream) {
  StepParams<T> P{(const T*)u, (const T*)uo, (const T*)uoo, (const T*)gvals,
                  (const T*)Mc, (T*)ring, (T*)work, (T*)part,
                  (const double*)consts, GridShape::whole(n1x, n1y), n_sub,
                  cg_iters, newton_iters, lin_iters, bdf2, rv, freeze,
                  cheby};
  void* args[] = {&P};
  const int grid = coop_grid(fused_rv_step_kernel<T, Fl>, n1x * n1y);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)fused_rv_step_kernel<T, Fl>, grid, kBlock, args, 0,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace cft

extern "C" {

int CFT_ENTRY(fused_rv_step, f32)(
    const void* u, const void* uo, const void* uoo, const void* g,
    const void* Mc, void* ring, void* work, void* part, const void* consts,
    int n1x, int n1y, int n_sub, int cg_iters, int newton_iters,
    int lin_iters, int bdf2, int rv, int freeze, int cheby, void* stream) {
  return cft::fused_rv_step<float, cft::CFT_FLUX>(
      u, uo, uoo, g, Mc, ring, work, part, consts, n1x, n1y, n_sub,
      cg_iters, newton_iters, lin_iters, bdf2, rv, freeze, cheby, stream);
}
int CFT_ENTRY(fused_rv_step, f64)(
    const void* u, const void* uo, const void* uoo, const void* g,
    const void* Mc, void* ring, void* work, void* part, const void* consts,
    int n1x, int n1y, int n_sub, int cg_iters, int newton_iters,
    int lin_iters, int bdf2, int rv, int freeze, int cheby, void* stream) {
  return cft::fused_rv_step<double, cft::CFT_FLUX>(
      u, uo, uoo, g, Mc, ring, work, part, consts, n1x, n1y, n_sub,
      cg_iters, newton_iters, lin_iters, bdf2, rv, freeze, cheby, stream);
}

}  // extern "C"
