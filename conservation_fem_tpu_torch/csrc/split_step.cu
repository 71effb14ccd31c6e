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
// What bounds them on the H100: the passes of the single step (the setup
// is its passes up to F(uk0), a Newton launch one of its Newton
// iterations), each a sweep over the grid with a grid.sync() and most
// with a grid reduction after it. At the split sizes (mesh 128 in f32:
// 513 x 513 nodes, 1.05 MB per field, ~45 MB of fields and planes, about
// the 50 MB L2) a sweep that reads its fields with plain loads waits on
// every load: at ~180 registers per thread one 256-thread block fits an
// SM, 8 warps, too few to hide the latency (two blocks per SM would need
// 128 registers, and the node functions spill there).
//
// Design: both kernels run StepPhases over the tile pipeline of the tiled
// kernel (TileSweep, tile_sweep.cuh): every pass copies the raw values it
// declares into two shared-memory stages with cp.async, the next tile in
// flight while this one computes, so latency is hidden by the bytes in
// flight, not by warps. One cooperative persistent launch each, every
// block that can be resident with two stages of the tile plan
// (ops/tiled_step.card_plan, one plan for all the launches of a step).
// A Newton launch runs no pass that the single step does not run: with
// relinearize 0 it takes the Jacobian planes jc and their Jacobi
// preconditioner dj that a launch at the same w left in the same scratch
// and re-initialises the inner solver from F alone (the single step's
// reinit for a frozen Jacobian); with residual 0 it writes uk + dx
// pointwise and no F' (the single step's last iteration). So the split
// step runs the single step's passes in its order, and on the same tile
// plan and number of blocks gives the tiled kernel's bits (the same
// tiles, the same deterministic reductions).

#include "tile_sweep.cuh"

namespace cft {

template <typename T> struct SplitSetupParams {
  const T *u, *uo, *uoo, *g, *Mc;
  T *Kc, *aux, *uk, *F;  // outputs
  T *work, *part;
  const double* consts;
  GridShape gs;
  int tile_rows, tile_cols;
  int cg_iters, bdf2, rv, cheby;
};

template <typename T> struct SplitNewtonParams {
  const T *uk, *F, *u, *g, *Mc, *Kc, *aux, *w;
  T *uk_out, *F_out;  // F_out: unused (may be null) with residual 0
  T *work, *part;
  const double* consts;
  GridShape gs;
  int tile_rows, tile_cols;
  int lin_iters, cheby, relinearize, residual;
};

template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
split_setup_kernel(SplitSetupParams<T> P) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  __shared__ RedScratch<T> scratch;
  __shared__ StepConsts<T> C;
  if (threadIdx.x == 0) load_consts(C, P.consts);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const TileSweep<T> sweep(TileGrid(P.gs, P.tile_rows, P.tile_cols),
                           reinterpret_cast<T*>(stage_raw));
  StepPhases<T, TileSweep<T>> S(grid, scratch, P.part, C, P.gs, sweep, P.Mc,
                                P.g, P.cheby, P.work);
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
  extern __shared__ __align__(16) unsigned char stage_raw[];
  __shared__ RedScratch<T> scratch;
  __shared__ StepConsts<T> C;
  if (threadIdx.x == 0) load_consts(C, P.consts);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const TileSweep<T> sweep(TileGrid(P.gs, P.tile_rows, P.tile_cols),
                           reinterpret_cast<T*>(stage_raw));
  StepPhases<T, TileSweep<T>> S(grid, scratch, P.part, C, P.gs, sweep, P.Mc,
                                P.g, P.cheby, P.work);
  // read only here: the planes and frozen terms of the setup
  S.kc = const_cast<T*>(P.Kc);
  S.nun = const_cast<T*>(P.aux);
  S.kun = const_cast<T*>(P.aux) + S.N;
  // the flags are the same in every block, so every block takes the same
  // branch and meets the same grid barriers
  const T rho = P.relinearize ? S.linearize(P.w, P.F) : S.reinit(P.F);
  S.inner_solve(rho, P.lin_iters);
  if (P.residual) {
    S.update(P.u, P.uk, P.uk_out, P.F_out);
  } else {
    S.advance(P.uk, P.uk_out);
  }
}

template <typename T>
int split_setup(const void* u, const void* uo, const void* uoo,
                const void* gvals, const void* Mc, void* Kc, void* aux,
                void* uk, void* F, void* work, void* part,
                const void* consts, int n1x, int n1y, int tile_rows,
                int tile_cols, int cg_iters, int bdf2, int rv, int cheby,
                void* stream) {
  const GridShape gs = GridShape::whole(n1x, n1y);
  SplitSetupParams<T> P{(const T*)u, (const T*)uo, (const T*)uoo,
                        (const T*)gvals, (const T*)Mc, (T*)Kc, (T*)aux,
                        (T*)uk, (T*)F, (T*)work, (T*)part,
                        (const double*)consts, gs, tile_rows, tile_cols,
                        cg_iters, bdf2, rv, cheby};
  return launch_tiles<T>(split_setup_kernel<T>, P, gs, tile_rows, tile_cols,
                         stream);
}

template <typename T>
int split_newton(const void* uk, const void* F, const void* u,
                 const void* gvals, const void* Mc, const void* Kc,
                 const void* aux, const void* w, void* uk_out, void* F_out,
                 void* work, void* part, const void* consts, int n1x,
                 int n1y, int tile_rows, int tile_cols, int lin_iters,
                 int cheby, int relinearize, int residual, void* stream) {
  if (residual && !F_out) return (int)cudaErrorInvalidValue;
  const GridShape gs = GridShape::whole(n1x, n1y);
  SplitNewtonParams<T> P{(const T*)uk, (const T*)F, (const T*)u,
                         (const T*)gvals, (const T*)Mc, (const T*)Kc,
                         (const T*)aux, (const T*)w, (T*)uk_out, (T*)F_out,
                         (T*)work, (T*)part, (const double*)consts, gs,
                         tile_rows, tile_cols, lin_iters, cheby,
                         relinearize, residual};
  return launch_tiles<T>(split_newton_kernel<T>, P, gs, tile_rows, tile_cols,
                         stream);
}

}  // namespace cft

extern "C" {

int cft_split_setup_f32(const void* u, const void* uo, const void* uoo,
                        const void* g, const void* Mc, void* Kc, void* aux,
                        void* uk, void* F, void* work, void* part,
                        const void* consts, int n1x, int n1y, int tile_rows,
                        int tile_cols, int cg_iters, int bdf2, int rv,
                        int cheby, void* stream) {
  return cft::split_setup<float>(u, uo, uoo, g, Mc, Kc, aux, uk, F, work,
                                 part, consts, n1x, n1y, tile_rows,
                                 tile_cols, cg_iters, bdf2, rv, cheby,
                                 stream);
}
int cft_split_setup_f64(const void* u, const void* uo, const void* uoo,
                        const void* g, const void* Mc, void* Kc, void* aux,
                        void* uk, void* F, void* work, void* part,
                        const void* consts, int n1x, int n1y, int tile_rows,
                        int tile_cols, int cg_iters, int bdf2, int rv,
                        int cheby, void* stream) {
  return cft::split_setup<double>(u, uo, uoo, g, Mc, Kc, aux, uk, F, work,
                                  part, consts, n1x, n1y, tile_rows,
                                  tile_cols, cg_iters, bdf2, rv, cheby,
                                  stream);
}
int cft_split_newton_f32(const void* uk, const void* F, const void* u,
                         const void* g, const void* Mc, const void* Kc,
                         const void* aux, const void* w, void* uk_out,
                         void* F_out, void* work, void* part,
                         const void* consts, int n1x, int n1y, int tile_rows,
                         int tile_cols, int lin_iters, int cheby,
                         int relinearize, int residual, void* stream) {
  return cft::split_newton<float>(uk, F, u, g, Mc, Kc, aux, w, uk_out, F_out,
                                  work, part, consts, n1x, n1y, tile_rows,
                                  tile_cols, lin_iters, cheby, relinearize,
                                  residual, stream);
}
int cft_split_newton_f64(const void* uk, const void* F, const void* u,
                         const void* g, const void* Mc, const void* Kc,
                         const void* aux, const void* w, void* uk_out,
                         void* F_out, void* work, void* part,
                         const void* consts, int n1x, int n1y, int tile_rows,
                         int tile_cols, int lin_iters, int cheby,
                         int relinearize, int residual, void* stream) {
  return cft::split_newton<double>(uk, F, u, g, Mc, Kc, aux, w, uk_out,
                                   F_out, work, part, consts, n1x, n1y,
                                   tile_rows, tile_cols, lin_iters, cheby,
                                   relinearize, residual, stream);
}
int cft_split_setup_occupancy_f32(int smem, int* out) {
  return cft::tile_kernel_occupancy(cft::split_setup_kernel<float>, smem,
                                    out);
}
int cft_split_setup_occupancy_f64(int smem, int* out) {
  return cft::tile_kernel_occupancy(cft::split_setup_kernel<double>, smem,
                                    out);
}
int cft_split_newton_occupancy_f32(int smem, int* out) {
  return cft::tile_kernel_occupancy(cft::split_newton_kernel<float>, smem,
                                    out);
}
int cft_split_newton_occupancy_f64(int smem, int* out) {
  return cft::tile_kernel_occupancy(cft::split_newton_kernel<double>, smem,
                                    out);
}

}  // extern "C"
