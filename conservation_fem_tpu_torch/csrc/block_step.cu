// Hopper kernel for the stabilised RV time step on a deep-halo row
// block of a taller grid: the per-block kernel of the sharded fused path
// (parallel/structured_fused_sharded.py). This source builds the KPP
// instance, block_step_burgers.cu the Burgers one (fused_step.cuh Kpp,
// Burgers).
//
// Replaces pallas_fused.fused_rv_block_step (conservation_fem_tpu/ops/
// pallas_fused.py:491): one step of the single kernel's algorithm
// (fused_step.cu; the phases are StepPhases of fused_step.cuh over a
// grid-stride sweep) on a (B, n1y) buffer whose row 0 is global row row0 of
// an (n_rows, n1y) grid. The block holds its owned rows and at least
// required_halo() rows of each neighbour; every pass reads neighbours one
// row away, so whatever is wrong at a block edge that is not a grid edge
// moves in one row per pass and never reaches the owned rows. What makes
// this possible without talking to the other blocks:
//   * neighbour, cell and Dirichlet-frame tests go by global rows
//     (stencil.cuh GridShape::block): a neighbour exists if it lies in the
//     buffer and in the grid, the frame is global row 0 and n_rows - 1;
//   * abs_term = max|u - mean u|, the step's one global reduction, is taken
//     by the caller over all blocks and read here from a one-element device
//     tensor (a pointer, so no step waits for the host);
//   * both inner solves are Chebyshev, which takes no dot products.
// So the launch has no grid reduction at all, only grid.sync() between the
// passes. Rows of the buffer outside the grid (above the first block, below
// the last, and the padding rows of an uneven split) are never computed and
// never read; the output is zero there. The TPU kernel's masks by iota and
// its rolls that wrap inside the block are not carried over.
//
// What bounds it on the H100: as the single kernel, the chain of dependent
// passes (grid.sync() latency), here over B = L + 2 D rows for L owned
// ones: the halo's redundant work is the price of one exchange per step.

#include "fused_step.cuh"

namespace cft {

template <typename T> struct BlockParams {
  const T *u, *uo, *uoo, *g, *Mc;
  T *out, *work;
  const T* abs_term;  // one element; unused for gfem
  const double* consts;
  GridShape gs;
  int cg_iters, newton_iters, lin_iters, bdf2, rv, freeze;
};

template <typename T, typename Fl>
__global__ void __launch_bounds__(kBlock, 1)
fused_rv_block_step_kernel(BlockParams<T> P) {
  __shared__ RedScratch<T> scratch;
  __shared__ StepConsts<T> C;
  if (threadIdx.x == 0) load_consts(C, P.consts);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  StepPhases<T, GridSweep<T>, Fl> S(grid, scratch, nullptr, C, P.gs,
                                    GridSweep<T>{P.gs}, P.Mc, P.g,
                                    /*cheby=*/true, P.work,
                                    /*external=*/true);
  S.zero_outside(P.out);
  S.project(P.u, P.uo, P.uoo, P.bdf2, P.cg_iters);
  S.rv_eps(P.u, P.rv ? *P.abs_term : T(0), P.rv);
  S.planes(P.u, P.out, P.newton_iters > 0 ? S.F : nullptr);
  S.newton(P.u, P.out, P.newton_iters, P.lin_iters, P.freeze);
}

template <typename T, typename Fl>
int fused_rv_block_step(const void* u, const void* uo, const void* uoo,
                        const void* gvals, const void* Mc, void* out,
                        void* work, const void* abs_term, const void* consts,
                        int n1x, int n1y, int row0, int n_rows, int cg_iters,
                        int newton_iters, int lin_iters, int bdf2, int rv,
                        int freeze, void* stream) {
  const GridShape gs = GridShape::block(n1x, n1y, row0, n_rows);
  if (gs.i_hi - gs.i_lo < 1) return (int)cudaErrorInvalidValue;
  BlockParams<T> P{(const T*)u, (const T*)uo, (const T*)uoo, (const T*)gvals,
                   (const T*)Mc, (T*)out, (T*)work, (const T*)abs_term,
                   (const double*)consts, gs, cg_iters, newton_iters,
                   lin_iters, bdf2, rv, freeze};
  void* args[] = {&P};
  const int grid = coop_grid(fused_rv_block_step_kernel<T, Fl>,
                             (gs.i_hi - gs.i_lo) * n1y);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)fused_rv_block_step_kernel<T, Fl>, grid, kBlock, args, 0,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace cft

extern "C" {

int CFT_ENTRY(fused_rv_block_step, f32)(
    const void* u, const void* uo, const void* uoo, const void* g,
    const void* Mc, void* out, void* work, const void* abs_term,
    const void* consts, int n1x, int n1y, int row0, int n_rows, int cg_iters,
    int newton_iters, int lin_iters, int bdf2, int rv, int freeze,
    void* stream) {
  return cft::fused_rv_block_step<float, cft::CFT_FLUX>(
      u, uo, uoo, g, Mc, out, work, abs_term, consts, n1x, n1y, row0, n_rows,
      cg_iters, newton_iters, lin_iters, bdf2, rv, freeze, stream);
}
int CFT_ENTRY(fused_rv_block_step, f64)(
    const void* u, const void* uo, const void* uoo, const void* g,
    const void* Mc, void* out, void* work, const void* abs_term,
    const void* consts, int n1x, int n1y, int row0, int n_rows, int cg_iters,
    int newton_iters, int lin_iters, int bdf2, int rv, int freeze,
    void* stream) {
  return cft::fused_rv_block_step<double, cft::CFT_FLUX>(
      u, uo, uoo, g, Mc, out, work, abs_term, consts, n1x, n1y, row0, n_rows,
      cg_iters, newton_iters, lin_iters, bdf2, rv, freeze, stream);
}

}  // extern "C"
