// Hopper kernel for the stabilised RV time step swept in tiles. This
// source builds the KPP instance, tiled_step_burgers.cu the Burgers one
// (fused_step.cuh Kpp, Burgers).
//
// Replaces pallas_tiled.tiled_rv_step (conservation_fem_tpu/ops/
// pallas_tiled.py:120), whole-grid and block mode: the phases of the
// single kernel (fused_step.cuh StepPhases, in the same order) with every
// field in device memory, each pass run over tiles (TileSweep): the sweeps
// that read neighbours — residual-projection rhs, the mass solve
// (Jacobi-PCG, 1 sweep and 1 pointwise pass per iteration, or Chebyshev,
// 1), the RV epsilon, the eps-stiffness planes with the frozen terms, uk0
// and F0, then per Newton iteration the linearisation (or, for a frozen
// Jacobian after the first iteration, a solver re-initialisation), the
// inner solve (BiCGStab, 2 sweeps and 1 pointwise pass per iteration, or
// Chebyshev, 1) and the update uk' = uk + dx with F' = F(uk') — and the
// pointwise passes between them. The result u_{n+1} goes to its own
// output. One cooperative launch per step, as on the TPU.
//
// What bounds it on the H100: a step is a chain of ~45 dependent passes
// (grid.sync() between them, a grid reduction after most), and from mesh
// 256 up a pass's fields and planes (8 to 20 values per node, up to ~90 MB
// at mesh 512 in f32) no longer stay in the 50 MB L2, so each sweep
// streams them from device memory. At 183 registers per thread one
// 256-thread block fits an SM: 8 warps, too few to keep enough loads in
// flight with plain loads, which a thread must wait for before it can use
// or store them. So a sweep is bound by device-memory latency, not by its
// bytes (a single-kernel sweep at mesh 256 reaches ~17% of the HBM rate)
// nor by its operations (< 1% of the f32 peak). Two blocks per SM would
// need 128 registers, and ptxas then spills (40 B in f32, 176 B in f64),
// so the kernel keeps one block per SM and hides the latency instead.
//
// The pipeline (TileSweep, tile_sweep.cuh, where its design is set out):
// every pass copies the raw values it declares, tile by tile, into two
// shared-memory stages with cp.async, the next tile in flight while this
// one computes. ops/tiled_step.py picks the tiles (tile_rows rows by
// tile_cols columns) so that two stages fit the shared memory a block may
// use and the rounds of tiles over the resident blocks cost least. Sweeps
// are separated by grid.sync(); a sweep never writes what it reads at
// neighbours (the ping-pong buffers p / p2, v / v2, uk / uk2 and cd0 / cd1
// exist for that). Dots are per-thread partial sums over the block's
// tiles, combined by the deterministic two-level reduction of stencil.cuh,
// so results repeat bit for bit from run to run.
//
// Block mode (the sharded path, parallel/structured_fused_sharded.py): the
// buffer is a deep-halo row block of a taller grid that starts at global
// row row0 (negative above the grid). Tiles cover the block's rows inside
// the grid only; neighbour, cell and Dirichlet-frame tests go by global
// rows (stencil.cuh GridShape); abs_term = max|u - mean u|, the step's one
// global reduction, is read from a one-element device tensor; the inner
// solver is Chebyshev, so the launch reduces nothing over the grid. The
// output holds the whole block, zero on the rows outside the grid.

#include "tile_sweep.cuh"

namespace cft {

template <typename T> struct TiledParams {
  const T *u, *uo, *uoo, *g, *Mc;
  T *out, *work, *part;
  const T* abs_term;  // block mode with rv: one element; else unused
  const double* consts;
  GridShape gs;
  int tile_rows, tile_cols;
  int cg_iters, newton_iters, lin_iters, bdf2, rv, freeze, cheby, external;
};

template <typename T, typename Fl>
__global__ void __launch_bounds__(kBlock, 1)
tiled_rv_step_kernel(TiledParams<T> P) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  __shared__ RedScratch<T> scratch;
  __shared__ StepConsts<T> C;
  if (threadIdx.x == 0) load_consts(C, P.consts);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const TileSweep<T> sweep(TileGrid(P.gs, P.tile_rows, P.tile_cols),
                           reinterpret_cast<T*>(stage_raw));
  StepPhases<T, TileSweep<T>, Fl> S(grid, scratch, P.part, C, P.gs, sweep,
                                    P.Mc, P.g, P.cheby, P.work, P.external);
  if (P.external) S.zero_outside(P.out);
  const T mean_u = S.project(P.u, P.uo, P.uoo, P.bdf2, P.cg_iters);
  const T abs_term = !P.rv ? T(0)
                     : P.external ? *P.abs_term
                                  : S.abs_term_of(P.u, mean_u);
  S.rv_eps(P.u, abs_term, P.rv);
  S.planes(P.u, P.out, P.newton_iters > 0 ? S.F : nullptr);
  S.newton(P.u, P.out, P.newton_iters, P.lin_iters, P.freeze);
}

template <typename T, typename Fl>
int tiled_rv_step(const void* u, const void* uo, const void* uoo,
                  const void* gvals, const void* Mc, void* out, void* work,
                  void* part, const void* abs_term, const void* consts,
                  int n1x, int n1y, int row0, int n_rows, int external,
                  int tile_rows, int tile_cols, int cg_iters,
                  int newton_iters, int lin_iters, int bdf2, int rv,
                  int freeze, int cheby, void* stream) {
  const GridShape gs = external ? GridShape::block(n1x, n1y, row0, n_rows)
                                : GridShape::whole(n1x, n1y);
  TiledParams<T> P{(const T*)u, (const T*)uo, (const T*)uoo,
                   (const T*)gvals, (const T*)Mc, (T*)out, (T*)work,
                   (T*)part, (const T*)abs_term, (const double*)consts, gs,
                   tile_rows, tile_cols, cg_iters, newton_iters, lin_iters,
                   bdf2, rv, freeze, cheby, external};
  return launch_tiles<T>(tiled_rv_step_kernel<T, Fl>, P, gs, tile_rows,
                         tile_cols, stream);
}

}  // namespace cft

extern "C" {

int CFT_ENTRY(tiled_rv_step, f32)(
    const void* u, const void* uo, const void* uoo, const void* g,
    const void* Mc, void* out, void* work, void* part, const void* abs_term,
    const void* consts, int n1x, int n1y, int row0, int n_rows, int external,
    int tile_rows, int tile_cols, int cg_iters, int newton_iters,
    int lin_iters, int bdf2, int rv, int freeze, int cheby, void* stream) {
  return cft::tiled_rv_step<float, cft::CFT_FLUX>(
      u, uo, uoo, g, Mc, out, work, part, abs_term, consts, n1x, n1y, row0,
      n_rows, external, tile_rows, tile_cols, cg_iters, newton_iters,
      lin_iters, bdf2, rv, freeze, cheby, stream);
}
int CFT_ENTRY(tiled_rv_step, f64)(
    const void* u, const void* uo, const void* uoo, const void* g,
    const void* Mc, void* out, void* work, void* part, const void* abs_term,
    const void* consts, int n1x, int n1y, int row0, int n_rows, int external,
    int tile_rows, int tile_cols, int cg_iters, int newton_iters,
    int lin_iters, int bdf2, int rv, int freeze, int cheby, void* stream) {
  return cft::tiled_rv_step<double, cft::CFT_FLUX>(
      u, uo, uoo, g, Mc, out, work, part, abs_term, consts, n1x, n1y, row0,
      n_rows, external, tile_rows, tile_cols, cg_iters, newton_iters,
      lin_iters, bdf2, rv, freeze, cheby, stream);
}
int CFT_ENTRY(tiled_occupancy, f32)(int smem, int* out) {
  return cft::tile_kernel_occupancy(
      cft::tiled_rv_step_kernel<float, cft::CFT_FLUX>, smem, out);
}
int CFT_ENTRY(tiled_occupancy, f64)(int smem, int* out) {
  return cft::tile_kernel_occupancy(
      cft::tiled_rv_step_kernel<double, cft::CFT_FLUX>, smem, out);
}

}  // extern "C"
