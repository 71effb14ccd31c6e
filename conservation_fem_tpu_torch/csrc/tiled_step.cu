// Hopper kernel for the stabilised KPP-RV time step swept in tiles.
//
// Replaces pallas_tiled.tiled_rv_step (conservation_fem_tpu/ops/
// pallas_tiled.py:120), whole-grid and block mode: the phases of the
// single kernel (fused_step.cuh StepPhases, in the same order) with every
// field in device memory, each phase that reads neighbours run as a sweep
// over tiles (TileSweep) — residual-projection rhs, the mass solve
// (Jacobi-PCG, 1 sweep and 1 pointwise pass per iteration, or Chebyshev,
// 1), the RV epsilon, the eps-stiffness planes with the frozen terms, uk0
// and F0, then per Newton iteration the linearisation (or, for a frozen
// Jacobian after the first iteration, a solver re-initialisation), the
// inner solve (BiCGStab, 2 sweeps and 1 pointwise pass per iteration, or
// Chebyshev, 1) and the update uk' = uk + dx with F' = F(uk'). The result
// u_{n+1} goes to its own output. One cooperative launch per step, as on
// the TPU.
//
// Tiles: a tile is tile_rows rows (the TPU kernel's meaning) by tile_cols
// columns of the grid; block b sweeps tiles b, b + gridDim.x, ... so a
// block loops over its tiles where there are more tiles than resident
// blocks, and the ragged last row and column of tiles are masked. A sweep
// stages the fields it reads at neighbours — or the combination it needs
// there, such as the new BiCGStab direction dJinv (r + beta (p - omega
// v)) — over the tile plus a one-node halo into shared memory, then
// computes every interior node from the staged values; fields read only
// at the node itself and the stencil planes stream from device memory.
// The halo is one node deep: each node gathers its six triangles and its
// six neighbours directly, so no sweep chains two shifts (the TPU kernel's
// 3-row chains come from whole-array rolls). Sweeps are separated by
// grid.sync(); a sweep never writes what it stages (the direction and
// solution ping-pong buffers p / p2, v / v2, uk / uk2, and the Chebyshev
// direction cd0 / cd1, exist for that), because other blocks read halo
// nodes while this one writes its interior. The TPU kernel accumulates its
// dots in SMEM scalars across sequential tile sweeps; here every thread
// sums its nodes over its block's tiles and the deterministic two-level
// reduction of stencil.cuh combines them in a fixed order.
//
// Block mode (the sharded path, parallel/structured_fused_sharded.py): the
// buffer is a deep-halo row block of a taller grid that starts at global
// row row0 (negative above the grid). Tiles cover the block's rows inside
// the grid only; neighbour, cell and Dirichlet-frame tests go by global
// rows (stencil.cuh GridShape); abs_term = max|u - mean u|, the step's one
// global reduction, is read from a one-element device tensor; the inner
// solver is Chebyshev, so the launch reduces nothing over the grid. The
// output holds the whole block, zero on the rows outside the grid.
//
// What bounds it on the H100: like the single step, a chain of dependent
// sweeps (grid-sync latency) and, beyond the 50 MB L2 (mesh 256 and up),
// device-memory latency per sweep; a sweep moves at most the 7 Jacobian
// planes and a handful of fields. The staging adds a second __syncthreads
// per tile and a halo of 2 (tile_rows + tile_cols) + 4 nodes per tile.

#include "fused_step.cuh"

namespace cft {

constexpr int kStaged = 3;  // values a sweep stages together at most

template <typename T> struct TiledParams {
  const T *u, *uo, *uoo, *g, *Mc;
  T *out, *work, *part;
  const T* abs_term;  // block mode with rv: one element; else unused
  const double* consts;
  GridShape gs;
  int tile_rows, tile_cols;
  int cg_iters, newton_iters, lin_iters, bdf2, rv, freeze, cheby, external;
};

struct TileGrid {
  GridShape g;
  int rows, cols, tiles_y, count;
  __device__ TileGrid(GridShape g_, int rows_, int cols_)
      : g(g_), rows(rows_), cols(cols_),
        tiles_y((g_.n1y + cols_ - 1) / cols_),
        count(((g_.i_hi - g_.i_lo + rows_ - 1) / rows_) * tiles_y) {}
};

// A staged field as an (i, j) accessor in grid coordinates.
template <typename T> struct Staged {
  const T* p;
  int i0, j0, hc;
  __device__ T operator()(int i, int j) const {
    return p[(i - i0) * hc + (j - j0)];
  }
};

template <typename T> struct StagedTile {
  const T* buf;
  int i0, j0, hc, hs;
  __device__ Staged<T> operator[](int s) const {
    return Staged<T>{buf + s * hs, i0, j0, hc};
  }
};

// The sweep of the tiled kernel (fused_step.cuh): over this block's tiles,
// stage the NS values of stage(i, j, n, v) over the tile and its one-node
// halo (zero outside the grid), then run body(i, j, n, st) at each node of
// the tile with st[s] the staged value s.
template <typename T> struct TileSweep {
  TileGrid tg;
  T* buf;
  template <int NS, typename Stage, typename Body>
  __device__ void run(Stage stage, Body body) const {
    const GridShape g = tg.g;
    const int hc = tg.cols + 2, hs = (tg.rows + 2) * hc;
    for (int t = blockIdx.x; t < tg.count; t += gridDim.x) {
      const int r0 = g.i_lo + (t / tg.tiles_y) * tg.rows;
      const int c0 = (t % tg.tiles_y) * tg.cols;
      for (int l = threadIdx.x; l < hs; l += kBlock) {
        const int i = r0 - 1 + l / hc, j = c0 - 1 + l % hc;
        T v[NS];
        if (g.inside(i, j)) {
          stage(i, j, i * g.n1y + j, v);
        } else {
#pragma unroll
          for (int s = 0; s < NS; ++s) v[s] = T(0);
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) buf[s * hs + l] = v[s];
      }
      __syncthreads();
      const StagedTile<T> st{buf, r0 - 1, c0 - 1, hc, hs};
      for (int l = threadIdx.x; l < tg.rows * tg.cols; l += kBlock) {
        const int i = r0 + l / tg.cols, j = c0 + l % tg.cols;
        if (i < g.i_hi && j < g.n1y) body(i, j, i * g.n1y + j, st);
      }
      __syncthreads();  // the buffer is free for the next tile
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
tiled_rv_step_kernel(TiledParams<T> P) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  __shared__ RedScratch<T> scratch;
  __shared__ StepConsts<T> C;
  if (threadIdx.x == 0) load_consts(C, P.consts);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const TileSweep<T> sweep{TileGrid(P.gs, P.tile_rows, P.tile_cols),
                           reinterpret_cast<T*>(stage_raw)};
  StepPhases<T, TileSweep<T>> S(grid, scratch, P.part, C, P.gs, sweep, P.Mc,
                                P.g, P.cheby, P.work, P.external);
  if (P.external) S.zero_outside(P.out);
  const T mean_u = S.project(P.u, P.uo, P.uoo, P.bdf2, P.cg_iters);
  const T abs_term = !P.rv ? T(0)
                     : P.external ? *P.abs_term
                                  : S.abs_term_of(P.u, mean_u);
  S.rv_eps(P.u, abs_term, P.rv);
  S.planes(P.u, P.out, P.newton_iters > 0 ? S.F : nullptr);
  S.newton(P.u, P.out, P.newton_iters, P.lin_iters, P.freeze);
}

template <typename T>
int tiled_rv_step(const void* u, const void* uo, const void* uoo,
                  const void* gvals, const void* Mc, void* out, void* work,
                  void* part, const void* abs_term, const void* consts,
                  int n1x, int n1y, int row0, int n_rows, int external,
                  int tile_rows, int tile_cols, int cg_iters,
                  int newton_iters, int lin_iters, int bdf2, int rv,
                  int freeze, int cheby, void* stream) {
  const GridShape gs = external ? GridShape::block(n1x, n1y, row0, n_rows)
                                : GridShape::whole(n1x, n1y);
  if (gs.i_hi - gs.i_lo < 1) return (int)cudaErrorInvalidValue;
  TiledParams<T> P{(const T*)u, (const T*)uo, (const T*)uoo,
                   (const T*)gvals, (const T*)Mc, (T*)out, (T*)work,
                   (T*)part, (const T*)abs_term, (const double*)consts, gs,
                   tile_rows, tile_cols, cg_iters, newton_iters, lin_iters,
                   bdf2, rv, freeze, cheby, external};
  const size_t smem =
      (size_t)kStaged * (tile_rows + 2) * (tile_cols + 2) * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)tiled_rv_step_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((gs.i_hi - gs.i_lo + tile_rows - 1) / tile_rows) *
                    ((n1y + tile_cols - 1) / tile_cols);
  void* args[] = {&P};
  const int grid = coop_grid(tiled_rv_step_kernel<T>, tiles * kBlock, smem);
  e = cudaLaunchCooperativeKernel((void*)tiled_rv_step_kernel<T>, grid,
                                  kBlock, args, smem, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace cft

extern "C" {

int cft_tiled_rv_step_f32(const void* u, const void* uo, const void* uoo,
                          const void* g, const void* Mc, void* out,
                          void* work, void* part, const void* abs_term,
                          const void* consts, int n1x, int n1y, int row0,
                          int n_rows, int external, int tile_rows,
                          int tile_cols, int cg_iters, int newton_iters,
                          int lin_iters, int bdf2, int rv, int freeze,
                          int cheby, void* stream) {
  return cft::tiled_rv_step<float>(u, uo, uoo, g, Mc, out, work, part,
                                   abs_term, consts, n1x, n1y, row0, n_rows,
                                   external, tile_rows, tile_cols, cg_iters,
                                   newton_iters, lin_iters, bdf2, rv,
                                   freeze, cheby, stream);
}
int cft_tiled_rv_step_f64(const void* u, const void* uo, const void* uoo,
                          const void* g, const void* Mc, void* out,
                          void* work, void* part, const void* abs_term,
                          const void* consts, int n1x, int n1y, int row0,
                          int n_rows, int external, int tile_rows,
                          int tile_cols, int cg_iters, int newton_iters,
                          int lin_iters, int bdf2, int rv, int freeze,
                          int cheby, void* stream) {
  return cft::tiled_rv_step<double>(u, uo, uoo, g, Mc, out, work, part,
                                    abs_term, consts, n1x, n1y, row0, n_rows,
                                    external, tile_rows, tile_cols, cg_iters,
                                    newton_iters, lin_iters, bdf2, rv,
                                    freeze, cheby, stream);
}

}  // extern "C"
