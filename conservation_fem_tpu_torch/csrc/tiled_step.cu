// Hopper kernel for the stabilised KPP-RV time step swept in tiles.
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
// The pipeline: every pass declares the raw values it reads (Reads in
// fused_step.cuh): fields at the node and its neighbours, fields at the
// node only, and the 7 planes of each operator (mass, eps-stiffness or
// Jacobian). Block b walks tiles b, b + gridDim.x, ... through two
// shared-memory stages. Before it computes tile t it has already started
// the asynchronous copies of tile t + gridDim.x into the other stage, and
// right after tile t it starts those of tile t + 2 gridDim.x in the stage
// it frees, so one tile's copies are in flight while another computes, and
// no register holds data in flight. A stage holds the neighbour fields over
// the tile and a one-node halo, zero outside the rows [i_lo, i_hi) and
// columns in the grid, and the node fields and planes over the tile.
// Combinations such as the BiCGStab direction dJinv (r + beta (p - omega
// v)) are formed from the staged raw values where the body reads them,
// with the expressions of GridSweep. Writes go straight to device memory,
// coalesced along the tile's rows.
//
// Copy route: cp.async (4-byte copies in f32, 8-byte in f64; a source size
// of 0 fills the halo outside the grid with zeros) in commit groups, one
// group per tile, waited on with wait_group 1 and a __syncthreads(). TMA is
// not used: cuTensorMapEncodeTiled needs global row strides in multiples
// of 16 bytes, and a row here is mesh + 1 nodes (1028 B at mesh 256 in
// f32), so TMA would need padded copies of u, uo, uoo, g and the mass
// planes, and a link against libcuda for cuTensorMapEncodeTiled.
//
// Tiles are tile_rows rows by tile_cols columns; the ragged last row and
// column of tiles are masked. ops/tiled_step.py picks them so that two
// stages fit the shared memory a block may use and the rounds of tiles over
// the resident blocks cost least; the launch takes every block that can be
// resident with that shared memory (coop_grid). Sweeps are separated by
// grid.sync(); a sweep never writes what it reads at neighbours (the
// ping-pong buffers p / p2, v / v2, uk / uk2 and cd0 / cd1 exist for that).
// Dots are per-thread partial sums over the block's tiles, combined by the
// deterministic two-level reduction of stencil.cuh, so results repeat bit
// for bit from run to run.
//
// Block mode (the sharded path, parallel/structured_fused_sharded.py): the
// buffer is a deep-halo row block of a taller grid that starts at global
// row row0 (negative above the grid). Tiles cover the block's rows inside
// the grid only; neighbour, cell and Dirichlet-frame tests go by global
// rows (stencil.cuh GridShape); abs_term = max|u - mean u|, the step's one
// global reduction, is read from a one-element device tensor; the inner
// solver is Chebyshev, so the launch reduces nothing over the grid. The
// output holds the whole block, zero on the rows outside the grid.

#include "fused_step.cuh"

namespace cft {

// A stage holds at most kStageHalo fields over the tile and its halo and
// kStageNode values per node over the tile (node fields + 7 per operator):
// the BiCGStab direction sweep reads 4 fields at neighbours, the update 3
// node fields and 2 operators (ops/tiled_step.py STAGE_HALO, STAGE_NODE).
constexpr int kStageHalo = 4;
constexpr int kStageNode = 17;

__host__ __device__ inline int stage_elems(int rows, int cols) {
  return kStageHalo * (rows + 2) * (cols + 2) + kStageNode * rows * cols;
}

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
  __device__ int row0(int t) const { return g.i_lo + (t / tiles_y) * rows; }
  __device__ int col0(int t) const { return (t % tiles_y) * cols; }
};

// Asynchronous copy of one value from device to shared memory; a source
// size of 0 (valid false) writes a zero and reads nothing.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"((int)sizeof(T)),
               "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raw field k of a staged tile at one node: k < H at halo index h of the
// neighbour region, else at tile index q of the node region.
template <typename T, int H> struct TileAt {
  const T *halo, *node;
  int hs, rc, h, q;
  __device__ __forceinline__ T operator()(int k) const {
    return k < H ? halo[k * hs + h] : node[(k - H) * rc + q];
  }
};

// Plane k of a staged operator at one node.
template <typename T> struct TilePlanes {
  const T* p;
  int rc;
  __device__ __forceinline__ T operator()(int k) const { return p[k * rc]; }
};
template <typename T, int M> struct TileOps {
  const T* node;
  int rc, q;
  __device__ __forceinline__ TilePlanes<T> operator[](int p) const {
    return TilePlanes<T>{node + (M + 7 * p) * rc + q, rc};
  }
};

// The values of a stage, formed from the staged tile where they are read;
// (i0, j0) is the grid node of the halo region's first element.
template <typename T, int H, int NS, typename Stage> struct TileFormedField {
  const Stage* stage;
  const T* halo;
  int i0, j0, hc, hs, s;
  __device__ __forceinline__ T operator()(int i, int j) const {
    T v[NS];
    (*stage)(i, j,
             TileAt<T, H>{halo, halo, hs, 0, (i - i0) * hc + (j - j0), 0},
             v);
    return v[s];
  }
};
template <typename T, int H, int NS, typename Stage> struct TileFormed {
  const Stage* stage;
  const T* halo;
  int i0, j0, hc, hs;
  __device__ __forceinline__ TileFormedField<T, H, NS, Stage> operator[](
      int s) const {
    return TileFormedField<T, H, NS, Stage>{stage, halo, i0, j0, hc, hs, s};
  }
};

// The sweep of the tiled kernel (fused_step.cuh): this block's tiles in
// turn through two shared-memory stages of `stage` values each.
template <typename T> struct TileSweep {
  TileGrid tg;
  T* buf;
  int hc, hs, rc, stage;

  __device__ TileSweep(TileGrid tg_, T* buf_)
      : tg(tg_), buf(buf_), hc(tg_.cols + 2), hs((tg_.rows + 2) * hc),
        rc(tg_.rows * tg_.cols), stage(stage_elems(tg_.rows, tg_.cols)) {}

  // Start the copies of tile t's raw values into dst (no commit).
  template <typename R>
  __device__ void fetch(const R& in, int t, T* dst) const {
    constexpr int H = R::kHalo, M = R::kNode, P = R::kOps;
    const GridShape g = tg.g;
    const int r0 = tg.row0(t), c0 = tg.col0(t), N = g.size();
    if (H > 0) {
      for (int q = threadIdx.x; q < hs; q += kBlock) {
        const int a = q / hc;
        const int i = r0 - 1 + a, j = c0 - 1 + (q - a * hc);
        const bool ok = g.inside(i, j);
        const int n = ok ? i * g.n1y + j : 0;
#pragma unroll
        for (int h = 0; h < H; ++h)
          if (in.f[h]) cp_async(dst + h * hs + q, in.f[h] + n, ok);
      }
    }
    T* node = dst + kStageHalo * hs;
    if (M + P > 0) {
      for (int q = threadIdx.x; q < rc; q += kBlock) {
        const int a = q / tg.cols;
        const int i = r0 + a, j = c0 + (q - a * tg.cols);
        const bool ok = i < g.i_hi && j < g.n1y;
        const int n = ok ? i * g.n1y + j : 0;
#pragma unroll
        for (int m = 0; m < M; ++m)
          if (in.f[H + m]) cp_async(node + m * rc + q, in.f[H + m] + n, ok);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (!in.op[p]) continue;
#pragma unroll
          for (int k = 0; k < 7; ++k)
            cp_async(node + (M + 7 * p + k) * rc + q, in.op[p] + k * N + n,
                     ok);
        }
      }
    }
  }

  template <int NS, typename R, typename Stage, typename Body>
  __device__ void run(const R& in, Stage stage_fn, Body body) const {
    constexpr int H = R::kHalo, M = R::kNode;
    static_assert(H <= kStageHalo && M + 7 * R::kOps <= kStageNode,
                  "a sweep reads more than a stage holds");
    const GridShape g = tg.g;
    const int step = gridDim.x;
    // prologue: the block's first two tiles, one commit group each (a
    // group may be empty, so the wait below always counts tiles)
    for (int s = 0; s < 2; ++s) {
      const int t = blockIdx.x + s * step;
      if (t < tg.count) fetch(in, t, buf + s * stage);
      cp_async_commit();
    }
    int k = 0;
    for (int t = blockIdx.x; t < tg.count; t += step, ++k) {
      T* cur = buf + (k & 1) * stage;
      cp_async_wait<1>();  // tile t's group is done; t + step may fly
      __syncthreads();
      const int r0 = tg.row0(t), c0 = tg.col0(t);
      const TileFormed<T, H, NS, Stage> st{&stage_fn, cur, r0 - 1, c0 - 1,
                                           hc, hs};
      const T* node = cur + kStageHalo * hs;
      for (int q = threadIdx.x; q < rc; q += kBlock) {
        const int a = q / tg.cols, b = q - a * tg.cols;
        const int i = r0 + a, j = c0 + b;
        if (i < g.i_hi && j < g.n1y)
          body(i, j, i * g.n1y + j, st,
               TileAt<T, H>{cur, node, hs, rc, (a + 1) * hc + b + 1, q},
               TileOps<T, M>{node, rc, q});
      }
      __syncthreads();  // every thread is done with this stage
      if (t + 2 * step < tg.count) fetch(in, t + 2 * step, cur);
      cp_async_commit();
    }
    cp_async_wait<0>();
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
  const TileSweep<T> sweep(TileGrid(P.gs, P.tile_rows, P.tile_cols),
                           reinterpret_cast<T*>(stage_raw));
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

// Dynamic shared memory of a launch with (rows, cols) tiles: two stages.
template <typename T> size_t tile_smem(int rows, int cols) {
  return 2 * (size_t)stage_elems(rows, cols) * sizeof(T);
}

// What the card gives the kernel with `smem` bytes of dynamic shared
// memory: out = {resident blocks per SM, registers per thread, local
// memory per thread in bytes (spills), static shared memory per block,
// the most dynamic shared memory a block may take}.
template <typename T> int tiled_occupancy(int smem, int* out) {
  const void* kernel = (const void*)tiled_rv_step_kernel<T>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = optin - (int)a.sharedSizeBytes;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0],
                                                    tiled_rv_step_kernel<T>,
                                                    kBlock, smem);
  return (int)e;
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
  if (gs.i_hi - gs.i_lo < 1 || tile_rows < 1 || tile_cols < 1)
    return (int)cudaErrorInvalidValue;
  TiledParams<T> P{(const T*)u, (const T*)uo, (const T*)uoo,
                   (const T*)gvals, (const T*)Mc, (T*)out, (T*)work,
                   (T*)part, (const T*)abs_term, (const double*)consts, gs,
                   tile_rows, tile_cols, cg_iters, newton_iters, lin_iters,
                   bdf2, rv, freeze, cheby, external};
  const size_t smem = tile_smem<T>(tile_rows, tile_cols);
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
int cft_tiled_occupancy_f32(int smem, int* out) {
  return cft::tiled_occupancy<float>(smem, out);
}
int cft_tiled_occupancy_f64(int smem, int* out) {
  return cft::tiled_occupancy<double>(smem, out);
}

}  // extern "C"
