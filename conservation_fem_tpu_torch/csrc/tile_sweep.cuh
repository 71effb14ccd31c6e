// The tile pipeline of the tiled and split step kernels (tiled_step.cu,
// split_step.cu): TileSweep, the sweep policy of StepPhases
// (fused_step.cuh); the stage geometry; and the launch and occupancy query
// of a kernel that runs it. The tile plan (rows, columns) comes from
// ops/tiled_step.py, which mirrors kStageHalo, kStageNode and stage_elems
// (STAGE_HALO, STAGE_NODE, stage_values).
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
// with the expressions of BandSweep. Writes go straight to device memory,
// coalesced along the tile's rows.
//
// Copy route: cp.async (4-byte copies in f32, 8-byte in f64; a source size
// of 0 fills the halo outside the grid with zeros) in commit groups, one
// group per tile, waited on with wait_group 1 and a __syncthreads(). The
// bf16 planes of the tiled kernel's bf16-plane instance (Reads' OpT) stay
// bf16 in the stage and go in 4-byte pairs of columns: cp.async moves 4, 8
// or 16 bytes, so their rows take an even pitch (plane_pitch) and the
// tiles an even number of columns (ops/tiled_step.tile_geometry), which
// puts every pair on a 4-byte boundary on both sides. TMA is
// not used: cuTensorMapEncodeTiled needs global row strides in multiples
// of 16 bytes, and a row here is mesh + 1 nodes (1028 B at mesh 256 in
// f32), so TMA would need padded copies of u, uo, uoo, g and the mass
// planes, and a link against libcuda for cuTensorMapEncodeTiled.
//
// Tiles are tile_rows rows by tile_cols columns; the ragged last row and
// column of tiles are masked. The launch takes every block that can be
// resident with two stages of shared memory (coop_grid).
#pragma once

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

// Plane k of a staged operator at one node, stored as OT, read as T.
template <typename T, typename OT> struct TilePlanes {
  const OT* p;
  int rc;
  __device__ __forceinline__ T operator()(int k) const {
    return plane_value<T>(p[k * rc]);
  }
};
// The staged operators at one node: after the M node fields, 7 planes of
// OT per operator.
template <typename T, int M, typename OT> struct TileOps {
  const T* node;
  int rc, q;
  __device__ __forceinline__ TilePlanes<T, OT> operator[](int p) const {
    return TilePlanes<T, OT>{
        reinterpret_cast<const OT*>(node + M * rc) + 7 * p * rc + q, rc};
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

// The sweep of the tiled and split kernels (fused_step.cuh): this block's
// tiles in turn through two shared-memory stages of `stage` values each.
template <typename T> struct TileSweep {
  static constexpr bool kOwnReduce = false, kStages = false;
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
    using OT = typename R::OpT;
    constexpr bool half = kHalfPlanes<OT>;
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
        if constexpr (!half) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (!in.op[p]) continue;
#pragma unroll
            for (int k = 0; k < 7; ++k)
              cp_async(node + (M + 7 * p + k) * rc + q,
                       in.op[p] + k * N + n, ok);
          }
        }
      }
    }
    if constexpr (half && P > 0) {
      // bf16 planes in pairs of columns (j even; the pad column of an odd
      // n1y is copied beside the last one and never read)
      const int pitch = plane_pitch<OT>(g.n1y), NP = g.n1x * pitch;
      OT* planes = reinterpret_cast<OT*>(node + M * rc);
      for (int q = 2 * threadIdx.x; q < rc; q += 2 * kBlock) {
        const int a = q / tg.cols;
        const int i = r0 + a, j = c0 + (q - a * tg.cols);
        const bool ok = i < g.i_hi && j < g.n1y;
        const int n = ok ? i * pitch + j : 0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (!in.op[p]) continue;
#pragma unroll
          for (int k = 0; k < 7; ++k)
            cp_async(reinterpret_cast<unsigned*>(planes + (7 * p + k) * rc +
                                                 q),
                     reinterpret_cast<const unsigned*>(in.op[p] + k * NP +
                                                       n),
                     ok);
        }
      }
    }
  }

  template <int NS, typename Q = NoQuad, typename R, typename Stage,
            typename Body>
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
               TileOps<T, M, typename R::OpT>{node, rc, q});
      }
      __syncthreads();  // every thread is done with this stage
      if (t + 2 * step < tg.count) fetch(in, t + 2 * step, cur);
      cp_async_commit();
    }
    cp_async_wait<0>();
  }
};

// Dynamic shared memory of a launch with (rows, cols) tiles: two stages.
template <typename T> size_t tile_smem(int rows, int cols) {
  return 2 * (size_t)stage_elems(rows, cols) * sizeof(T);
}

// What the card gives `kernel` with `smem` bytes of dynamic shared memory:
// out = {resident blocks per SM, registers per thread, local memory per
// thread in bytes (spills), static shared memory per block, the most
// dynamic shared memory a block may take}.
template <typename Params>
int tile_kernel_occupancy(void (*kernel)(Params), int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, (const void*)kernel);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = optin - (int)a.sharedSizeBytes;
  e = cudaFuncSetAttribute((const void*)kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kBlock,
                                                    smem);
  return (int)e;
}

// One cooperative launch of `kernel` over the rows [gs.i_lo, gs.i_hi) of
// the buffer in (tile_rows, tile_cols) tiles: two stages of dynamic shared
// memory per block, and every block that can be resident with them, but
// no more blocks than tiles (coop_grid).
template <typename T, typename Params>
int launch_tiles(void (*kernel)(Params), Params& P, GridShape gs,
                 int tile_rows, int tile_cols, void* stream) {
  if (gs.i_hi - gs.i_lo < 1 || tile_rows < 1 || tile_cols < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem<T>(tile_rows, tile_cols);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((gs.i_hi - gs.i_lo + tile_rows - 1) / tile_rows) *
                    ((gs.n1y + tile_cols - 1) / tile_cols);
  void* args[] = {&P};
  const int grid = coop_grid(kernel, tiles * kBlock, smem);
  e = cudaLaunchCooperativeKernel((void*)kernel, grid, kBlock, args, smem,
                                  (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace cft
