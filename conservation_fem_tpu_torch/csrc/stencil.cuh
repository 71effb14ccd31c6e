// Shared device code of the structured-grid kernels (stencil.cu and the
// step kernels of fused_step.cuh): grid offsets, the 7-plane stencil application, and the
// deterministic block/grid reductions of the cooperative kernels.
//
// Layout: a field is an (n1x, n1y) row-major grid, node n = i * n1y + j;
// a stencil operator is 7 such planes, plane k at offset k * n1x * n1y,
// in the order of ops/structured.OFFSETS:
//   (0,0), (1,0), (-1,0), (0,1), (0,-1), (1,1), (-1,-1).
// Cells: quad (ci, cj) holds triangle L (corners (0,0),(1,0),(1,1)) and
// U ((0,0),(1,1),(0,1)) — ops/structured.CORNERS.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cft {

namespace cg = cooperative_groups;

constexpr int kBlock = 256;      // threads per block of every kernel here
constexpr int kMaxGrid = 2048;   // partial-sum slots the wrappers allocate
constexpr int kMaxRed = 4;       // values reduced together at most

// neighbour offset of stencil plane k
__host__ __device__ constexpr int off_i(int k) {
  return (k == 1 || k == 5) ? 1 : (k == 2 || k == 6) ? -1 : 0;
}
__host__ __device__ constexpr int off_j(int k) {
  return (k == 3 || k == 5) ? 1 : (k == 4 || k == 6) ? -1 : 0;
}
// corner a of triangle type t (0 = L, 1 = U), as a grid offset from (ci, cj)
__host__ __device__ constexpr int corner_i(int t, int a) {
  return a == 0 ? 0 : a == 1 ? 1 : (t == 0 ? 1 : 0);
}
__host__ __device__ constexpr int corner_j(int t, int a) {
  return a == 0 ? 0 : a == 1 ? (t == 0 ? 0 : 1) : 1;
}
// stencil plane holding the (di, dj) neighbour
__host__ __device__ constexpr int plane_of(int di, int dj) {
  return (di == 0 && dj == 0) ? 0
       : (di == 1 && dj == 0) ? 1
       : (di == -1 && dj == 0) ? 2
       : (di == 0 && dj == 1) ? 3
       : (di == 0 && dj == -1) ? 4
       : (di == 1 && dj == 1) ? 5 : 6;
}
// plane of the local pair (a, b) of triangle type t
__host__ __device__ constexpr int pair_plane(int t, int a, int b) {
  return plane_of(corner_i(t, b) - corner_i(t, a),
                  corner_j(t, b) - corner_j(t, a));
}

// An (n1x, n1y) buffer of nodes. It is either a whole grid or a row block
// of a taller (n_rows, n1y) grid whose buffer row 0 is global row row0
// (negative above the grid's first row): the block kernels of the sharded
// path. Rows [i_lo, i_hi) of the buffer lie in the grid; the Dirichlet
// frame is the grid's first and last row (buffer rows top and bot, which
// may lie outside the buffer) and the first and last column. A block edge
// that is not a grid edge is not a frame: the nodes beyond it are simply
// not there, as beyond a grid edge.
struct GridShape {
  int n1x, n1y;
  int i_lo, i_hi, top, bot;
  __host__ __device__ static GridShape whole(int n1x, int n1y) {
    return GridShape{n1x, n1y, 0, n1x, 0, n1x - 1};
  }
  __host__ __device__ static GridShape block(int n1x, int n1y, int row0,
                                             int n_rows) {
    const int lo = row0 < 0 ? -row0 : 0;
    const int hi = n_rows - row0 < n1x ? n_rows - row0 : n1x;
    return GridShape{n1x, n1y, lo, hi, -row0, n_rows - 1 - row0};
  }
  __device__ int size() const { return n1x * n1y; }
  // first node and one past the last node of the rows in the grid
  __device__ int n_lo() const { return i_lo * n1y; }
  __device__ int n_hi() const { return i_hi * n1y; }
  __device__ bool inside(int i, int j) const {
    return i >= i_lo && i < i_hi && j >= 0 && j < n1y;
  }
  // (ci, cj) is the lower-left node of a cell of the grid held here
  __device__ bool cell(int ci, int cj) const {
    return ci >= i_lo && ci < i_hi - 1 && cj >= 0 && cj < n1y - 1;
  }
  __device__ bool frame(int i, int j) const {
    return i == top || i == bot || j == 0 || j == n1y - 1;
  }
};

// y(i, j) = sum_k coef[k](i, j) * x(i + di_k, j + dj_k), with x = 0 outside
// the grid; x(ii, jj) is a functor so callers can form the operand on the
// fly (pinned rows, preconditioned vectors). Planes are summed in order
// k = 0..6, as ops/structured.matvec does.
template <typename T, typename X>
__device__ __forceinline__ T stencil_apply(const T* coef, GridShape g, int i,
                                           int j, X x) {
  const int n = i * g.n1y + j, N = g.size();
  T acc = coef[n] * x(i, j);
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    const int ii = i + off_i(k), jj = j + off_j(k);
    if (g.inside(ii, jj)) acc += coef[k * N + n] * x(ii, jj);
  }
  return acc;
}

struct SumOp {
  template <typename T> __device__ static T identity() { return T(0); }
  template <typename T> __device__ static T apply(T a, T b) { return a + b; }
};
struct MaxOp {
  template <typename T> __device__ static T identity() {
    return -T(INFINITY);
  }
  template <typename T> __device__ static T apply(T a, T b) {
    return a > b ? a : b;
  }
};

// Shared scratch of one block: kMaxRed values per thread.
template <typename T> struct RedScratch { T v[kMaxRed][kBlock]; };

template <typename Op, typename T, int K>
__device__ void block_tree(RedScratch<T>& s) {
  __syncthreads();
#pragma unroll
  for (int w = kBlock / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        s.v[k][threadIdx.x] =
            Op::apply(s.v[k][threadIdx.x], s.v[k][threadIdx.x + w]);
    }
    __syncthreads();
  }
}

// Grid-wide reduction of K per-thread values. Each block writes its
// partial, the grid syncs, and every block combines all partials in the
// same fixed order, so every thread gets the same result, identical from
// run to run. Consecutive reductions alternate between two partial
// buffers: a block can only be one reduction ahead of the slowest one, so
// it never overwrites partials that are still being read. `part` holds
// 2 * kMaxRed * kMaxGrid values.
template <typename T> struct GridReducer {
  T* part;
  int parity;

  template <typename Op, int K>
  __device__ void run(cg::grid_group& grid, RedScratch<T>& s, T (&v)[K]) {
    T* p = part + parity * kMaxRed * kMaxGrid;
    parity ^= 1;
#pragma unroll
    for (int k = 0; k < K; ++k) s.v[k][threadIdx.x] = v[k];
    block_tree<Op, T, K>(s);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) p[k * kMaxGrid + blockIdx.x] = s.v[k][0];
    }
    grid.sync();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T acc = Op::template identity<T>();
      for (int b = threadIdx.x; b < (int)gridDim.x; b += kBlock)
        acc = Op::apply(acc, p[k * kMaxGrid + b]);
      s.v[k][threadIdx.x] = acc;
    }
    block_tree<Op, T, K>(s);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = s.v[k][0];
    __syncthreads();  // s is free for the next reduction
  }
};

// Grid size of a cooperative kernel: every block resident at once, no
// more blocks than n_nodes / kBlock; smem is the dynamic shared memory
// per block.
template <typename Kernel>
inline int coop_grid(Kernel kernel, int n_nodes, size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock,
                                                smem);
  int grid = per_sm * sms;
  const int need = (n_nodes + kBlock - 1) / kBlock;
  if (grid > need) grid = need;
  if (grid > kMaxGrid) grid = kMaxGrid;
  return grid < 1 ? 1 : grid;
}

}  // namespace cft
