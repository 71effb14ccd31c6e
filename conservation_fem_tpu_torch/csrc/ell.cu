// Hopper kernels of the unstructured fast path (ELL backends banded,
// blocked, blocked2d), with their plain PyTorch versions in
// ops/ell_kernels.py.
//
// The JAX package's blocked backend (conservation_fem_tpu/ops/blocked.py)
// is a TPU design: RCM bands cut into blocks of nb rows, each operator
// held as dense (blocks, nb, Wpad) row windows, every gather and scatter a
// one-hot MXU contraction, bf16 operand streams. None of that is ported:
// a GPU gathers at its memory rate, so the operators stay in the ELL form
// of the mesh's node patches ((N, K) values beside int32 columns), and
// four kernels do the work the one-hot contractions did, each owner-
// computes (one thread writes each output, summing in a fixed order, no
// atomics), so repeated solves on the card repeat their bits:
//   A. ell_spmv: y_i = sum_k A[i,k] x[cols[i,k]], slot order k = 0..K-1;
//      constrained mode (bc non-null): x zeroed on bc rows before the
//      product and y = x on bc rows (blocked.constrained_matvec :837,
//      bc.constrained_matvec). Replaces blocked.spmv (:564) and
//      banded_matvec (ops/banded.py:64).
//   B. ell_assemble: out[e] = sum_{j in seg(e)} vals[perm[j]], summed from
//      0 in segment order: the matrix scatter over mat_perm (one output
//      per ELL entry) or the vector scatter over vec_perm (one per node),
//      the segments given by int32 group bases and uint8 offsets.
//      Replaces blocked.assemble_matrix_components (:641) and
//      scatter_components (:611).
//   C. p1_newton_locals<Fl>: per P1 cell, the 3 rhs locals of N(u) +
//      K_eps u (conv_plus_locals_rhs_components :741) and, in Jacobian
//      mode, the 9 locals of M + dt/2 (K_eps + C'(u)) (eps_locals_
//      components :775, flux_jacobian_locals_components :789 and
//      models/blocked_hyperbolic.py:184-205), by the Dunavant degree-4
//      rule (assembly._DUN4).
//   D. ell_rv_epsilon<Fl>: per node, the patch max and min of u_n, the
//      patch max of |Rh| and of |f'(u_h)|, then eps = min(Cvel h beta,
//      CRV h^2 |R_i|) with R_i = max|Rh| / max(n_i, tiny) and n_i =
//      |u_tilde - abs_term|, 0 on a phantom slot (valid non-null). Replaces
//      the patch part of blocked.rv_epsilon_nonlinear (:876) and
//      stabilization._patch_normalised_residual.
// A patch's padding entries hold the row's own index (ops/mesh.py), which
// is in the patch of every node of a cell, so the patch reductions of D
// read no mask. A, B and D multiply and add with the _rn intrinsics (no
// contraction into fma): A and B are held bit-equal to their plain
// versions on the CPU, which round each product. C's products and sums
// are plain operators, which nvcc may contract into fma: each local is a
// sum of at most 30 rounded terms, so an fma moves it by a few ulps of
// its scale, inside C's gates (1e-5 of each output's max in f32, 1e-11
// in f64).
//
// What bounds each, and the design (every kernel a persistent grid over
// tiles staged by bulk copies, csrc/bulk_copy.cuh):
//   A, D. bytes: A's (N,K) values and columns (padding included: the card
//      reads the K slots of a row) and its x gathers (one a slot); D's
//      columns and its gathers of u_n and Rh (u_h too for Burgers). One
//      tile walk (ell_tile_walk) serves both: tiles of R rows whose
//      staged arrays, contiguous ranges, land by bulk copies in one of
//      two shared-memory stages while the other's rows are worked, a
//      chunk of gathers in flight a thread. The columns are int16 codes
//      where the mesh's patches allow (half the bytes of int32); A's
//      carry the bc flag, so its constrained mode gathers no bc byte.
//   B. bytes: the sorted order perm, the locals it gathers (each read
//      once, but the 32-byte sector of one local is touched by ~3.6
//      tiles, the locals lying in cell order) and the outputs. Tiles of
//      output groups: a tile's range of perm, its offsets and bases land
//      by bulk copies a tile ahead; the gathers of a tile are all
//      independent (apart from its sums, which read shared memory); the
//      streams carry an L2 evict-first policy and the locals evict-last.
//   C. bytes (the cells, areas, gradients in; 12 locals a cell out), and
//      in f64 as much the operations of its 6 sincos a cell. Tiles of 128
//      cells: inputs by bulk copies into two stages, the locals staged in
//      shared memory and written out as contiguous 16-byte stores (one
//      thread a cell would store at a 36-byte stride).
//
// The flux is compiled into C and D (fused_step.cuh Kpp, Burgers): this
// source builds A, B and the KPP instances, ell_burgers.cu the Burgers
// instances of C and D.

#include <algorithm>
#include <type_traits>

#include "bulk_copy.cuh"
#include "fused_step.cuh"

namespace cft {

// the most rows of A's and D's tiles (= threads of their CTAs;
// ops/ell_kernels.py TILE_ROWS)
constexpr int kTileMaxRows = 128;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// A persistent kernel's grid: as many CTAs as the card keeps resident at
// this block size and shared memory (the occupancy query, which counts
// registers too), at most one a tile, at least one. Raises the kernel's
// dynamic shared memory limit to smem where that is above the default.
// Both are kept per device (dev: the current device, whose index the
// caller passes, sparing a cudaGetDevice a launch; the attribute is set on
// each device's own context) and per kernel (Tag: a type of the kernel's
// own). Returns a CUDA error code, or 0 and the CTAs in *ctas.
constexpr int kMaxDevices = 64;

template <typename Tag, typename K>
int persistent_grid(K kernel, int dev, int threads, int smem,
                    long long tiles, int* ctas) {
  struct Residency {
    int smem_set, smem, threads, ctas;
  };
  static Residency per_device[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Residency& r = per_device[dev];
  if (smem > 48 * 1024 && smem > r.smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    r.smem_set = smem;
  }
  if (r.ctas == 0 || r.smem != smem || r.threads != threads) {
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    r = {r.smem_set, smem, threads, per_sm * sms};
  }
  *ctas = (int)std::max(1LL, std::min(tiles, (long long)r.ctas));
  return 0;
}

// A patch column from one of two copies (ops/mesh.with_kernel_index):
// int32 (Col int), where A's copy flags the columns of bc nodes as ~j < 0
// (D's, patch_cols32, has no flags); or int16 (Col short), each the code
// 2 (j - i) + bc[j], for meshes whose patches stay within 2^14 rows of
// their node (RCM-ordered ones; the padding, the row itself, is 2 bc[i]).
// skip: the column is flagged and kBc asks for the flags.
template <bool kBc>
__device__ __forceinline__ int ell_col(int c, long long, bool& skip) {
  skip = kBc && c < 0;
  return c < 0 ? ~c : c;
}
template <bool kBc>
__device__ __forceinline__ int ell_col(short c, long long i, bool& skip) {
  skip = kBc && (c & 1);
  return (int)(i + (c >> 1));
}

// The tile walk of A and D: a persistent grid of CTAs of R threads, each
// walking tiles of R consecutive rows (tile t, t + grid, ...). A tile's R
// K slots of each array the row operation stages are one contiguous range;
// they land in one of two shared-memory stages while the other stage's
// rows are worked, one thread a row. Odd K (stride Kp = K): thread 0
// issues one bulk copy an array a tile (R is a multiple of 8, so every
// tile's ranges, int16 too, start and end on 16 bytes). Even K (int32
// columns): each thread copies single values with cp.async into rows
// padded to Kp = K + 1, so that the threads' rows start in different
// banks. The n - tiles R rows after the last whole tile are worked by the
// last CTA straight from device memory. Rows (SpmvRows, RvRows): the row
// operation, with its staged arrays (kSlotBytes a slot; bind carves the
// two stages, bulk and copy fill them) and its row from a stage (staged:
// the row's slots from o on) or from device memory (direct).
template <typename Rows>
__device__ __forceinline__ void ell_tile_walk(Rows& rows, int n, int K,
                                              int Kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // one per stage
  const int R = blockDim.x;
  const int stage = R * Kp;
  rows.bind(smem + 16, 2 * stage);
  const int tiles = n / R;
  const bool bulk = Kp == K;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) mbar_init(&bar[s], bulk ? 1 : R);
    mbar_init_fence();
  }
  __syncthreads();
  auto fill = [&](int tile, int s) {
    const long long first = (long long)tile * R * K;
    if (bulk) {
      if (threadIdx.x == 0) {
        async_proxy_fence();
        mbar_expect_tx(&bar[s], (unsigned)(R * K) * Rows::kSlotBytes);
        rows.bulk(first, s * stage, (unsigned)(R * K), &bar[s]);
      }
    } else {
      for (int e = threadIdx.x; e < R * K; e += R) {
        const int r = e / K;
        rows.copy(first + e, s * stage + r * Kp + (e - r * K));
      }
      mbar_arrive_on_copies(&bar[s]);
    }
  };
  for (int u = 0, t = blockIdx.x; u < 2 && t < tiles; ++u, t += gridDim.x)
    fill(t, u);
  int j = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    const int s = j & 1;
    mbar_wait(&bar[s], (j >> 1) & 1);
    rows.staged(s * stage + threadIdx.x * Kp,
                (long long)t * R + threadIdx.x);
    __syncthreads();  // every row of stage s worked: it may be refilled
    const int next = t + 2 * (int)gridDim.x;
    if (next < tiles) fill(next, s);
  }
  if (blockIdx.x == gridDim.x - 1)
    for (long long i = (long long)tiles * R + threadIdx.x; i < n; i += R)
      rows.direct(i);
}

// Where an ELL kernel launches: the current device's index (the caller's,
// persistent_grid) and the stream.
struct Launch {
  int dev;
  cudaStream_t stream;
};

// The launch of a tile walk on the plan of ops/ell_kernels.tile_plan: R
// rows a tile (threads a CTA), smem bytes of dynamic shared memory; Tag: a
// type of the kernel's own (persistent_grid).
template <typename Tag, typename Kernel, typename... Args>
int launch_tile_walk(Kernel kernel, int n, int R, int smem, Launch at,
                     Args... args) {
  int ctas = 0;
  if (int e = persistent_grid<Tag>(kernel, at.dev, R, smem, n / R, &ctas))
    return e;
  kernel<<<ctas, R, smem, at.stream>>>(args...);
  return (int)cudaGetLastError();
}

#ifndef CFT_ELL_FLUX_ONLY

// A. Row i of y = A x, its slots summed in order with rounded products;
// kBc: the constrained mode, whose products skip the flagged columns (x
// zeroed there); the unconstrained mode reads the same copy and ignores
// the flags. The gathers of x are what a row waits on (x lies in L2):
// kSpmvChunk of them are issued together, then their products summed in
// slot order.
constexpr int kSpmvChunk = 16;

template <typename T, bool kBc, typename Col>
__device__ __forceinline__ T ell_row(const T* a, const Col* c, int K,
                                     long long i, const T* __restrict__ x) {
  T acc = T(0);
  for (int k0 = 0; k0 < K; k0 += kSpmvChunk) {
    T xv[kSpmvChunk], av[kSpmvChunk];
#pragma unroll
    for (int u = 0; u < kSpmvChunk; ++u) {
      const int k = k0 + u;
      if (k < K) {
        bool skip;
        const int j = ell_col<kBc>(c[k], i, skip);
        xv[u] = skip ? T(0) : __ldg(x + j);
        av[u] = a[k];
      }
    }
#pragma unroll
    for (int u = 0; u < kSpmvChunk; ++u) {
      const int k = k0 + u;
      if (k < K) {
        const T p = mul_rn(av[u], xv[u]);
        acc = k == 0 ? p : add_rn(acc, p);
      }
    }
  }
  return acc;
}

// A's row operation: the values and the columns staged.
template <typename T, bool kBc, typename Col>
struct SpmvRows {
  const T* A;
  const Col* cols;
  const T* x;
  const unsigned char* bc;
  T* y;
  int K;
  T* sv;    // [2][stage] values
  Col* sc;  // [2][stage] columns
  static constexpr unsigned kSlotBytes = sizeof(T) + sizeof(Col);
  __device__ void bind(unsigned char* p, int slots) {
    sv = reinterpret_cast<T*>(p);
    sc = reinterpret_cast<Col*>(sv + slots);
  }
  __device__ void bulk(long long first, int o, unsigned count,
                       uint64_t* bar) const {
    bulk_copy(sv + o, A + first, count * (unsigned)sizeof(T), bar);
    bulk_copy(sc + o, cols + first, count * (unsigned)sizeof(Col), bar);
  }
  __device__ void copy(long long src, int o) const {
    if constexpr (sizeof(Col) == 4) {  // even K: int32 columns alone
      copy_value_async(sv + o, A + src);
      copy_value_async(sc + o, cols + src);
    }
  }
  __device__ void row(const T* a, const Col* c, long long i) const {
    const T acc = ell_row<T, kBc>(a, c, K, i, x);
    y[i] = (kBc && __ldg(bc + i)) ? x[i] : acc;
  }
  __device__ void staged(int o, long long i) const { row(sv + o, sc + o, i); }
  __device__ void direct(long long i) const {
    row(A + i * K, cols + i * K, i);
  }
};

template <typename T, bool kBc, typename Col>
__global__ void __launch_bounds__(kTileMaxRows)
    ell_spmv_kernel(const T* __restrict__ A, const Col* __restrict__ cols,
                    const T* __restrict__ x,
                    const unsigned char* __restrict__ bc,
                    T* __restrict__ y, int n, int K, int Kp) {
  SpmvRows<T, kBc, Col> rows{A, cols, x, bc, y, K};
  ell_tile_walk(rows, n, K, Kp);
}

// narrow: the int16 column codes, else the flagged int32 columns.
template <typename T, bool kBc, typename Col>
int launch_ell_spmv(const void* A, const void* cols, const void* x,
                    const void* bc, void* y, int n, int K, int R, int Kp,
                    int smem, Launch at) {
  using Tag = void(T, std::integral_constant<bool, kBc>, Col);
  return launch_tile_walk<Tag>(ell_spmv_kernel<T, kBc, Col>, n, R, smem, at,
                               (const T*)A, (const Col*)cols, (const T*)x,
                               (const unsigned char*)bc, (T*)y, n, K, Kp);
}

template <typename T, typename Col>
int ell_spmv_cols(const void* A, const void* cols, const void* x,
                  const void* bc, void* y, int n, int K, int R, int Kp,
                  int smem, Launch at) {
  if (bc == nullptr)
    return launch_ell_spmv<T, false, Col>(A, cols, x, bc, y, n, K, R, Kp,
                                          smem, at);
  return launch_ell_spmv<T, true, Col>(A, cols, x, bc, y, n, K, R, Kp, smem,
                                       at);
}

template <typename T>
int ell_spmv(const void* A, const void* cols, const void* x, const void* bc,
             void* y, int n, int K, int R, int Kp, int smem, int narrow,
             int dev, void* stream) {
  if (n <= 0) return 0;
  const Launch at{dev, (cudaStream_t)stream};
  if (narrow)
    return ell_spmv_cols<T, short>(A, cols, x, bc, y, n, K, R, Kp, smem, at);
  return ell_spmv_cols<T, int>(A, cols, x, bc, y, n, K, R, Kp, smem, at);
}

// B. The outputs come in groups of W consecutive ones (matrix mode: an
// ELL row, W = K; vector mode: ops/mesh.VEC_GROUP nodes). Each group has
// the int32 start of its contributions in the sorted order (base, one
// more entry than groups), each output the uint8 start of its segment in
// its group (off): output e of group g sums the contributions base[g] +
// off[e] to base[g] + off[e + 1] (to base[g + 1] for the group's last).
// Both are padded to a multiple of 16 groups (empty ones), perm to a
// multiple of 4 entries, and the groups cut into tiles of whole 16-group
// units, each with its first group and contribution in tiles (one more
// entry than tiles), holding at most cap - 8 contributions and gmax groups
// (ops/mesh.with_kernel_index refuses a unit that holds more). So every
// range below starts and ends on 16 bytes, and a tile's contributions are
// one contiguous range [j0, j1) of the order. A persistent grid of CTAs
// of kAsmThreads threads walks the tiles. Thread 0 stages each tile a
// tile ahead by bulk copies into one of two stages: its offsets, its bases
// and its range of perm from j0 rounded down to 16 bytes (the skew
// carried), at most cap entries. Then, per tile, every thread gathers
// locals vals[perm[j]] for j = j0 + t, j0 + t + T, ... into shared memory,
// kAsmChunk of them in flight; after a barrier, one thread an output sums
// its segment from shared memory, from 0, in segment order (an empty
// output, ELL padding, is 0). The streams (perm, offsets, bases, outputs)
// carry an L2 evict-first policy, the gathered locals evict-last, so that
// the locals, whose 32-byte sectors several tiles touch at different
// times, stay in L2 while the streams pass. kMatrix: the mode, each a
// kernel of its own (persistent_grid keeps one shared-memory limit and
// grid a kernel, and the modes' plans differ).
constexpr int kAsmThreads = 256;
constexpr int kAsmChunk = 8;

template <typename T, bool kMatrix>
__global__ void __launch_bounds__(kAsmThreads)
    ell_assemble_kernel(const T* __restrict__ vals,
                        const int* __restrict__ perm,
                        const unsigned char* __restrict__ off,
                        const int* __restrict__ base,
                        const int2* __restrict__ tiles_at,
                        T* __restrict__ out, int n_out, int W, int tiles,
                        int gmax, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // one per stage
  // [2][8]: j0, j1, a0 (j0 rounded down to 16 bytes), g0, groups
  int* hdr = reinterpret_cast<int*>(smem + 16);
  int* sp = hdr + 16;  // [2][cap] perm
  unsigned char* so = reinterpret_cast<unsigned char*>(sp + 2 * cap);
  int* sb = reinterpret_cast<int*>(so + 2 * gmax * W);  // [2][gmax] bases
  T* sv = reinterpret_cast<T*>(sb + 2 * gmax);  // [cap] gathered locals
  const uint64_t stream = l2_evict_first();
  const uint64_t keep = l2_evict_last();
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) mbar_init(&bar[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  // thread 0: a tile's first group and contribution and the next tile's
  // (read a tile ahead of its fill), then the fill of stage s
  auto bounds = [&](int tile, int2& first, int2& end) {
    first = __ldg(tiles_at + tile);
    end = __ldg(tiles_at + tile + 1);
  };
  auto fill = [&](int s, int2 first, int2 end) {
    const int g0 = first.x, gn = end.x - first.x;
    const int j0 = first.y, j1 = end.y;
    const int a0 = j0 & ~3, a1 = (j1 + 3) & ~3;
    int* h = hdr + 8 * s;
    h[0] = j0;
    h[1] = j1;
    h[2] = a0;
    h[3] = g0;
    h[4] = gn;
    const unsigned pb = (unsigned)(a1 - a0) * 4u;
    async_proxy_fence();
    mbar_expect_tx(&bar[s], (unsigned)(gn * W + gn * 4) + pb);
    bulk_copy_hint(so + s * gmax * W, off + (long long)g0 * W,
                   (unsigned)(gn * W), &bar[s], stream);
    bulk_copy_hint(sb + s * gmax, base + g0, (unsigned)(gn * 4), &bar[s],
                   stream);
    if (pb) bulk_copy_hint(sp + s * cap, perm + a0, pb, &bar[s], stream);
  };
  if (threadIdx.x == 0)
    for (int u = 0, t = blockIdx.x; u < 2 && t < tiles;
         ++u, t += gridDim.x) {
      int2 first, end;
      bounds(t, first, end);
      fill(u, first, end);
    }
  int k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const int s = k & 1;
    const int next = t + 2 * (int)gridDim.x;
    int2 nfirst, nend;
    if (threadIdx.x == 0 && next < tiles) bounds(next, nfirst, nend);
    mbar_wait(&bar[s], (k >> 1) & 1);
    const int* h = hdr + 8 * s;
    const int j0 = h[0], j1 = h[1], cnt = j1 - j0, skew = j0 - h[2];
    const int gn = h[4];
    const unsigned char* to = so + s * gmax * W;
    const int* tb = sb + s * gmax;
    const int* tp = sp + s * cap + skew;
    for (int q0 = threadIdx.x; q0 < cnt; q0 += kAsmThreads * kAsmChunk) {
      T v[kAsmChunk];
#pragma unroll
      for (int u = 0; u < kAsmChunk; ++u) {
        const int q = q0 + u * kAsmThreads;
        if (q < cnt) v[u] = load_hint(vals + tp[q], keep);
      }
#pragma unroll
      for (int u = 0; u < kAsmChunk; ++u) {
        const int q = q0 + u * kAsmThreads;
        if (q < cnt) sv[q] = v[u];
      }
    }
    __syncthreads();  // the gathered locals in place
    const long long e0 = (long long)h[3] * W;
    for (int e = threadIdx.x; e < gn * W && e0 + e < n_out;
         e += kAsmThreads) {
      const int g = e / W;
      const int st = tb[g] - j0 + to[e];
      const int en = e + 1 < (g + 1) * W ? tb[g] - j0 + to[e + 1]
                     : (g + 1 < gn ? tb[g + 1] : j1) - j0;
      T acc = T(0);
      for (int q = st; q < en; ++q) acc = add_rn(acc, sv[q]);
      store_hint(out + e0 + e, acc, stream);
    }
    __syncthreads();  // stage s and the locals read: they may be rewritten
    if (threadIdx.x == 0 && next < tiles) fill(s, nfirst, nend);
  }
}

// The launch of B on the plan of ops/ell_kernels.assemble_plan: at most
// gmax groups and cap perm entries a stage, smem bytes of dynamic shared
// memory.
template <typename T, bool kMatrix>
int launch_ell_assemble(const void* vals, const void* perm, const void* off,
                        const void* base, const void* tiles_at, void* out,
                        int n_out, int W, int tiles, int gmax, int cap,
                        int smem, Launch at) {
  auto kernel = ell_assemble_kernel<T, kMatrix>;
  using Tag = void(T, std::integral_constant<bool, kMatrix>);
  int ctas = 0;
  if (int e = persistent_grid<Tag>(kernel, at.dev, kAsmThreads, smem, tiles,
                                   &ctas))
    return e;
  kernel<<<ctas, kAsmThreads, smem, at.stream>>>(
      (const T*)vals, (const int*)perm, (const unsigned char*)off,
      (const int*)base, (const int2*)tiles_at, (T*)out, n_out, W, tiles,
      gmax, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int ell_assemble(const void* vals, const void* perm, const void* off,
                 const void* base, const void* tiles_at, void* out,
                 int n_out, int W, int tiles, int gmax, int cap, int smem,
                 int matrix, int dev, void* stream) {
  if (n_out <= 0) return 0;
  const Launch at{dev, (cudaStream_t)stream};
  if (matrix)
    return launch_ell_assemble<T, true>(vals, perm, off, base, tiles_at, out,
                                        n_out, W, tiles, gmax, cap, smem,
                                        at);
  return launch_ell_assemble<T, false>(vals, perm, off, base, tiles_at, out,
                                       n_out, W, tiles, gmax, cap, smem,
                                       at);
}

#endif  // CFT_ELL_FLUX_ONLY

// The Dunavant degree-4 rule of ops/assembly.py (_DUN4_P, _DUN4_W): phi
// and the weights (times the reference area 1/2) formed in f64, then
// rounded to T, as the plain version's tables are.
template <typename T>
__device__ __forceinline__ void dun4(int q, T (&phi)[3], T& w) {
  const double a1 = 0.445948490915965, b1 = 0.108103018168070;
  const double a2 = 0.091576213509771, b2 = 0.816847572980459;
  const double px[6] = {a1, b1, a1, a2, b2, a2};
  const double py[6] = {a1, a1, b1, a2, a2, b2};
  const double wq[6] = {0.223381589678011, 0.223381589678011,
                        0.223381589678011, 0.109951743655322,
                        0.109951743655322, 0.109951743655322};
  phi[0] = (T)(1.0 - px[q] - py[q]);
  phi[1] = (T)px[q];
  phi[2] = (T)py[q];
  w = (T)(wq[q] * 0.5);
}

// C. The locals of one cell from its nodes, gradients and area (u and
// eps gathered at the nodes): rhs[3] and, when jac is non-null, jac[9].
template <typename T, typename Fl>
__device__ __forceinline__ void p1_cell_locals(const int (&node)[3],
                                               const T (&gx)[3],
                                               const T (&gy)[3], const T ar,
                                               const T* __restrict__ u,
                                               const T* __restrict__ eps,
                                               T half_dt, T* rhs, T* jac) {
  T uc[3];
  for (int a = 0; a < 3; ++a) uc[a] = __ldg(u + node[a]);
  T gux = T(0), guy = T(0);
  for (int a = 0; a < 3; ++a) {
    gux += uc[a] * gx[a];
    guy += uc[a] * gy[a];
  }
  T r[3] = {T(0), T(0), T(0)};
  T L[3][3] = {};
  const bool want_jac = jac != nullptr;
  for (int q = 0; q < 6; ++q) {
    T phi[3], w;
    dun4<T>(q, phi, w);
    T uq = phi[0] * uc[0] + phi[1] * uc[1] + phi[2] * uc[2];
    T fx, fy, dfx, dfy;
    Fl::fp_fpp(uq, fx, fy, dfx, dfy);
    T conv = fx * gux + fy * guy;
    T t1 = dfx * gux + dfy * guy;
    for (int a = 0; a < 3; ++a) {
      T wa = w * phi[a];
      r[a] += wa * conv;
      if (want_jac)
        for (int b = 0; b < 3; ++b)
          L[a][b] += wa * (t1 * phi[b] + fx * gx[b] + fy * gy[b]);
    }
  }
  const T two_area = T(2) * ar;
  T Ke[3][3] = {};
  if (eps != nullptr) {
    T sc = ar * ((__ldg(eps + node[0]) + __ldg(eps + node[1])
                  + __ldg(eps + node[2])) / T(3));
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        Ke[a][b] = sc * (gx[a] * gx[b] + gy[a] * gy[b]);
  }
  for (int a = 0; a < 3; ++a) {
    T v = two_area * r[a];
    if (eps != nullptr)
      v += Ke[a][0] * uc[0] + Ke[a][1] * uc[1] + Ke[a][2] * uc[2];
    rhs[a] = v;
  }
  if (want_jac) {
    const T m_diag = ar * (T(2) / T(12)), m_off = ar * (T(1) / T(12));
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        jac[3 * a + b] = ((a == b ? m_diag : m_off) + half_dt * Ke[a][b])
                         + half_dt * (two_area * L[a][b]);
  }
}

// A persistent grid of CTAs of C = kLocalsCells threads, each walking
// tiles of C consecutive cells (tile t, t + grid, ...). A tile's cells (3C
// int32), areas (C) and gradients (6C) are three contiguous ranges that
// land by bulk copies in one of two stages while the other stage's cells
// are computed, one thread a cell, in registers. The thread leaves its 3
// rhs and 9 Jacobian locals in a shared output tile, which the CTA then
// writes out as contiguous 16-byte stores (3C and 9C values: the locals of
// consecutive cells are consecutive). The cells after the last whole tile
// are computed by the last CTA from device memory and stored directly.
constexpr int kLocalsCells = 128;

template <typename T, typename Fl>
__global__ void __launch_bounds__(kLocalsCells)
    p1_newton_locals_kernel(const int* __restrict__ cells,
                            const T* __restrict__ area,
                            const T* __restrict__ grads,
                            const T* __restrict__ u,
                            const T* __restrict__ eps, T half_dt,
                            T* __restrict__ rhs, T* __restrict__ jac,
                            int M) {
  constexpr int C = kLocalsCells;
  constexpr int kVec = 16 / sizeof(T);  // values a 16-byte store
  using Vec = typename std::conditional<sizeof(T) == 4, float4,
                                        double2>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // one per stage
  T* sg = reinterpret_cast<T*>(smem + 16);  // [2][6C] gradients
  T* sa = sg + 2 * 6 * C;                   // [2][C] areas
  int* sn = reinterpret_cast<int*>(sa + 2 * C);  // [2][3C] nodes
  T* so = reinterpret_cast<T*>(sn + 2 * 3 * C);  // [3C rhs | 9C jac]
  const int tiles = M / C;
  const int c = threadIdx.x;
  if (c == 0) {
    for (int s = 0; s < 2; ++s) mbar_init(&bar[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto fill = [&](int tile, int s) {
    if (c == 0) {
      const long long m0 = (long long)tile * C;
      async_proxy_fence();
      mbar_expect_tx(&bar[s], (unsigned)(C * (7 * sizeof(T) + 12)));
      bulk_copy(sg + s * 6 * C, grads + 6 * m0, 6 * C * sizeof(T), &bar[s]);
      bulk_copy(sa + s * C, area + m0, C * sizeof(T), &bar[s]);
      bulk_copy(sn + s * 3 * C, cells + 3 * m0, 3 * C * 4, &bar[s]);
    }
  };
  for (int k = 0, t = blockIdx.x; k < 2 && t < tiles; ++k, t += gridDim.x)
    fill(t, k);
  int j = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    const int s = j & 1;
    mbar_wait(&bar[s], (j >> 1) & 1);
    int node[3];
    T gx[3], gy[3];
    for (int a = 0; a < 3; ++a) {
      node[a] = sn[s * 3 * C + 3 * c + a];
      gx[a] = sg[s * 6 * C + 6 * c + 2 * a];
      gy[a] = sg[s * 6 * C + 6 * c + 2 * a + 1];
    }
    const T ar = sa[s * C + c];
    p1_cell_locals<T, Fl>(node, gx, gy, ar, u, eps, half_dt, so + 3 * c,
                          jac != nullptr ? so + 3 * C + 9 * c : nullptr);
    __syncthreads();  // stage s read, the output tile written
    const int next = t + 2 * (int)gridDim.x;
    if (next < tiles) fill(next, s);
    const long long m0 = (long long)t * C;
    Vec* dr = reinterpret_cast<Vec*>(rhs + 3 * m0);
    const Vec* vo = reinterpret_cast<const Vec*>(so);
    for (int e = c; e < 3 * C / kVec; e += C) dr[e] = vo[e];
    if (jac != nullptr) {
      Vec* dj = reinterpret_cast<Vec*>(jac + 9 * m0);
      for (int e = c; e < 9 * C / kVec; e += C) dj[e] = vo[3 * C / kVec + e];
    }
    __syncthreads();  // the output tile stored: it may be rewritten
  }
  if (blockIdx.x == gridDim.x - 1)
    for (long long m = (long long)tiles * C + c; m < M; m += C) {
      int node[3];
      T gx[3], gy[3];
      for (int a = 0; a < 3; ++a) {
        node[a] = __ldg(cells + 3 * m + a);
        gx[a] = __ldg(grads + 6 * m + 2 * a);
        gy[a] = __ldg(grads + 6 * m + 2 * a + 1);
      }
      p1_cell_locals<T, Fl>(node, gx, gy, __ldg(area + m), u, eps, half_dt,
                            rhs + 3 * m,
                            jac != nullptr ? jac + 9 * m : nullptr);
    }
}

// D. A node's patch reductions: the gathers of u_n and Rh (and u_h where
// the flux reads max|u_h|, Fl::kAbsMax) of a chunk of kRvChunk slots
// issued together, then reduced in slot order (a chunk of 12 covers the
// anchored meshes' K = 11 in one: with 16, the registers the chunk holds
// cost resident CTAs, and D read slower on the card); the columns staged
// (int16 codes or int32 patch_cols32, the padding decoding to the row
// itself, in the patch of every node: no mask). A phantom slot (valid[i]
// = 0) writes 0 and gathers nothing.
constexpr int kRvChunk = 12;

template <typename T, typename Fl, typename Col>
struct RvRows {
  const Col* cols;
  const T* u_n;
  const T* rh;
  const T* uh;
  const T* h;
  const T* abs_term;
  const unsigned char* valid;
  T cvel, crv, tiny;
  T* eps;
  int K;
  Col* sc;  // [2][stage] columns
  static constexpr unsigned kSlotBytes = sizeof(Col);
  __device__ void bind(unsigned char* p, int) {
    sc = reinterpret_cast<Col*>(p);
  }
  __device__ void bulk(long long first, int o, unsigned count,
                       uint64_t* bar) const {
    bulk_copy(sc + o, cols + first, count * (unsigned)sizeof(Col), bar);
  }
  __device__ void copy(long long src, int o) const {
    if constexpr (sizeof(Col) == 4) copy_value_async(sc + o, cols + src);
  }
  __device__ void row(const Col* c, long long i) const {
    if (valid != nullptr && !__ldg(valid + i)) {
      eps[i] = T(0);
      return;
    }
    T umax = -INFINITY, umin = INFINITY, rmax = T(0), amax = T(0);
    for (int k0 = 0; k0 < K; k0 += kRvChunk) {
      T uv[kRvChunk], rv[kRvChunk], av[kRvChunk];
#pragma unroll
      for (int q = 0; q < kRvChunk; ++q) {
        const int k = k0 + q;
        if (k < K) {
          bool skip;
          const int j = ell_col<false>(c[k], i, skip);
          uv[q] = __ldg(u_n + j);
          rv[q] = __ldg(rh + j);
          if (Fl::kAbsMax) av[q] = __ldg(uh + j);
        }
      }
#pragma unroll
      for (int q = 0; q < kRvChunk; ++q) {
        if (k0 + q < K) {
          umax = fmax(umax, uv[q]);
          umin = fmin(umin, uv[q]);
          rmax = fmax(rmax, fabs(rv[q]));
          if (Fl::kAbsMax) amax = fmax(amax, fabs(av[q]));
        }
      }
    }
    const T beta = Fl::beta(amax);
    const T ni = fabs((umax - umin) - __ldg(abs_term));
    const T R = rmax / fmax(ni, tiny);
    const T hi = __ldg(h + i);
    eps[i] = fmin(mul_rn(mul_rn(cvel, hi), beta),
                  mul_rn(mul_rn(crv, mul_rn(hi, hi)), fabs(R)));
  }
  __device__ void staged(int o, long long i) const { row(sc + o, i); }
  __device__ void direct(long long i) const { row(cols + i * K, i); }
};

// D's launch bound: ell_burgers.cu asks for CFT_RV_MIN_BLOCKS = 4
// resident CTAs an SM (a cap of 128 registers, above what each Burgers
// instance uses), without which ptxas spilled 4 bytes in the f32 int16
// instance; the KPP instances take no minimum: with one (even 1), ptxas
// took up to 1.8 x the registers (f32 int16: 97 against 55) and D read
// 1.5 x slower on the card.
#ifdef CFT_RV_MIN_BLOCKS
#define CFT_RV_LAUNCH_BOUNDS __launch_bounds__(kTileMaxRows, CFT_RV_MIN_BLOCKS)
#else
#define CFT_RV_LAUNCH_BOUNDS __launch_bounds__(kTileMaxRows)
#endif

template <typename T, typename Fl, typename Col>
__global__ void CFT_RV_LAUNCH_BOUNDS
    ell_rv_epsilon_kernel(const Col* __restrict__ cols,
                          const T* __restrict__ u_n,
                          const T* __restrict__ rh,
                          const T* __restrict__ uh,
                          const T* __restrict__ h,
                          const T* __restrict__ abs_term,
                          const unsigned char* __restrict__ valid, T cvel,
                          T crv, T tiny, T* __restrict__ eps, int n, int K,
                          int Kp) {
  RvRows<T, Fl, Col> rows{cols, u_n, rh, uh, h, abs_term, valid,
                          cvel, crv, tiny, eps, K};
  ell_tile_walk(rows, n, K, Kp);
}

// The launch of C: CTAs of kLocalsCells threads, smem bytes of dynamic
// shared memory (ops/ell_kernels.locals_smem).
template <typename T>
int p1_newton_locals(const void* cells, const void* area, const void* grads,
                     const void* u, const void* eps, double half_dt,
                     void* rhs, void* jac, int M, int smem, int dev,
                     void* stream) {
  if (M <= 0) return 0;
  auto kernel = p1_newton_locals_kernel<T, CFT_FLUX>;
  using Tag = void(T, CFT_FLUX);
  int ctas = 0;
  if (int e = persistent_grid<Tag>(kernel, dev, kLocalsCells, smem,
                                   M / kLocalsCells, &ctas))
    return e;
  kernel<<<ctas, kLocalsCells, smem, (cudaStream_t)stream>>>(
      (const int*)cells, (const T*)area, (const T*)grads, (const T*)u,
      (const T*)eps, (T)half_dt, (T*)rhs, (T*)jac, M);
  return (int)cudaGetLastError();
}

// The launch of D on the plan of ops/ell_kernels.tile_plan (R, Kp, smem);
// narrow: the int16 column codes, else patch_cols32.
template <typename T, typename Col>
int launch_ell_rv_epsilon(const void* cols, const void* u_n, const void* rh,
                          const void* uh, const void* h,
                          const void* abs_term, const void* valid,
                          double cvel, double crv, double tiny, void* eps,
                          int n, int K, int R, int Kp, int smem, Launch at) {
  using Tag = void(T, CFT_FLUX, Col);
  return launch_tile_walk<Tag>(
      ell_rv_epsilon_kernel<T, CFT_FLUX, Col>, n, R, smem, at,
      (const Col*)cols, (const T*)u_n, (const T*)rh, (const T*)uh,
      (const T*)h, (const T*)abs_term, (const unsigned char*)valid, (T)cvel,
      (T)crv, (T)tiny, (T*)eps, n, K, Kp);
}

template <typename T>
int ell_rv_epsilon(const void* cols, const void* u_n, const void* rh,
                   const void* uh, const void* h, const void* abs_term,
                   const void* valid, double cvel, double crv, double tiny,
                   void* eps, int n, int K, int R, int Kp, int smem,
                   int narrow, int dev, void* stream) {
  if (n <= 0) return 0;
  const Launch at{dev, (cudaStream_t)stream};
  if (narrow)
    return launch_ell_rv_epsilon<T, short>(cols, u_n, rh, uh, h, abs_term,
                                           valid, cvel, crv, tiny, eps, n,
                                           K, R, Kp, smem, at);
  return launch_ell_rv_epsilon<T, int>(cols, u_n, rh, uh, h, abs_term, valid,
                                       cvel, crv, tiny, eps, n, K, R, Kp,
                                       smem, at);
}

}  // namespace cft

#define CFT_LOCALS_ARGS                                                    \
  const void *cells, const void *area, const void *grads, const void *u,   \
      const void *eps, double half_dt, void *rhs, void *jac, int M,        \
      int smem, int dev, void *stream
#define CFT_LOCALS_CALL                                                    \
  cells, area, grads, u, eps, half_dt, rhs, jac, M, smem, dev, stream
#define CFT_RV_ARGS                                                        \
  const void *cols, const void *u_n, const void *rh, const void *uh,       \
      const void *h, const void *abs_term, const void *valid, double cvel, \
      double crv, double tiny, void *eps, int n, int K, int R, int Kp,     \
      int smem, int narrow, int dev, void *stream
#define CFT_RV_CALL                                                        \
  cols, u_n, rh, uh, h, abs_term, valid, cvel, crv, tiny, eps, n, K, R,    \
      Kp, smem, narrow, dev, stream
#define CFT_ASSEMBLE_ARGS                                                  \
  const void *vals, const void *perm, const void *off, const void *base,   \
      const void *tiles_at, void *out, int n_out, int W, int tiles,        \
      int gmax, int cap, int smem, int matrix, int dev, void *stream
#define CFT_ASSEMBLE_CALL                                                  \
  vals, perm, off, base, tiles_at, out, n_out, W, tiles, gmax, cap, smem,  \
      matrix, dev, stream

extern "C" {

#ifndef CFT_ELL_FLUX_ONLY
int cft_ell_spmv_f32(const void* A, const void* cols, const void* x,
                     const void* bc, void* y, int n, int K, int R, int Kp,
                     int smem, int narrow, int dev, void* stream) {
  return cft::ell_spmv<float>(A, cols, x, bc, y, n, K, R, Kp, smem, narrow,
                              dev, stream);
}
int cft_ell_spmv_f64(const void* A, const void* cols, const void* x,
                     const void* bc, void* y, int n, int K, int R, int Kp,
                     int smem, int narrow, int dev, void* stream) {
  return cft::ell_spmv<double>(A, cols, x, bc, y, n, K, R, Kp, smem, narrow,
                               dev, stream);
}
int cft_ell_assemble_f32(CFT_ASSEMBLE_ARGS) {
  return cft::ell_assemble<float>(CFT_ASSEMBLE_CALL);
}
int cft_ell_assemble_f64(CFT_ASSEMBLE_ARGS) {
  return cft::ell_assemble<double>(CFT_ASSEMBLE_CALL);
}
#endif

int CFT_ENTRY(p1_newton_locals, f32)(CFT_LOCALS_ARGS) {
  return cft::p1_newton_locals<float>(CFT_LOCALS_CALL);
}
int CFT_ENTRY(p1_newton_locals, f64)(CFT_LOCALS_ARGS) {
  return cft::p1_newton_locals<double>(CFT_LOCALS_CALL);
}
int CFT_ENTRY(ell_rv_epsilon, f32)(CFT_RV_ARGS) {
  return cft::ell_rv_epsilon<float>(CFT_RV_CALL);
}
int CFT_ENTRY(ell_rv_epsilon, f64)(CFT_RV_ARGS) {
  return cft::ell_rv_epsilon<double>(CFT_RV_CALL);
}

}  // extern "C"
