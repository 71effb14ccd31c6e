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
//      0 in segment order: the matrix scatter over mat_perm / mat_offs (one
//      output per ELL entry) or the vector scatter over vec_perm /
//      vec_offs (one per node). Replaces blocked.assemble_matrix_components
//      (:641) and scatter_components (:611).
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
// What bounds each, and the design (A and C walk tiles staged by bulk
// copies; B and D run one thread an output):
//   A. bytes (the (N,K) values and columns, padding included: the card
//      reads the K slots of a row) and the x gathers (one a slot). A
//      persistent grid walks tiles of R rows; a tile's values and
//      columns, two contiguous ranges, land by bulk copies in one of two
//      shared-memory stages while the other's rows are summed, kSpmvChunk
//      gathers in flight a thread. The columns are int16 codes where the
//      mesh's patches allow (half the bytes of int32), and carry the bc
//      flag, so the constrained mode gathers no bc byte beside each x[j].
//   C. bytes (the cells, areas, gradients in; 12 locals a cell out), and
//      in f64 as much the operations of its 6 sincos a cell. Tiles of 128
//      cells: inputs by bulk copies into two stages, the locals staged in
//      shared memory and written out as contiguous 16-byte stores (one
//      thread a cell would store at a 36-byte stride).
//   B. the scattered reads vals[perm[j]]; D the column gathers (ROADMAP
//      queue 2: rule-2 items still open).
//
// The flux is compiled into C and D (fused_step.cuh Kpp, Burgers): this
// source builds A, B and the KPP instances, ell_burgers.cu the Burgers
// instances of C and D.

#include <algorithm>
#include <type_traits>

#include "bulk_copy.cuh"
#include "fused_step.cuh"

namespace cft {

constexpr int kEllThreads = 256;
// the most rows of A's tiles (= threads of its CTAs; ops/ell_kernels.py
// SPMV_TILE_ROWS)
constexpr int kSpmvMaxRows = 128;

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

inline int ell_blocks(long long n) {
  return (int)((n + kEllThreads - 1) / kEllThreads);
}

// A persistent kernel's grid: as many CTAs as the card keeps resident at
// this block size and shared memory (the occupancy query, which counts
// registers too), at most one a tile, at least one. Raises the kernel's
// dynamic shared memory limit to smem where that is above the default.
// Both are kept per device (the attribute is set on each device's own
// context) and per kernel (Tag: a type of the kernel's own). Returns a
// CUDA error code, or 0 and the CTAs in *ctas.
constexpr int kMaxDevices = 64;

template <typename Tag, typename K>
int persistent_grid(K kernel, int threads, int smem, long long tiles,
                    int* ctas) {
  struct Residency {
    int smem_set, smem, threads, ctas;
  };
  static Residency per_device[kMaxDevices];
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
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

#ifndef CFT_ELL_FLUX_ONLY

// A. Row i of y = A x, its slots summed in order with rounded products.
// Its columns come in one of two copies (ops/mesh.with_kernel_index):
// int32 (Col int), the columns of bc nodes flagged ~j < 0; or int16 (Col
// short), each the code 2 (j - i) + bc[j], for meshes whose patches stay
// within 2^14 rows of their node (RCM-ordered ones). kBc: the constrained
// mode, whose products skip the flagged columns (x zeroed there); the
// unconstrained mode reads the same copy and ignores the flags. The
// gathers of x are what a row waits on (x lies in L2): kSpmvChunk of them
// are issued together, then their products summed in slot order.
constexpr int kSpmvChunk = 16;

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

// A persistent grid of CTAs of R threads, each walking tiles of R
// consecutive rows (tile t, t + grid, ...). A tile's R K values and R K
// columns are two contiguous ranges; they land in one of two shared-memory
// stages while the other stage's rows are summed, one thread a row. Odd K
// (stride Kp = K): two bulk copies a tile, issued by thread 0 (R is a
// multiple of 8, so every tile's ranges start and end on 16 bytes). Even
// K (int32 columns): each thread copies values with cp.async into rows
// padded to Kp = K + 1, so that the threads' rows start in different
// banks. The n - tiles R rows after the last whole tile are summed by the
// last CTA straight from device memory.
template <typename T, bool kBc, typename Col>
__global__ void __launch_bounds__(kSpmvMaxRows)
    ell_spmv_kernel(const T* __restrict__ A, const Col* __restrict__ cols,
                    const T* __restrict__ x,
                    const unsigned char* __restrict__ bc,
                    T* __restrict__ y, int n, int K, int Kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // one per stage
  const int R = blockDim.x;
  const int stage = R * Kp;
  T* sv = reinterpret_cast<T*>(smem + 16);
  Col* sc = reinterpret_cast<Col*>(sv + 2 * stage);
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
        mbar_expect_tx(&bar[s], (unsigned)(R * K * (sizeof(T) + sizeof(Col))));
        bulk_copy(sv + s * stage, A + first, (unsigned)(R * K * sizeof(T)),
                  &bar[s]);
        bulk_copy(sc + s * stage, cols + first,
                  (unsigned)(R * K * sizeof(Col)), &bar[s]);
      }
    } else {
      if constexpr (sizeof(Col) == 4)  // even K: int32 columns alone
        for (int e = threadIdx.x; e < R * K; e += R) {
          const int r = e / K, o = s * stage + r * Kp + (e - r * K);
          copy_value_async(sv + o, A + first + e);
          copy_value_async(sc + o, cols + first + e);
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
    const long long i = (long long)t * R + threadIdx.x;
    const int o = s * stage + threadIdx.x * Kp;
    const T acc = ell_row<T, kBc>(sv + o, sc + o, K, i, x);
    y[i] = (kBc && __ldg(bc + i)) ? x[i] : acc;
    __syncthreads();  // every row of stage s summed: it may be refilled
    const int next = t + 2 * (int)gridDim.x;
    if (next < tiles) fill(next, s);
  }
  if (blockIdx.x == gridDim.x - 1)
    for (long long i = (long long)tiles * R + threadIdx.x; i < n; i += R) {
      const T acc = ell_row<T, kBc>(A + i * K, cols + i * K, K, i, x);
      y[i] = (kBc && __ldg(bc + i)) ? x[i] : acc;
    }
}

template <typename T>
__global__ void __launch_bounds__(kEllThreads)
    ell_assemble_kernel(const T* __restrict__ vals,
                        const int* __restrict__ perm,
                        const int* __restrict__ offs, T* __restrict__ out,
                        int n_out) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  T acc = T(0);
  for (int j = __ldg(offs + e), end = __ldg(offs + e + 1); j < end; ++j)
    acc = add_rn(acc, __ldg(vals + __ldg(perm + j)));
  out[e] = acc;
}

// The launch of A on the plan of ops/ell_kernels.spmv_plan: R rows a
// tile (threads a CTA), stride Kp, smem bytes of dynamic shared memory;
// narrow: the int16 column codes, else the flagged int32 columns.
template <typename T, bool kBc, typename Col>
int launch_ell_spmv(const void* A, const void* cols, const void* x,
                    const void* bc, void* y, int n, int K, int R, int Kp,
                    int smem, cudaStream_t stream) {
  auto kernel = ell_spmv_kernel<T, kBc, Col>;
  using Tag = void(T, std::integral_constant<bool, kBc>, Col);
  int ctas = 0;
  if (int e = persistent_grid<Tag>(kernel, R, smem, n / R, &ctas)) return e;
  kernel<<<ctas, R, smem, stream>>>((const T*)A, (const Col*)cols,
                                    (const T*)x, (const unsigned char*)bc,
                                    (T*)y, n, K, Kp);
  return (int)cudaGetLastError();
}

template <typename T, typename Col>
int ell_spmv_cols(const void* A, const void* cols, const void* x,
                  const void* bc, void* y, int n, int K, int R, int Kp,
                  int smem, cudaStream_t st) {
  if (bc == nullptr)
    return launch_ell_spmv<T, false, Col>(A, cols, x, bc, y, n, K, R, Kp,
                                          smem, st);
  return launch_ell_spmv<T, true, Col>(A, cols, x, bc, y, n, K, R, Kp, smem,
                                       st);
}

template <typename T>
int ell_spmv(const void* A, const void* cols, const void* x, const void* bc,
             void* y, int n, int K, int R, int Kp, int smem, int narrow,
             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (narrow)
    return ell_spmv_cols<T, short>(A, cols, x, bc, y, n, K, R, Kp, smem, st);
  return ell_spmv_cols<T, int>(A, cols, x, bc, y, n, K, R, Kp, smem, st);
}

template <typename T>
int ell_assemble(const void* vals, const void* perm, const void* offs,
                 void* out, int n_out, void* stream) {
  if (n_out <= 0) return 0;
  ell_assemble_kernel<T><<<ell_blocks(n_out), kEllThreads, 0,
                           (cudaStream_t)stream>>>(
      (const T*)vals, (const int*)perm, (const int*)offs, (T*)out, n_out);
  return (int)cudaGetLastError();
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

template <typename T, typename Fl>
__global__ void __launch_bounds__(kEllThreads)
    ell_rv_epsilon_kernel(const int* __restrict__ cols,
                          const T* __restrict__ u_n,
                          const T* __restrict__ rh,
                          const T* __restrict__ uh,
                          const T* __restrict__ h,
                          const T* __restrict__ abs_term,
                          const unsigned char* __restrict__ valid, T cvel,
                          T crv, T tiny, T* __restrict__ eps, int n,
                          int K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (valid != nullptr && !valid[i]) {
    eps[i] = T(0);
    return;
  }
  const int* c = cols + (long long)i * K;
  T umax = -INFINITY, umin = INFINITY, rmax = T(0), amax = T(0);
  for (int k = 0; k < K; ++k) {
    int j = __ldg(c + k);
    T v = __ldg(u_n + j);
    umax = fmax(umax, v);
    umin = fmin(umin, v);
    rmax = fmax(rmax, fabs(__ldg(rh + j)));
    if (Fl::kAbsMax) amax = fmax(amax, fabs(__ldg(uh + j)));
  }
  T beta = Fl::beta(amax);
  T ni = fabs((umax - umin) - __ldg(abs_term));
  T R = rmax / fmax(ni, tiny);
  T hi = __ldg(h + i);
  eps[i] = fmin(mul_rn(mul_rn(cvel, hi), beta),
                mul_rn(mul_rn(crv, mul_rn(hi, hi)), fabs(R)));
}

// The launch of C: CTAs of kLocalsCells threads, smem bytes of dynamic
// shared memory (ops/ell_kernels.locals_smem).
template <typename T>
int p1_newton_locals(const void* cells, const void* area, const void* grads,
                     const void* u, const void* eps, double half_dt,
                     void* rhs, void* jac, int M, int smem, void* stream) {
  if (M <= 0) return 0;
  auto kernel = p1_newton_locals_kernel<T, CFT_FLUX>;
  using Tag = void(T, CFT_FLUX);
  int ctas = 0;
  if (int e = persistent_grid<Tag>(kernel, kLocalsCells, smem,
                                   M / kLocalsCells, &ctas))
    return e;
  kernel<<<ctas, kLocalsCells, smem, (cudaStream_t)stream>>>(
      (const int*)cells, (const T*)area, (const T*)grads, (const T*)u,
      (const T*)eps, (T)half_dt, (T*)rhs, (T*)jac, M);
  return (int)cudaGetLastError();
}

template <typename T>
int ell_rv_epsilon(const void* cols, const void* u_n, const void* rh,
                   const void* uh, const void* h, const void* abs_term,
                   const void* valid, double cvel, double crv, double tiny,
                   void* eps, int n, int K, void* stream) {
  if (n <= 0) return 0;
  ell_rv_epsilon_kernel<T, CFT_FLUX><<<ell_blocks(n), kEllThreads, 0,
                                       (cudaStream_t)stream>>>(
      (const int*)cols, (const T*)u_n, (const T*)rh, (const T*)uh,
      (const T*)h, (const T*)abs_term, (const unsigned char*)valid,
      (T)cvel, (T)crv, (T)tiny, (T*)eps, n, K);
  return (int)cudaGetLastError();
}

}  // namespace cft

#define CFT_LOCALS_ARGS                                                    \
  const void *cells, const void *area, const void *grads, const void *u,   \
      const void *eps, double half_dt, void *rhs, void *jac, int M,        \
      int smem, void *stream
#define CFT_LOCALS_CALL                                                    \
  cells, area, grads, u, eps, half_dt, rhs, jac, M, smem, stream
#define CFT_RV_ARGS                                                        \
  const void *cols, const void *u_n, const void *rh, const void *uh,       \
      const void *h, const void *abs_term, const void *valid, double cvel, \
      double crv, double tiny, void *eps, int n, int K, void *stream
#define CFT_RV_CALL                                                        \
  cols, u_n, rh, uh, h, abs_term, valid, cvel, crv, tiny, eps, n, K, stream

extern "C" {

#ifndef CFT_ELL_FLUX_ONLY
int cft_ell_spmv_f32(const void* A, const void* cols, const void* x,
                     const void* bc, void* y, int n, int K, int R, int Kp,
                     int smem, int narrow, void* stream) {
  return cft::ell_spmv<float>(A, cols, x, bc, y, n, K, R, Kp, smem, narrow,
                              stream);
}
int cft_ell_spmv_f64(const void* A, const void* cols, const void* x,
                     const void* bc, void* y, int n, int K, int R, int Kp,
                     int smem, int narrow, void* stream) {
  return cft::ell_spmv<double>(A, cols, x, bc, y, n, K, R, Kp, smem, narrow,
                               stream);
}
int cft_ell_assemble_f32(const void* vals, const void* perm,
                         const void* offs, void* out, int n_out,
                         void* stream) {
  return cft::ell_assemble<float>(vals, perm, offs, out, n_out, stream);
}
int cft_ell_assemble_f64(const void* vals, const void* perm,
                         const void* offs, void* out, int n_out,
                         void* stream) {
  return cft::ell_assemble<double>(vals, perm, offs, out, n_out, stream);
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
