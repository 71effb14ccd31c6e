// Hopper kernels for the structured stencil backend.
//
// Replaces the TPU kernels of conservation_fem_tpu/ops/pallas_stencil.py:
//   * stencil_matvec (pallas_stencil.py:40): y = A x for a (7, n1x, n1y)
//     stencil, zero outside the grid;
//   * cg_solve (pallas_stencil.py:64): adaptive Jacobi-PCG with Dirichlet
//     rows pinned, its convergence loop inside the kernel.
//
// stencil_matvec reads 7 planes + x and writes y, 9 field-sized streams
// (~4.8 MB at mesh 64 in f64), so it is bound by memory traffic. One thread
// per node, neighbouring threads on neighbouring addresses: coalesced.
//
// cg_solve is bound by the latency of each iteration's two reductions and
// the barriers they end in, not by its bytes: at the shapes that launch it
// (Burgers 51^2 and 101^2, KPP 257^2 in f64) an iteration streams under
// 5 MB from L2 in well under a microsecond, while at Burgers 51^2 on 16
// CTAs the two reductions take ~4300 of the ~6100 cycles of an iteration
// (scripts/torch_cg_phases.py, which builds this file with -DCG_PHASES:
// the CG_PHASE probes below). The TPU kernel keeps the whole field in
// VMEM and runs its while_loop inside the kernel; here the loop runs
// inside one launch too, over bands of nodes resident on the SMs for the
// whole solve (band_start: contiguous bands of at least n1y + 1 nodes, so
// a band's halo of n1y + 1 nodes on either side lies in the bands c - 1
// and c + 1). Two instances, the plan from ops/stencil_kernels.cg_plan:
//   * cluster: one thread-block cluster of C <= 16 CTAs holds the solve's
//     whole state in its distributed shared memory: each CTA its band's 7
//     planes, dinv, mask, x, r, Ap, two p buffers and the matvec's operand,
//     read from device memory once and x written once at the end. The
//     matvec reads its halo from CTA c +- 1's shared memory
//     (map_shared_rank); a reduction is a warp-shuffle tree into a CTA
//     partial that warp 0 writes into every CTA's shared memory, one
//     hardware cluster barrier, then every thread sums the C partials of
//     its own shared memory in rank order;
//   * grid: one cooperative CTA per SM (<= 132) for a state no cluster
//     holds. The planes, dinv, mask, x and Ap stay in shared memory where
//     the band fits (resident), r and p go to device memory, where the
//     neighbours read their halos through L2, and a reduction is grid_all
//     (stencil.cuh: shuffle trees around one grid.sync()). Where the band
//     does not fit (KPP mesh 256 in f64) everything is in device memory,
//     two CTAs run on an SM and a thread keeps four (f32) or eight (f64)
//     nodes' loads in flight: more loads in flight against the HBM's
//     latency.
// Either way an iteration takes two barriers, those of its two reductions:
// the update p_{k+1} = dinv r + beta p_k is folded into the next matvec.
// p_{k+1} goes to the other p buffer; at a halo node the CTA forms it from
// the neighbour's r and p_k, final after the second reduction's barrier,
// with the expression its owner uses (p_next), so both hold the same bits.
// The stopping test sum r^2 > rtol^2 sum b^2 is taken on the device from a
// deterministic reduction; no scalar goes to the host inside the solve.

#include "stencil.cuh"

namespace cft {

template <typename T>
__global__ void __launch_bounds__(kBlock)
stencil_matvec_kernel(const T* __restrict__ coef, const T* __restrict__ x,
                      T* __restrict__ y, GridShape g) {
  const int n = blockIdx.x * kBlock + threadIdx.x;
  if (n >= g.size()) return;
  const int i = n / g.n1y, j = n % g.n1y;
  y[n] = stencil_apply(PlanesAt<T>{coef, n, g.size()}, g, i, j,
                       [&](int ii, int jj) { return x[ii * g.n1y + jj]; });
}

__global__ void empty_kernel() {}

constexpr int kMaxCluster = 16;  // CTAs of the largest (non-portable) cluster

// The plan of a cg_solve launch (ops/stencil_kernels.cg_plan): ctas bands,
// the band's own arrays in shared memory or not (resident; always in the
// cluster instance) and the largest band, ceil(N / ctas) (the stride of a
// plane).
struct CgPlan {
  int ctas, resident, cap;
};

// The shared memory of a CTA, in values of T and then bytes
// (ops/stencil_kernels.cg_smem mirrors it). Resident: the band's 7 planes,
// dinv, x, Ap, the two p buffers and, in the cluster instance, r, cap
// values each (CgSlot), and the matvec's operand where(bc, 0, p) at the
// band and its halo, cap + 2 h values (h = n1y + 1: the halo below the
// band, the band, the halo above it); always the halo's dinv, 2 h values;
// in the cluster instance two buffers of every CTA's reduction partials;
// then the bytes: the band's mask (resident) and the halo's. Not resident,
// the operand is in device memory (CgArgs::work).
enum CgSlot { kDinv = 7, kX, kAp, kP0, kP1, kR };
struct CgLayout {
  int ext, hdinv, part, vals;
  __host__ __device__ CgLayout(int cap, int h, bool resident, bool cluster)
      : ext((cluster ? kR + 1 : kR) * cap),
        hdinv(resident ? ext + cap + 2 * h : 0), part(hdinv + 2 * h),
        vals(part + (cluster ? 2 * kMaxCluster * kMaxRed : 0)) {}
};

// The dynamic shared memory of a CTA in bytes: the layout's values, then
// the mask bytes.
template <typename T>
int cg_smem_bytes(int cap, int h, bool resident, bool cluster) {
  return CgLayout(cap, h, resident, cluster).vals * (int)sizeof(T) +
         (resident ? cap : 0) + 2 * h;
}

#ifdef CG_PHASES
// scripts/torch_cg_phases.py: thread 0 of the cluster's CTA 0 writes
// clock64() at the phase boundaries of iteration k (slot k * 16 + id) and
// around the cluster barrier of reduction q (slot 1024 + q * 4 + id) into
// the buffer the cluster instance is given as work (it needs none).
constexpr int kPhaseIters = 60, kPhaseReds = 120;
#define CG_PHASE(trace, ok, slot) \
  if ((trace) && threadIdx.x == 0 && (ok)) (trace)[slot] = clock64()
#else
#define CG_PHASE(trace, ok, slot) (void)0
#endif

template <typename T> struct CgArgs {
  const T* coef;
  const T* b;
  const unsigned char* bc;
  const T* diag;
  T* x;
  // grid: r, p_0, p_1 (N values each) and, not resident, dinv, Ap (N
  // each) and each CTA's operand (cap + 2 h)
  T* work;
  T* part;  // grid: the reduction partials (2 x ctas x kMaxRed)
  int n1x, n1y, maxiter;
  T rtol2;
  CgPlan plan;
};

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

// p_{k+1} = dinv r + beta p_k, each product and the sum rounded as
// cg_solve_plain rounds them (never contracted into an FMA), so that the
// owner of a node and the CTA that forms it at its halo get the same bits.
template <typename T>
__device__ __forceinline__ T p_next(T dinv, T r, T beta, T p) {
  return add_rn(mul_rn(dinv, r), mul_rn(beta, p));
}

// A field at the band's nodes: in shared memory (sm[m] for node n0 + m;
// kSm) or in device memory (g[n]).
template <typename T, bool kSm> struct Own {
  T* sm;
  T* g;
  int n0;
  __device__ __forceinline__ T operator[](int m) const {
    if constexpr (kSm)
      return sm[m];
    else
      return g[n0 + m];
  }
  __device__ __forceinline__ void set(int m, T v) const {
    if constexpr (kSm)
      sm[m] = v;
    else
      g[n0 + m] = v;
  }
};

// Plane k of the operator at node n0 + m: the band's copy in shared memory
// (kSm), else the read-only input.
template <typename T, bool kSm> struct CgPlanes {
  const T* sm;
  const T* coef;
  int cap, m, n, N;
  __device__ __forceinline__ T operator()(int k) const {
    if constexpr (kSm)
      return sm[k * cap + m];
    else
      return __ldg(coef + (size_t)k * N + n);
  }
};

// The cluster instance: rank, reduction and halo reads in distributed
// shared memory.
template <typename T> struct CgCluster {
  static constexpr bool kCluster = true;
  cg::cluster_group cl;
  BandShared<T>& sh;
  T* part;  // the partials: 2 buffers of kMaxCluster x kMaxRed, each CTA's
            // at the same offset
  int ctas;
  [[maybe_unused]] long long* trace;  // CG_PHASES: the probes' buffer
  unsigned red = 0;

  __device__ int rank() const { return (int)cl.block_rank(); }

  // a's value at node nn, index m of the band of CTA `owner`
  template <bool kSm>
  __device__ __forceinline__ T halo(const Own<T, kSm>& a, int owner, int m,
                                    int) const {
    return *cl.map_shared_rank(a.sm + m, owner);
  }

  // Op over the K values of every thread of the cluster, the same bits in
  // every thread and every run: shuffle trees into warp 0, whose lane l <
  // kWarps writes the CTA's partial into slot [rank] of the partials of
  // CTAs l, l + kWarps, ...; one cluster barrier; then every thread sums
  // the C partials in its own shared memory in rank order. Partials
  // alternate between two buffers, as in grid_all.
  template <typename Op, int K> __device__ void reduce(T (&v)[K]) {
    T* buf = part + (++red & 1) * kMaxCluster * kMaxRed;
    block_to_warp0<Op>(sh, v);
    if (threadIdx.x < kWarps) {
      for (int q = threadIdx.x; q < ctas; q += kWarps) {
        T* dst = cl.map_shared_rank(buf + rank() * kMaxRed, q);
#pragma unroll
        for (int k = 0; k < K; ++k) dst[k] = v[k];
      }
    }
    CG_PHASE(trace, rank() == 0 && red < kPhaseReds, 1024 + red * 4);
    cl.sync();
    CG_PHASE(trace, rank() == 0 && red < kPhaseReds, 1024 + red * 4 + 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T acc = buf[k];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q)
        if (q < ctas) acc = Op::apply(acc, buf[q * kMaxRed + k]);
      v[k] = acc;
    }
  }

  // No CTA leaves before every access to its shared memory is done.
  __device__ void finish() { cl.sync(); }
};

// The grid instance: rank, reduction and halo reads in device memory.
template <typename T> struct CgGrid {
  static constexpr bool kCluster = false;
  cg::grid_group grid;
  BandShared<T>& sh;
  T* part;
  int ctas;
  unsigned red = 0;

  __device__ int rank() const { return blockIdx.x; }

  // a's value at node nn, written in this launch by another CTA: from L2
  template <bool kSm>
  __device__ __forceinline__ T halo(const Own<T, kSm>& a, int, int,
                                    int nn) const {
    return __ldcg(a.g + nn);
  }

  template <typename Op, int K> __device__ void reduce(T (&v)[K]) {
    grid_all<Op>(grid, sh, part, ctas, red, v);
  }

  __device__ void finish() {}
};

// f(m), then g(m, f(m)), at this thread's nodes m of a band of nb nodes, U
// nodes a trip: the U nodes' f (loads and arithmetic) before any g (stores
// and sums), so that their loads are in flight together; g runs in node
// order. A band in device memory gives a thread tens of nodes (U = 4 or
// 8), one in shared memory a few (U = 1).
template <int U, typename F, typename G>
__device__ __forceinline__ void node_groups(int nb, F f, G g) {
  for (int m = threadIdx.x; m < nb; m += U * kBlock) {
    decltype(f(m)) v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = f(m + u * kBlock < nb ? m + u * kBlock : m);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (m + u * kBlock < nb) g(m + u * kBlock, v[u]);
  }
}

template <typename T> struct CgVals {
  T u, v;
};

// The solve on CTA rank() of the plan: x0 = where(bc, b, 0), r = b - A x0
// with the pinned A, p = z = dinv r; then while sum r^2 > rtol^2 sum b^2
// and k < maxiter, with cg_solve_plain's expressions:
//   (1) p_k (k > 0) at the band and its halo; Ap_k, pap = sum p Ap
//       -> barrier 1;
//   (2) alpha = rz / pap; x += alpha p; r -= alpha Ap; rz', rr
//       -> barrier 2; beta = rz' / rz.
template <typename T, typename Inst, bool kRes>
__device__ void cg_body(const CgArgs<T>& A, Inst& in,
                        unsigned char* smem) {
  const int n1y = A.n1y, N = A.n1x * n1y, h = n1y + 1;
  const int C = A.plan.ctas, cap = A.plan.cap, c = in.rank();
  const int n0 = band_start(0, N, C, c), n1 = band_start(0, N, C, c + 1);
  const int nb = n1 - n0;
  const int lo0 = c > 0 ? band_start(0, N, C, c - 1) : 0;
  const GridShape g = GridShape::whole(A.n1x, n1y);
  const CgLayout lay(cap, h, kRes, Inst::kCluster);
  // nodes a thread keeps in flight (node_groups): a few in shared memory,
  // many in device memory: eight in f64; four in f32, where eight read
  // slower
  constexpr int kU = kRes ? 1 : sizeof(T) == 8 ? 8 : 4;
  T* sv = reinterpret_cast<T*>(smem);
  unsigned char* sb = smem + (size_t)lay.vals * sizeof(T);
  T* w = Inst::kCluster ? nullptr : A.work;
  [[maybe_unused]] long long* const trace =
      Inst::kCluster ? reinterpret_cast<long long*>(A.work) : nullptr;
  auto field = [&](int f) { return w ? w + (size_t)f * N : nullptr; };
  auto own = [&](int slot, T* dev) {
    return Own<T, kRes>{kRes ? sv + (size_t)slot * cap : nullptr, dev, n0};
  };
  const Own<T, kRes> dinv = own(kDinv, kRes ? nullptr : field(3)),
                     x = own(kX, A.x),
                     ap = own(kAp, kRes ? nullptr : field(4));
  const Own<T, kRes> p0 = own(kP0, field(1)), p1 = own(kP1, field(2));
  const Own<T, Inst::kCluster> r{
      Inst::kCluster ? sv + (size_t)kR * cap : nullptr, field(0), n0};
  // the grid instance's resident p is also written to device memory, where
  // the neighbours read it
  T* const pub0 = kRes ? field(1) : nullptr;
  T* const pub1 = kRes ? field(2) : nullptr;
  const T* planes = kRes ? sv : nullptr;
  const unsigned char* mask = kRes ? sb : A.bc + n0;
  // where(bc, 0, p_k) at node nn: ext[nn - n0 + h]
  T* ext = kRes ? sv + lay.ext
               : field(5) + (size_t)c * (cap + 2 * h);
  T* hdinv = sv + lay.hdinv;
  unsigned char* hmask = sb + (kRes ? cap : 0);

  // halo slot e: node n0 - h + e below the band (e < h), n1 + e - h above
  auto halo_node = [&](int e) { return e < h ? n0 - h + e : n1 + e - h; };
  auto in_grid = [&](int nn) { return nn >= 0 && nn < N; };

  T acc[3] = {T(0), T(0), T(0)};  // rz, rr, bb
  for (int m = threadIdx.x; m < nb; m += kBlock) {
    const int n = n0 + m;
    const bool bcn = A.bc[n] != 0;
    const T bn = A.b[n];
    const T dn = T(1) / (bcn ? T(1) : A.diag[n]);
    if (kRes) {
#pragma unroll
      for (int k = 0; k < 7; ++k) sv[k * cap + m] = A.coef[(size_t)k * N + n];
      sb[m] = bcn;
    }
    dinv.set(m, dn);
    x.set(m, bcn ? bn : T(0));
    // A x0 is b on bc rows and 0 elsewhere (bc columns are zeroed)
    const T rn = bcn ? bn - bn : bn;
    const T zn = dn * rn;
    r.set(m, rn);
    p0.set(m, zn);
    if (pub0) pub0[n] = zn;
    acc[0] += rn * zn;
    acc[1] += rn * rn;
    acc[2] += bn * bn;
  }
  for (int e = threadIdx.x; e < 2 * h; e += kBlock) {
    const int nn = halo_node(e);
    if (!in_grid(nn)) continue;
    const bool bcn = A.bc[nn] != 0;
    hmask[e] = bcn;
    hdinv[e] = T(1) / (bcn ? T(1) : A.diag[nn]);
  }
  in.template reduce<SumOp>(acc);
  T rz = acc[0], rr = acc[1], beta = T(0);
  const T tol2 = A.rtol2 * acc[2];
  for (int k = 0; rr > tol2 && k < A.maxiter; ++k) {
    CG_PHASE(trace, c == 0 && k < kPhaseIters, k * 16);
    const bool odd = k & 1;
    const Own<T, kRes> ps = odd ? p1 : p0, po = odd ? p0 : p1;
    T* const out = odd ? pub1 : pub0;
    node_groups<kU>(
        nb,
        [&](int m) {
          return k > 0 ? p_next(dinv[m], r[m], beta, po[m]) : ps[m];
        },
        [&](int m, T v) {
          if (k > 0) {
            ps.set(m, v);
            if (out) out[n0 + m] = v;
          }
          ext[h + m] = mask[m] ? T(0) : v;
        });
    CG_PHASE(trace, c == 0 && k < kPhaseIters, k * 16 + 1);
    for (int e = threadIdx.x; e < 2 * h; e += kBlock) {
      const int nn = halo_node(e);
      if (!in_grid(nn)) continue;
      const int owner = e < h ? c - 1 : c + 1;
      const int mo = nn - (e < h ? lo0 : n1);
      const T v = k == 0 ? in.halo(ps, owner, mo, nn)
                         : p_next(hdinv[e], in.halo(r, owner, mo, nn), beta,
                                  in.halo(po, owner, mo, nn));
      ext[e < h ? e : nb + e] = hmask[e] ? T(0) : v;
    }
    CG_PHASE(trace, c == 0 && k < kPhaseIters, k * 16 + 2);
    __syncthreads();
    CG_PHASE(trace, c == 0 && k < kPhaseIters, k * 16 + 3);
    T pap[1] = {T(0)};
    node_groups<kU>(
        nb,
        [&](int m) {
          const int n = n0 + m, i = n / n1y, j = n - i * n1y;
          // own p; with eight nodes in flight read from the operand, in
          // cache from the stencil's centre term (the same bits off the
          // frame), so that one field fewer streams from memory
          const T pn = kU == 8 && !mask[m] ? ext[h + m] : ps[m];
          const T a = stencil_apply(
              CgPlanes<T, kRes>{planes, A.coef, cap, m, n, N}, g, i, j,
              [&](int ii, int jj) { return ext[ii * n1y + jj - n0 + h]; });
          // the pinned operator: rows and columns of bc nodes the identity
          return CgVals<T>{pn, mask[m] ? pn : a};
        },
        [&](int m, CgVals<T> pa) {
          ap.set(m, pa.v);
          pap[0] += pa.u * pa.v;
        });
    CG_PHASE(trace, c == 0 && k < kPhaseIters, k * 16 + 4);
    in.template reduce<SumOp>(pap);
    CG_PHASE(trace, c == 0 && k < kPhaseIters, k * 16 + 5);
    const T alpha = rz / pap[0];
    T acc2[2] = {T(0), T(0)};  // rz', rr
    node_groups<kU>(
        nb,
        [&](int m) {
          return CgVals<T>{x[m] + alpha * ps[m], r[m] - alpha * ap[m]};
        },
        [&](int m, CgVals<T> xr) {
          x.set(m, xr.u);
          r.set(m, xr.v);
          acc2[0] += xr.v * (dinv[m] * xr.v);
          acc2[1] += xr.v * xr.v;
        });
    CG_PHASE(trace, c == 0 && k < kPhaseIters, k * 16 + 6);
    in.template reduce<SumOp>(acc2);
    CG_PHASE(trace, c == 0 && k < kPhaseIters, k * 16 + 7);
    beta = acc2[0] / rz;
    rz = acc2[0];
    rr = acc2[1];
    CG_PHASE(trace, c == 0 && k < kPhaseIters, k * 16 + 8);
  }
  if (kRes) {
    for (int m = threadIdx.x; m < nb; m += kBlock) A.x[n0 + m] = x.sm[m];
  }
  in.finish();
}

// Bounds of (kBlock, 1) and (kBlock, 2): one CTA per SM, two for the grid
// instance's bands in device memory. ptxas then does not hold the
// registers down for more resident blocks (without a bound it gave the
// grid instance 80 and spilled), and two grid CTAs always fit on an SM.
template <typename T>
__global__ void __launch_bounds__(kBlock, 1) cg_cluster_kernel(CgArgs<T> A) {
  extern __shared__ __align__(16) unsigned char cg_smem[];
  __shared__ BandShared<T> sh;
  const CgLayout lay(A.plan.cap, A.n1y + 1, true, true);
  CgCluster<T> in{cg::this_cluster(), sh,
                  reinterpret_cast<T*>(cg_smem) + lay.part, A.plan.ctas,
                  reinterpret_cast<long long*>(A.work)};
  // every CTA of the cluster has started before one writes another's
  // shared memory
  in.cl.sync();
  cg_body<T, CgCluster<T>, true>(A, in, cg_smem);
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 2) cg_grid_kernel(CgArgs<T> A) {
  extern __shared__ __align__(16) unsigned char cg_smem[];
  __shared__ BandShared<T> sh;
  CgGrid<T> in{cg::this_grid(), sh, A.part, A.plan.ctas};
  if (A.plan.resident)
    cg_body<T, CgGrid<T>, true>(A, in, cg_smem);
  else
    cg_body<T, CgGrid<T>, false>(A, in, cg_smem);
}

// The launch configuration of the cluster instance: one cluster of ctas
// CTAs, its attributes set on the kernel (dynamic shared memory; a cluster
// of more than 8 CTAs is non-portable).
template <typename T>
cudaError_t cluster_config(int ctas, int smem, void* stream,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  const void* kernel = (const void*)cg_cluster_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && ctas > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return e;
}

// How many clusters of the cluster instance of ctas bands of an (n1x, n1y)
// grid the card can place at once (0: none, and the launch would be
// refused).
template <typename T>
int cg_cluster_occupancy(int n1x, int n1y, int ctas, int* out) {
  if (ctas < 1 || ctas > kMaxCluster) return (int)cudaErrorInvalidValue;
  const int smem = cg_smem_bytes<T>((n1x * n1y + ctas - 1) / ctas,
                                    n1y + 1, true, true);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config<T>(ctas, smem, nullptr, cfg, attr);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(out, (const void*)cg_cluster_kernel<T>,
                                       &cfg);
  return (int)e;
}

template <typename T>
int stencil_matvec(const void* coef, const void* x, void* y, int n1x,
                   int n1y, void* stream) {
  GridShape g = GridShape::whole(n1x, n1y);
  const int n = n1x * n1y;
  stencil_matvec_kernel<T><<<(n + kBlock - 1) / kBlock, kBlock, 0,
                             (cudaStream_t)stream>>>(
      (const T*)coef, (const T*)x, (T*)y, g);
  return (int)cudaGetLastError();
}

// The band of a CTA and its shared memory follow from the grid, ctas and
// the instance alone: a plan cannot promise what the layout does not hold.
template <typename T>
int cg_solve(const void* coef, const void* b, const void* bc,
             const void* diag, void* x, void* work, void* part, int n1x,
             int n1y, double rtol, int maxiter, int cluster, int ctas,
             int resident, void* stream) {
  const int N = n1x * n1y;
  // bands of at least n1y + 1 nodes each (one band: any)
  if (ctas < 1 || ctas > kBlock || (ctas > 1 && N / ctas < n1y + 1) ||
      (cluster && ctas > kMaxCluster))
    return (int)cudaErrorInvalidValue;
  const int res = cluster || resident, cap = (N + ctas - 1) / ctas;
  const int smem = cg_smem_bytes<T>(cap, n1y + 1, res, cluster);
  // rtol * rtol in f64, cast once, as the JAX kernel's rtol**2 * sum(b*b)
  CgArgs<T> A{(const T*)coef, (const T*)b, (const unsigned char*)bc,
              (const T*)diag, (T*)x, (T*)work, (T*)part, n1x, n1y, maxiter,
              (T)(rtol * rtol), CgPlan{ctas, res, cap}};
  if (!cluster) return launch_resident(cg_grid_kernel<T>, A, ctas, smem,
                                       stream);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config<T>(ctas, smem, stream, cfg, attr);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, cg_cluster_kernel<T>, A);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace cft

extern "C" {

int cft_stencil_matvec_f32(const void* coef, const void* x, void* y,
                           int n1x, int n1y, void* stream) {
  return cft::stencil_matvec<float>(coef, x, y, n1x, n1y, stream);
}
int cft_stencil_matvec_f64(const void* coef, const void* x, void* y,
                           int n1x, int n1y, void* stream) {
  return cft::stencil_matvec<double>(coef, x, y, n1x, n1y, stream);
}
int cft_cg_solve_f32(const void* coef, const void* b, const void* bc,
                     const void* diag, void* x, void* work, void* part,
                     int n1x, int n1y, double rtol, int maxiter, int cluster,
                     int ctas, int resident, void* stream) {
  return cft::cg_solve<float>(coef, b, bc, diag, x, work, part, n1x, n1y,
                              rtol, maxiter, cluster, ctas, resident,
                              stream);
}
int cft_cg_solve_f64(const void* coef, const void* b, const void* bc,
                     const void* diag, void* x, void* work, void* part,
                     int n1x, int n1y, double rtol, int maxiter, int cluster,
                     int ctas, int resident, void* stream) {
  return cft::cg_solve<double>(coef, b, bc, diag, x, work, part, n1x, n1y,
                               rtol, maxiter, cluster, ctas, resident,
                               stream);
}
int cft_cg_cluster_occupancy_f32(int n1x, int n1y, int ctas, int* out) {
  return cft::cg_cluster_occupancy<float>(n1x, n1y, ctas, out);
}
int cft_cg_cluster_occupancy_f64(int n1x, int n1y, int ctas, int* out) {
  return cft::cg_cluster_occupancy<double>(n1x, n1y, ctas, out);
}
// An empty kernel of one warp: the launch floor beside stencil_matvec's
// readings on a CUDA graph.
int cft_empty_launch(void* stream) {
  cft::empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
