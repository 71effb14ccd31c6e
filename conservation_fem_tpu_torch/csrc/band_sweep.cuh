// The resident-band sweep of the single and block step kernels
// (fused_step.cu, block_step.cu): BandSweep, a sweep policy of StepPhases
// (fused_step.cuh), with its own barrier and reduction, and the launch of a
// kernel that runs it. The band plan comes from ops/fused_step.band_plan,
// which mirrors band_start, QuadCells and the shared-memory layout here.
//
// What bounds those kernels on the H100: a step is a chain of ~40-80
// dependent passes over a grid that lives in the 50 MB L2, so the cost of
// a pass is its barrier, its reduction and its dependent L2 round trips,
// plus the quadrature of the passes that evaluate N(u) or the
// flux-Jacobian planes (KPP: sincos at 6 points of each triangle). The
// design, element by element (BandDesign; each one can be left out of an
// instance, so its share is measured on its own):
//   * bands resident on the SM: CTA b owns the nodes [band_start(b),
//     band_start(b + 1)) of the grid's rows for the whole launch, one CTA
//     per SM. A band holds at least n1y + 1 nodes, so whatever a pass
//     reads at neighbours (one row and one node away) lies in the bands
//     b - 1 and b + 1. The operator planes a pass reads at the node stay
//     in shared memory (kStagePlanes): the mass planes for the whole
//     launch, the eps-stiffness and Jacobian planes from the pass that
//     writes them on (StepPhases::stage), as many as the plan fits. A pass
//     ends in grid.sync();
//   * reductions by warp shuffles (kShflReduce; grid_all of stencil.cuh,
//     which cg_solve's grid instance runs too): every warp combines its
//     K values with an xor butterfly (every lane ends with the same bits),
//     warp 0 combines the 8 warps' values and thread 0 writes the block's
//     partial into one of two alternating buffers; after one grid.sync()
//     thread c reads CTA c's partial, and the same two butterflies combine
//     them: the same result in every thread and in every run, with no
//     8-level block tree of __syncthreads() before or after the grid
//     barrier;
//   * quadrature once per triangle (kTriQuad): a pass that evaluates N(x)
//     or the flux-Jacobian planes first tabulates, for the cells its nodes
//     touch, the 3 (N) or 9 (planes) values of each triangle in shared
//     memory, then each node gathers its six triangles in the order of
//     nl_rhs_node / conv_planes_node; the per-triangle value is the same
//     expression as theirs. The value the quadrature reads is first copied
//     to shared memory at every node the cells touch (the band and its
//     halo), with all of a thread's loads issued before it stores, so a
//     pass waits for one round of loads, not one per triangle; the body
//     then reads that value from there too. A band is tabulated in chunks
//     of plan.chunk nodes (the whole band when it fits): only the cells on
//     a chunk's edge are evaluated twice.
// Neighbour-only barriers (pass counters raised with release stores and
// polled with acquire loads) and reductions over epoch-tagged partials
// with no grid barrier were measured too and left out (PERF.md §5).
#pragma once

#include "fused_step.cuh"

namespace cft {

enum BandDesign {
  kStagePlanes = 1,  // operator planes of the band in shared memory
  kShflReduce = 2,   // warp-shuffle reductions (else GridReducer)
  kTriQuad = 4,      // quadrature once per triangle (else at every node)
  kBandAll = 7
};

// The band plan: ctas bands, the operators staged (0, 1: mass, 3: mass,
// eps-stiffness, Jacobian), the nodes per quadrature chunk, the largest
// band (the stride of a staged plane) and the dynamic shared memory.
struct BandPlan {
  int ctas, staged, chunk, cap, smem;
};

// The cells whose triangles the nodes [c0, c1) read, by linear index
// (lower-left node, ci * n1y + cj): [a0, a1), the row below the nodes, and
// [b0, c1), their own row; b0 = max(c0 - 1, a1), so the two never overlap.
// Cells outside the grid are in the ranges but never tabulated or read.
struct QuadCells {
  int a0, a1, b0, na;
  __host__ __device__ QuadCells(int c0, int c1, int n1y)
      : a0(c0 - n1y - 1), a1(c1 - n1y),
        b0(c0 - 1 > c1 - n1y ? c0 - 1 : c1 - n1y), na(c1 - n1y - a0) {}
  __host__ __device__ int count(int c1) const { return na + c1 - b0; }
  __host__ __device__ int slot(int L) const {
    return L < a1 ? L - a0 : na + (L - b0);
  }
  __host__ __device__ int cell(int slot) const {
    return slot < na ? a0 + slot : b0 + (slot - na);
  }
};
constexpr int kQuadValues = 9;  // per triangle: the planes' 3 x 3

// Cells a chunk of `chunk` nodes tabulates at most. After the table,
// BandSweep::fetch keeps the value the cells read at chunk + 2 n1y + 2
// nodes (the chunk and n1y + 1 on either side).
__host__ __device__ inline int quad_cells(int chunk, int n1y) {
  return 2 * chunk + 2 < chunk + 1 + n1y ? 2 * chunk + 2 : chunk + 1 + n1y;
}

// A stage value of a band sweep, formed from device memory where it is
// read; tab: its quadrature per triangle (kind kQuadNl or kQuadConv) when
// the sweep tabulated it, else null, and xs its values at the nodes x0, x0
// + 1, ... in shared memory.
template <typename T, int NS, typename Stage> struct BandField {
  const Stage* stage;
  const T* const* f;
  int n1y, s;
  const T* tab;
  int kind;
  QuadCells qc;
  const T* xs;
  int x0;
  __device__ __forceinline__ T operator()(int i, int j) const {
    if (xs) return xs[i * n1y + j - x0];
    T v[NS];
    (*stage)(i, j, GlobalAt<T>{f, i * n1y + j}, v);
    return v[s];
  }
  // the tabulated values of triangle t of cell (ci, cj)
  __device__ __forceinline__ const T* tri(int ci, int cj, int t,
                                          int values) const {
    return tab + (qc.slot(ci * n1y + cj) * 2 + t) * values;
  }
};
template <typename T, int NS, typename Stage> struct BandFormed {
  const Stage* stage;
  const T* const* f;
  int n1y;
  const T* tab;
  int tab_stage, kind;
  QuadCells qc;
  const T* xs;
  int x0;
  __device__ __forceinline__ BandField<T, NS, Stage> operator[](int s) const {
    const bool own = s == tab_stage;
    return BandField<T, NS, Stage>{stage, f, n1y, s, own ? tab : nullptr,
                                   kind, qc, own ? xs : nullptr, x0};
  }
};

// N(x) at (i, j) from the table: the six triangles in nl_rhs_node's order.
template <typename Fl, typename T, int NS, typename Stage>
__device__ T nl_rhs_node(const StepConsts<T>& C, GridShape g, int i, int j,
                         BandField<T, NS, Stage> x) {
  if (!x.tab || x.kind != kQuadNl)
    return nl_rhs_node<Fl>(C, g, i, j,
                           [x](int ii, int jj) { return x(ii, jj); });
  T out = T(0);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int ci = i - corner_i(t, a), cj = j - corner_j(t, a);
      if (!g.cell(ci, cj)) continue;
      out += C.two_area * x.tri(ci, cj, t, 3)[a];
    }
  }
  return out;
}

// The flux-Jacobian planes at (i, j) from the table (conv_planes_node's
// order).
template <typename Fl, typename T, int NS, typename Stage>
__device__ void conv_planes_node(const StepConsts<T>& C, GridShape g, int i,
                                 int j, BandField<T, NS, Stage> x,
                                 T (&pl)[7]) {
  if (!x.tab || x.kind != kQuadConv) {
    conv_planes_node<Fl>(C, g, i, j,
                         [x](int ii, int jj) { return x(ii, jj); }, pl);
    return;
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) pl[k] = T(0);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int ci = i - corner_i(t, a), cj = j - corner_j(t, a);
      if (!g.cell(ci, cj)) continue;
      const T* row = x.tri(ci, cj, t, kQuadValues) + 3 * a;
#pragma unroll
      for (int b = 0; b < 3; ++b)
        pl[pair_plane(t, a, b)] += C.two_area * row[b];
    }
  }
}

// Tabulate the quadrature of kind K of x on the cells qc.cell(0 ..
// cells): entry (slot, t) holds, for each corner a of triangle t, the sum
// over the quadrature points that nl_rhs_node (3 values) or
// conv_planes_node (3 x 3 values, by corner pair a, b) forms for that
// triangle at corner a, before the factor 2A.
template <typename Fl, int K, typename T, typename X>
__device__ void tabulate(const StepConsts<T>& C, GridShape g, QuadCells qc,
                         int cells, X x, T* tab) {
  const int N = g.size();
  for (int q = threadIdx.x; q < 2 * cells; q += kBlock) {
    const int L = qc.cell(q >> 1), t = q & 1;
    if (L < 0 || L >= N) continue;
    const int ci = L / g.n1y, cj = L - ci * g.n1y;
    T c[3], gux, guy;
    if (!cell_load(C, g, t, ci, cj, x, c, gux, guy)) continue;
    if constexpr (K == kQuadNl) {
      T val[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int qp = 0; qp < 6; ++qp) {
        T fx, fy;
        Fl::fp(quad_value(C, qp, c), fx, fy);
#pragma unroll
        for (int a = 0; a < 3; ++a)
          val[a] += C.W[qp][a] * (fx * gux + fy * guy);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) tab[q * 3 + a] = val[a];
    } else {
      T row[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) row[a][b] = T(0);
#pragma unroll
      for (int qp = 0; qp < 6; ++qp) {
        T fx, fy, dfx, dfy;
        Fl::fp_fpp(quad_value(C, qp, c), fx, fy, dfx, dfy);
        const T fg = dfx * gux + dfy * guy;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            row[a][b] += C.W[qp][a] * (fg * C.PHI[qp][b] +
                                       fx * C.G[t][b][0] +
                                       fy * C.G[t][b][1]);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          tab[q * kQuadValues + 3 * a + b] = row[a][b];
    }
  }
}

// Plane k of an operator at node n: from the band's shared-memory copy
// (sm, node m = n - band start) when the operator is staged, else from
// device memory through L2 (ld.global.cg: the eps-stiffness and Jacobian
// planes are written in the launch). Two loads under a branch that is the
// same in every thread, not one load through a pointer that may point to
// either memory (generic addressing): with that one load the single
// kernel ran 12% slower at mesh 256, where nothing is staged, than its
// instance without staging, and its f64 instances spilled (PERF.md §6).
template <typename T> struct BandPlanesAt {
  const T* sm;
  const T* g;
  int m, cap, n, N;
  __device__ __forceinline__ T operator()(int k) const {
    return sm ? sm[k * cap + m] : __ldcg(g + (size_t)k * N + n);
  }
};
// The operators of a pass at node n; stg[p]: operator p's staged copy or
// null, worked out once per pass.
template <typename T> struct BandOps {
  const T* const* op;
  const T* const* stg;
  int n, N, m, cap;
  __device__ __forceinline__ BandPlanesAt<T> operator[](int p) const {
    return BandPlanesAt<T>{stg[p], op[p], m, cap, n, N};
  }
};

template <typename T, typename Fl, int D> struct BandSweep {
  static constexpr bool kOwnReduce = (D & kShflReduce) != 0;
  static constexpr bool kStages = (D & kStagePlanes) != 0;
  static constexpr bool kTri = (D & kTriQuad) != 0;
  const StepConsts<T>& C;
  GridShape g;
  BandPlan plan;
  int n0, n1;
  T* sm;    // staged planes: slot s, plane k at sm + (7 s + k) cap
  T* tab;   // the quadrature table, after the staged planes
  T* xs;    // the quadrature's value at the chunk's nodes, after the table
  T* part;      // reduction partials, 2 buffers of kMaxRed per CTA
  BandShared<T>& sh;
  cg::grid_group& grid;
  const T *st0 = nullptr, *st1 = nullptr, *st2 = nullptr;
  unsigned red = 0;

  __device__ BandSweep(const StepConsts<T>& C_, GridShape g_, BandPlan plan_,
                       T* smem, T* part_, BandShared<T>& sh_,
                       cg::grid_group& grid_)
      : C(C_), g(g_), plan(plan_),
        n0(band_start(g_.n_lo(), g_.n_hi(), plan_.ctas, blockIdx.x)),
        n1(band_start(g_.n_lo(), g_.n_hi(), plan_.ctas, blockIdx.x + 1)),
        sm(smem), tab(smem + (size_t)plan_.staged * 7 * plan_.cap),
        xs(tab + (size_t)2 * kQuadValues * quad_cells(plan_.chunk, g_.n1y)),
        part(part_), sh(sh_), grid(grid_) {}

  // Copy this band's planes of operator op into slot `slot` (if the plan
  // stages that many); op's planes at these nodes were written by this CTA
  // or are inputs.
  __device__ void stage(int slot, const T* op) {
    if (slot >= plan.staged) return;
    const int nb = n1 - n0, N = g.size();
    T* dst = sm + (size_t)slot * 7 * plan.cap;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      for (int m = threadIdx.x; m < nb; m += kBlock)
        dst[k * plan.cap + m] = op[(size_t)k * N + n0 + m];
    if (slot == 0) st0 = op;
    if (slot == 1) st1 = op;
    if (slot == 2) st2 = op;
    __syncthreads();
  }

  template <int NS, typename Q = NoQuad, typename R, typename Stage,
            typename Body>
  __device__ void run(const R& in, Stage stage_fn, Body body) {
    constexpr bool tabled = kTri && Q::kKind != kQuadNone;
    const int n1y = g.n1y, N = g.size();
    const int ns = kStages ? plan.staged : 0;
    // a pass without a table visits the whole band at once
    const int chunk = tabled ? plan.chunk : n1 - n0;
    for (int c0 = n0; c0 < n1; c0 += chunk) {
      const int c1 = c0 + chunk < n1 ? c0 + chunk : n1;
      const QuadCells qc(c0, c1, n1y);
      if constexpr (tabled) {
        const FormedField<T, NS, Stage> x{&stage_fn, in.f, n1y, Q::kStage};
        fetch(x, qc.a0, c1 + n1y + 1);
        tabulate<Fl, Q::kKind>(C, g, qc, qc.count(c1),
                               [&](int i, int j) {
                                 return xs[i * n1y + j - qc.a0];
                               },
                               tab);
        __syncthreads();
      }
      const BandFormed<T, NS, Stage> st{&stage_fn, in.f, n1y,
                                        tabled ? tab : nullptr, Q::kStage,
                                        Q::kKind, qc,
                                        tabled ? xs : nullptr, qc.a0};
      constexpr int P = R::kOps > 0 ? R::kOps : 1;
      const T* stg[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T* o = in.op[p];
        stg[p] = ns > 0 && o == st0   ? sm
                 : ns > 1 && o == st1 ? sm + 7 * plan.cap
                 : ns > 2 && o == st2 ? sm + 14 * plan.cap
                                      : nullptr;
      }
      for (int n = c0 + threadIdx.x; n < c1; n += kBlock) {
        const int i = n / n1y;
        body(i, n - i * n1y, n, st, GlobalAt<T>{in.f, n},
             BandOps<T>{in.op, stg, n, N, n - n0, plan.cap});
      }
      if constexpr (tabled) {
        if (c1 < n1) __syncthreads();  // the next chunk rewrites the table
      }
    }
  }

  // x at the nodes [x0, x1) of the grid's rows into xs (xs[n - x0]), each
  // thread's loads issued before its stores; then a barrier of the block.
  template <typename X> __device__ void fetch(X x, int x0, int x1) {
    constexpr int kR = 4;
    const int lo = x0 > g.n_lo() ? x0 : g.n_lo();
    const int hi = x1 < g.n_hi() ? x1 : g.n_hi();
    for (int base = lo; base < hi; base += kR * kBlock) {
      T v[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int n = base + r * kBlock + threadIdx.x;
        const int i = n / g.n1y;
        v[r] = n < hi ? x(i, n - i * g.n1y) : T(0);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int n = base + r * kBlock + threadIdx.x;
        if (n < hi) xs[n - x0] = v[r];
      }
    }
    __syncthreads();
  }

  // Grid-wide Op over the K values of every thread, the same bits in every
  // thread and every run (the order depends on the plan alone).
  template <typename Op, int K> __device__ void reduce(T (&v)[K]) {
    grid_all<Op>(grid, sh, part, plan.ctas, red, v);
  }
};

// This thread's nodes of a band sweep: its band, kBlock apart.
template <typename T, typename Fl, int D>
__device__ __forceinline__ void node_range(const BandSweep<T, Fl, D>& s,
                                           GridShape, int& first, int& last,
                                           int& stride) {
  first = s.n0 + threadIdx.x;
  last = s.n1;
  stride = kBlock;
}

// One cooperative launch of a band kernel on the plan: plan.ctas blocks,
// plan.smem bytes of dynamic shared memory each; refused (an error code)
// when the card cannot hold every block at once.
template <typename Params>
int launch_bands(void (*kernel)(Params), Params& P, const BandPlan& plan,
                 void* stream) {
  if (plan.ctas < 1 || plan.ctas > kBlock || plan.chunk < 1)
    return (int)cudaErrorInvalidValue;
  return launch_resident(kernel, P, plan.ctas, plan.smem, stream);
}

}  // namespace cft
