// Device phases of the stabilised RV time step of a scalar conservation
// law u_t + div f(u) = 0 (KPP, Burgers), shared by the step
// kernels: the single cooperative step (fused_step.cu), the split setup
// and Newton kernels (split_step.cu), the block kernel (block_step.cu) and
// the tiled step (tiled_step.cu).
//
// Two levels:
//   * node functions (nl_rhs_node, conv_planes_node, keps_planes_node,
//     rv_eps_node, residual_node, pinned_apply, jacobian_node) compute one
//     node's value from field accessors x(i, j) and operator accessors
//     a(k), so the same arithmetic reads device memory or shared memory
//     in the band kernels and a staged shared-memory tile in the tiled
//     ones (band_sweep.cuh adds overloads of nl_rhs_node and
//     conv_planes_node that gather a triangle table);
//   * StepPhases, the grid-wide phases of every step kernel (a barrier
//     between phases, deterministic reductions): residual projection with
//     its mass solve, RV epsilon,
//     eps-stiffness planes, Newton linearisation, the fixed BiCGStab or
//     Chebyshev inner solve and the update with its residual. A phase
//     that reads values at neighbours runs as a sweep over a sweep
//     policy, and declares the raw fields and operators it reads (Reads):
//     TileSweep (tile_sweep.cuh; the tiled and split kernels) copies them
//     into shared memory tile by tile, the next tile while this one
//     computes, and BandSweep (band_sweep.cuh; the single and block
//     kernels) keeps one band of nodes on each SM, with its operator
//     planes and its quadrature in shared memory. A phase ends with
//     grid.sync(); TileSweep reduces with GridReducer (stencil.cuh),
//     BandSweep with its own shuffle trees (kOwnReduce).
// The flux is compiled in, a template parameter Fl of the node functions
// and of StepPhases (the JAX kernels take it as the functions fpx, fpy of
// _make_lib): Kpp and Burgers below. Each source of a step kernel builds
// one instance per flux, the Burgers one in a translation unit of its own
// (*_burgers.cu), so that the sources compile in parallel.
#pragma once

#include "stencil.cuh"

// The flux of the instance a step kernel's source builds: KPP, unless a
// flux's own source (block_step_burgers.cu, ...) sets CFT_FLUX and
// CFT_ENTRY and then includes the kernel's source. CFT_ENTRY(name, dt)
// names the instance's C entry points.
#ifndef CFT_FLUX
#define CFT_FLUX Kpp
#define CFT_ENTRY(name, dt) cft_##name##_##dt
#endif

namespace cft {

// Layout of the f64 constant table the wrappers build
// (ops/fused_step._step_constants).
enum ConstIdx {
  K_DT = 0, K_TWO_DT, K_HALF_DT, K_TWO_AREA, K_CVEL_H, K_CRV_HH, K_TINY,
  K_M_THETA, K_M_DELTA, K_M_TWO_SIGMA, K_M_RHO0,
  K_L_THETA, K_L_DELTA, K_L_TWO_SIGMA, K_L_RHO0,
  K_G = 15,       // grads (2,3,2)
  K_PHI = 27,     // phi (6,3)
  K_W = 45,       // qw[q] * phi[q,a] (6,3)
  K_GGA = 63,     // area * grads.grads (2,3,3)
  K_COUNT = 81
};

// Work fields of the step kernels (each n1x * n1y), allocated by the
// wrappers (ops/fused_step.N_WORK_FIELDS).
enum Field {
  NUN = 0, KUN, EPS, CX, CR, CD0, CD1, P2, V2, DJ, FR, BS, BT, RHAT, UK2,
  KC, JC = KC + 7, N_FIELDS = JC + 7
};

// Plane storage of the solver sweeps (StepPhases' PT): the kernel's own
// type, or a 2-byte one, __nv_bfloat16, in the tiled kernel's bf16-plane
// instance (pallas_tiled.tiled_rv_step bf16_planes; tiled_step.cu includes
// cuda_bf16.h for that unit alone). A bf16 plane is read as T
// (plane_value: the type's conversion to float) and written rounded to
// nearest even (to_plane: its constructor from float, __float2bfloat16);
// every operation on it is in T. Its rows take plane_pitch values, n1y
// rounded up to even, so that a pair of columns from an even one is an
// aligned 4-byte copy (tile_sweep.cuh; ops/tiled_step.plane_pitch).
template <typename PT> constexpr bool kHalfPlanes = sizeof(PT) == 2;
template <typename PT> __host__ __device__ inline int plane_pitch(int n1y) {
  return kHalfPlanes<PT> ? n1y + (n1y & 1) : n1y;
}
template <typename T, typename PT>
__device__ __forceinline__ T plane_value(PT v) {
  return static_cast<T>(v);
}
template <typename PT, typename T> __device__ __forceinline__ PT to_plane(T v) {
  return static_cast<PT>(v);
}

template <typename T> struct StepConsts {
  T G[2][3][2], PHI[6][3], W[6][3], GGA[2][3][3];
  T dt, two_dt, half_dt, two_area, cvel_h, crv_hh, tiny;
  T m_theta, m_delta, m_two_sigma, m_rho0;
  T l_theta, l_delta, l_two_sigma, l_rho0;
};

__device__ __forceinline__ void sin_cos(float u, float* s, float* c) {
  sincosf(u, s, c);
}
__device__ __forceinline__ void sin_cos(double u, double* s, double* c) {
  sincos(u, s, c);
}

// A flux policy: fp(u, fx, fy) sets f'(u) = (fx, fy), fp_fpp(u, fx, fy,
// dfx, dfy) sets f'(u) and f''(u), and beta(amax) is the RV speed of a
// patch, the patch max of |f'(u)| (structured.rv_epsilon's beta), from the
// patch max of |u| when kAbsMax asks for it.
//
// KPP: f = (sin u, cos u), f' = (cos u, -sin u), f'' = (-sin u, -cos u),
// |f'| = 1, so beta is 1 and no patch max of |u| is taken. sincos is the
// accurate libdevice one (no fast-math): quadrature arguments reach
// 14 pi / 4; fp_fpp takes one sincos for both derivatives.
struct Kpp {
  static constexpr bool kAbsMax = false;
  template <typename T>
  __device__ static __forceinline__ void fp(T u, T& fx, T& fy) {
    T s, c;
    sin_cos(u, &s, &c);
    fx = c;
    fy = -s;
  }
  template <typename T>
  __device__ static __forceinline__ void fp_fpp(T u, T& fx, T& fy, T& dfx,
                                                T& dfy) {
    T s, c;
    sin_cos(u, &s, &c);
    fx = c;
    fy = -s;
    dfx = -s;
    dfy = -c;
  }
  template <typename T> __device__ static __forceinline__ T beta(T) {
    return T(1);
  }
};

// Burgers: f = (u^2 / 2, u^2 / 2), f' = (u, u), f'' = (1, 1), |f'| =
// sqrt(2) |u|; the patch max of sqrt(2) |u| is sqrt(2) times the patch max
// of |u| (rounding is monotone), the JAX kernel's value bit for bit.
struct Burgers {
  static constexpr bool kAbsMax = true;
  template <typename T>
  __device__ static __forceinline__ void fp(T u, T& fx, T& fy) {
    fx = u;
    fy = u;
  }
  template <typename T>
  __device__ static __forceinline__ void fp_fpp(T u, T& fx, T& fy, T& dfx,
                                                T& dfy) {
    fx = u;
    fy = u;
    dfx = T(1);
    dfy = T(1);
  }
  template <typename T> __device__ static __forceinline__ T beta(T amax) {
    return T(1.4142135623730951) * amax;
  }
};

template <typename T>
__device__ void load_consts(StepConsts<T>& C, const double* k) {
  for (int t = 0; t < 2; ++t)
    for (int a = 0; a < 3; ++a) {
      for (int d = 0; d < 2; ++d) C.G[t][a][d] = (T)k[K_G + t * 6 + a * 2 + d];
      for (int b = 0; b < 3; ++b)
        C.GGA[t][a][b] = (T)k[K_GGA + t * 9 + a * 3 + b];
    }
  for (int q = 0; q < 6; ++q)
    for (int a = 0; a < 3; ++a) {
      C.PHI[q][a] = (T)k[K_PHI + q * 3 + a];
      C.W[q][a] = (T)k[K_W + q * 3 + a];
    }
  C.dt = (T)k[K_DT];
  C.two_dt = (T)k[K_TWO_DT];
  C.half_dt = (T)k[K_HALF_DT];
  C.two_area = (T)k[K_TWO_AREA];
  C.cvel_h = (T)k[K_CVEL_H];
  C.crv_hh = (T)k[K_CRV_HH];
  C.tiny = (T)k[K_TINY];
  C.m_theta = (T)k[K_M_THETA];
  C.m_delta = (T)k[K_M_DELTA];
  C.m_two_sigma = (T)k[K_M_TWO_SIGMA];
  C.m_rho0 = (T)k[K_M_RHO0];
  C.l_theta = (T)k[K_L_THETA];
  C.l_delta = (T)k[K_L_DELTA];
  C.l_two_sigma = (T)k[K_L_TWO_SIGMA];
  C.l_rho0 = (T)k[K_L_RHO0];
}

// Corner values, gradient of triangle (t, ci, cj); false if the cell is
// not a cell of the grid held in the buffer.
template <typename T, typename X>
__device__ __forceinline__ bool cell_load(const StepConsts<T>& C, GridShape g,
                                          int t, int ci, int cj, X x,
                                          T (&c)[3], T& gux, T& guy) {
  if (!g.cell(ci, cj)) return false;
#pragma unroll
  for (int b = 0; b < 3; ++b)
    c[b] = x(ci + corner_i(t, b), cj + corner_j(t, b));
  gux = C.G[t][0][0] * c[0] + C.G[t][1][0] * c[1] + C.G[t][2][0] * c[2];
  guy = C.G[t][0][1] * c[0] + C.G[t][1][1] * c[1] + C.G[t][2][1] * c[2];
  return true;
}

template <typename T>
__device__ __forceinline__ T quad_value(const StepConsts<T>& C, int q,
                                        const T (&c)[3]) {
  return C.PHI[q][0] * c[0] + C.PHI[q][1] * c[1] + C.PHI[q][2] * c[2];
}

// N(x) at node (i, j): sum over the triangles that have (i, j) as corner a
// of 2A sum_q qw_q phi_qa (f'(x_q) . grad x)  (_make_lib.nl_rhs).
template <typename Fl, typename T, typename X>
__device__ T nl_rhs_node(const StepConsts<T>& C, GridShape g, int i, int j,
                         X x) {
  T out = T(0);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T c[3], gux, guy;
      if (!cell_load(C, g, t, i - corner_i(t, a), j - corner_j(t, a), x, c,
                     gux, guy))
        continue;
      T val = T(0);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        T fx, fy;
        Fl::fp(quad_value(C, q, c), fx, fy);
        val += C.W[q][a] * (fx * gux + fy * guy);
      }
      out += C.two_area * val;
    }
  }
  return out;
}

// Flux-Jacobian stencil planes at node (i, j) (_make_lib.conv_planes).
template <typename Fl, typename T, typename X>
__device__ void conv_planes_node(const StepConsts<T>& C, GridShape g, int i,
                                 int j, X x, T (&pl)[7]) {
#pragma unroll
  for (int k = 0; k < 7; ++k) pl[k] = T(0);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T c[3], gux, guy;
      if (!cell_load(C, g, t, i - corner_i(t, a), j - corner_j(t, a), x, c,
                     gux, guy))
        continue;
      T row[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        T fx, fy, dfx, dfy;
        Fl::fp_fpp(quad_value(C, q, c), fx, fy, dfx, dfy);
        const T fg = dfx * gux + dfy * guy;
#pragma unroll
        for (int b = 0; b < 3; ++b)
          row[b] += C.W[q][a] * (fg * C.PHI[q][b] + fx * C.G[t][b][0] +
                                 fy * C.G[t][b][1]);
      }
#pragma unroll
      for (int b = 0; b < 3; ++b) pl[pair_plane(t, a, b)] += C.two_area * row[b];
    }
  }
}

// eps-stiffness planes at node (i, j) from the cell means of eps
// (_make_lib.keps_planes).
template <typename T, typename E>
__device__ __forceinline__ void keps_planes_node(const StepConsts<T>& C,
                                                 GridShape g, int i, int j,
                                                 E eps, T (&pl)[7]) {
#pragma unroll
  for (int k = 0; k < 7; ++k) pl[k] = T(0);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int ci = i - corner_i(t, a), cj = j - corner_j(t, a);
      if (!g.cell(ci, cj)) continue;
      T e = T(0);
#pragma unroll
      for (int b = 0; b < 3; ++b) e += eps(ci + corner_i(t, b), cj + corner_j(t, b));
      e = e / T(3);
#pragma unroll
      for (int b = 0; b < 3; ++b) pl[pair_plane(t, a, b)] += C.GGA[t][a][b] * e;
    }
  }
}

// RV epsilon at node (i, j) (structured.rv_epsilon): patch max/min of u
// and patch max of |RH| and |f'(u)| with -inf / +inf fills outside the
// grid, abs_term = max |u - mean u|, eps = min(Cvel h beta, CRV h^2 |RH_i /
// max(n_i, tiny)|).
template <typename Fl, typename T, typename U, typename R>
__device__ __forceinline__ T rv_eps_node(const StepConsts<T>& C, GridShape g,
                                         int i, int j, U u, R rh_at,
                                         T abs_term) {
  T umax = u(i, j), umin = umax, rh = fabs(rh_at(i, j)), amax = fabs(umax);
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    const int ii = i + off_i(k), jj = j + off_j(k);
    if (!g.inside(ii, jj)) continue;  // the -inf / +inf fill
    const T v = u(ii, jj);
    umax = fmax(umax, v);
    umin = fmin(umin, v);
    if (Fl::kAbsMax) amax = fmax(amax, fabs(v));
    rh = fmax(rh, fabs(rh_at(ii, jj)));
  }
  const T n_i = fabs((umax - umin) - abs_term);
  return fmin(C.cvel_h * Fl::beta(amax),
              C.crv_hh * fabs(rh / fmax(n_i, C.tiny)));
}

// CN residual at node (i, j): F(v) = M(v-u) + dt/2 (N(v)+N(u)) + dt/2 (K v
// + K u), v - g on the frame; mc(k) the mass planes at the node, kv = (K
// v)(i, j), nun = N(u)(i, j), kun = (K u)(i, j).
template <typename Fl, typename T, typename A, typename V, typename U>
__device__ __forceinline__ T residual_node(const StepConsts<T>& C,
                                           GridShape g, A mc, int i, int j,
                                           V v, U u, T kv, T nun, T kun,
                                           T gval) {
  if (g.frame(i, j)) return v(i, j) - gval;
  const T mv = stencil_apply(mc, g, i, j, [&](int ii, int jj) {
    return v(ii, jj) - u(ii, jj);
  });
  const T nl = nl_rhs_node<Fl>(C, g, i, j, v);
  return mv + C.half_dt * (nl + nun) + C.half_dt * (kv + kun);
}

// Pinned operator (_make_lib.pinned): identity rows/cols on the frame;
// a(k) the operator's planes at (i, j).
template <typename A, typename X>
__device__ __forceinline__ auto pinned_apply(A a, GridShape g, int i, int j,
                                             X x) {
  using T = decltype(x(i, j));
  if (g.frame(i, j)) return x(i, j);
  return stencil_apply(a, g, i, j, [&](int ii, int jj) {
    return g.frame(ii, jj) ? T(0) : x(ii, jj);
  });
}

// Jacobian planes M + dt/2 (K + C(w)) at node n = (i, j) into jc, from the
// mass and eps-stiffness planes mc(k), kc(k) at the node; returns the
// Jacobi preconditioner 1 / J_00 (1 on the frame). Bf16 planes (PT) are
// formed in T, stored rounded in rows of plane_pitch, and J_00 is rounded
// the same way, so that the preconditioner sees the operator the sweeps
// read (pallas_tiled.tiled_rv_step's rnd).
template <typename Fl, typename T, typename PT, typename A, typename K,
          typename W>
__device__ __forceinline__ T jacobian_node(const StepConsts<T>& C,
                                           GridShape g, A mc, K kc, PT* jc,
                                           int i, int j, int n, W w) {
  const int N = g.size();
  T cc[7];
  conv_planes_node<Fl>(C, g, i, j, w, cc);
  T j0 = T(0);
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const T v = mc(k) + C.half_dt * (kc(k) + cc[k]);
    if constexpr (kHalfPlanes<PT>) {
      const int pitch = plane_pitch<PT>(g.n1y);
      jc[(size_t)k * g.n1x * pitch + (size_t)i * pitch + j] = to_plane<PT>(v);
    } else {
      const size_t o = (size_t)k * N + n;
      jc[o] = v;
    }
    if (k == 0) j0 = v;
  }
  return T(1) / (g.frame(i, j) ? T(1) : plane_value<T>(to_plane<PT>(j0)));
}

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den, T tiny) {
  const bool ok = fabs(den) > tiny;
  return ok ? num / den : T(0);
}

// One step of the Chebyshev recurrence: returns rho_new, sets the
// direction update d' = c1 d + c2 z.
template <typename T>
__device__ __forceinline__ T cheby_next(T rho, T two_sigma, T delta, T& c1,
                                        T& c2) {
  const T rho_new = T(1) / (two_sigma - rho);
  c1 = rho_new * rho;
  c2 = T(2) * rho_new / delta;
  return rho_new;
}

// The quadrature a sweep's body evaluates, on the stage value S: none, N(x)
// (nl_rhs_node) or the flux-Jacobian planes (conv_planes_node). BandSweep
// tabulates it once per triangle before the body runs; TileSweep ignores
// it (the body evaluates it at each node).
template <int S, int K> struct Quad {
  static constexpr int kStage = S, kKind = K;
};
enum QuadKind { kQuadNone = 0, kQuadNl = 1, kQuadConv = 2 };
using NoQuad = Quad<-1, kQuadNone>;
template <int S> using QuadNl = Quad<S, kQuadNl>;
template <int S> using QuadConv = Quad<S, kQuadConv>;

// Sweeps. sweep.run<NS, Q>(reads, stage, body) runs body(i, j, n, st, f,
// ops) once at every node (i, j), n = i * n1y + j, of the grid held in the
// buffer (a row block's rows outside the grid are never computed and never
// read). `reads` declares the raw values the sweep reads (Reads): fields
// f[0, H) at the node and its six neighbours, fields f[H, H + M) at the
// node only, and the 7 planes of operators op[0, P) at the node; a null
// field or operator is not read; the operators' planes are of type OT (T,
// or bf16 in TileSweep alone). In the body, f(k) is raw field k at the
// node, ops[p](k) plane k of operator p there (as T), and st[s] an (i, j)
// accessor of the s-th of the NS values that stage(i, j, h, v) forms from
// the raw values h(k), k < H, of node (i, j) — formed where they are read,
// from device memory (BandSweep, band_sweep.cuh) or from a shared-memory
// tile (TileSweep, tile_sweep.cuh). Nothing a sweep reads at neighbours is
// written by it, because other threads read those values meanwhile; a
// field read at the node only may be updated there.
template <typename T, int H, int M, int P, typename OT = T> struct Reads {
  static constexpr int kHalo = H, kNode = M, kOps = P;
  using OpT = OT;
  const T* f[H + M];
  const OT* op[P > 0 ? P : 1];
};

// Raw fields at node n in device memory.
template <typename T> struct GlobalAt {
  const T* const* f;
  int n;
  __device__ __forceinline__ T operator()(int k) const { return f[k][n]; }
};

// The value s of a stage, formed from device memory where it is read.
template <typename T, int NS, typename Stage> struct FormedField {
  const Stage* stage;
  const T* const* f;
  int n1y, s;
  __device__ __forceinline__ T operator()(int i, int j) const {
    T v[NS];
    (*stage)(i, j, GlobalAt<T>{f, i * n1y + j}, v);
    return v[s];
  }
};
// This thread's nodes of a grid-stride sweep: first, first + stride, ...
// below last.
template <typename Sweep>
__device__ __forceinline__ void node_range(const Sweep&, GridShape g,
                                           int& first, int& last,
                                           int& stride) {
  first = g.n_lo() + blockIdx.x * kBlock + threadIdx.x;
  last = g.n_hi();
  stride = gridDim.x * kBlock;
}

// The grid-wide phases of a step. Every block runs every phase, so every
// thread computes the same scalars (a diverging branch would deadlock the
// barrier). The sweep policy visits the nodes (first, last, stride: this
// thread's nodes of the grid-stride or band loop, node_range) and may bring
// its own reduction and shared-memory copies of the operator planes
// (kOwnReduce, kStages). Fields are addressed by node
// n = i * n1y + j; passes that read neighbours are sweeps, and passes that
// read fields at the node only run over the same sweep policy (pointwise).
// Ping-pong buffers keep a sweep from writing what it reads at neighbours:
// the directions cd0 / p2 and cd1 / v2, the Chebyshev direction cd0 / cd1
// and the Newton iterate uk / uk2.
//
// Block mode (`external`): the buffer is a row block of a taller grid
// (GridShape::block), the step's one global reduction, abs_term = max|u -
// mean u|, comes from the caller, and the inner solver is Chebyshev, so no
// phase reduces over the grid: where the whole-grid step combines a sum and
// a barrier, block mode takes the barrier alone. Pointwise passes, like the
// sweeps, visit only the rows in the grid.
//
// PT, the plane storage of the solver sweeps (the mass solve and the
// Newton inner solves): T, or bf16 (the tiled kernel's bf16-plane
// instance, TileSweep only). With bf16 the mass solve reads mc16, a bf16
// copy of Mc the caller made, the linearisation writes the Jacobian into
// the bf16 region jc16 alone (no f32 Jacobian planes: the work fields end
// at JC), and both Jacobi diagonals are taken from the rounded planes
// (solver_diag); the rhs, the eps-stiffness planes and the residuals read
// the f32 planes Mc and kc.
template <typename T, typename Sweep, typename Fl, typename PT = T>
struct StepPhases {
  cg::grid_group& grid;
  RedScratch<T>& scratch;
  GridReducer<T> red;
  const StepConsts<T>& C;
  GridShape g;
  int N, first, last, stride;
  Sweep sweep;
  const T* Mc;
  const T* gv;
  bool cheby, external;
  T *nun, *kun, *eps, *cx, *cr, *cd0, *cd1, *p2, *v2, *dj, *F, *bs, *bt,
      *rhat, *uk2, *kc, *jc;
  const PT* mc16;  // bf16 planes: the mass planes' copy, the Jacobian's
  PT* jc16;        // region (null for PT = T)

  __device__ StepPhases(cg::grid_group& grid_, RedScratch<T>& scratch_,
                        T* part, const StepConsts<T>& C_, GridShape g_,
                        Sweep sweep_, const T* Mc_, const T* gv_,
                        bool cheby_, T* work, bool external_ = false,
                        const PT* mc16_ = nullptr, PT* jc16_ = nullptr)
      : grid(grid_), scratch(scratch_), red{part, 0}, C(C_), g(g_),
        N(g_.size()), sweep(sweep_), Mc(Mc_), gv(gv_), cheby(cheby_),
        external(external_), mc16(mc16_), jc16(jc16_) {
    node_range(sweep, g, first, last, stride);
    auto field = [&](int f) { return work + (size_t)f * N; };
    nun = field(NUN); kun = field(KUN); eps = field(EPS); cx = field(CX);
    cr = field(CR); cd0 = field(CD0); cd1 = field(CD1); p2 = field(P2);
    v2 = field(V2); dj = field(DJ); F = field(FR); bs = field(BS);
    bt = field(BT); rhat = field(RHAT); uk2 = field(UK2); kc = field(KC);
    jc = kHalfPlanes<PT> ? nullptr : field(JC);
    if constexpr (Sweep::kStages) sweep.stage(0, Mc);
  }

  // The planes the solver sweeps read: the mass planes of the mass solve,
  // the Jacobian planes the linearisation writes and the inner solve reads.
  __device__ const PT* mass_planes() const {
    if constexpr (kHalfPlanes<PT>) {
      return mc16;
    } else {
      return Mc;
    }
  }
  __device__ PT* jacobian_planes() const {
    if constexpr (kHalfPlanes<PT>) {
      return jc16;
    } else {
      return jc;
    }
  }

  // The end of a phase: every block waits for every other.
  __device__ void barrier() { grid.sync(); }

  // Grid-wide reduction of K values, which also ends the phase.
  template <typename Op, int K> __device__ void reduce(T (&v)[K]) {
    if constexpr (Sweep::kOwnReduce) {
      sweep.template reduce<Op>(v);
    } else {
      red.template run<Op>(grid, scratch, v);
    }
  }

  // Operator planes written in the phase just ended that the sweep keeps
  // in shared memory from now on (slot 1 eps-stiffness, 2 Jacobian).
  __device__ void stage(int slot, const T* op) {
    if constexpr (Sweep::kStages) sweep.stage(slot, op);
  }

  // Jacobi preconditioner 1 / d of a pinned operator's diagonal d
  __device__ T inv_diag(int i, int j, T d) const {
    return T(1) / (g.frame(i, j) ? T(1) : d);
  }

  // A diagonal value as the solver sweeps' planes hold it (rounded to PT)
  __device__ T solver_diag(T d) const {
    return plane_value<T>(to_plane<PT>(d));
  }

  // A pass that reads only at the node: body(i, j, n, f) at every node of
  // the sweep, f(k) raw field k of `in` there (BandSweep: the band's
  // nodes; TileSweep: the tile pipeline).
  template <int M, typename Body>
  __device__ void pointwise(const Reads<T, 0, M, 0>& in, Body body) {
    sweep.template run<1>(
        in, [](int, int, const auto&, T (&v)[1]) { v[0] = T(0); },
        [&](int i, int j, int n, const auto&, const auto& f, const auto&) {
          body(i, j, n, f);
        });
  }

  // Block mode: zero `out` on the buffer's rows outside the grid, which no
  // pass visits.
  __device__ void zero_outside(T* out) const {
    for (int n = blockIdx.x * kBlock + threadIdx.x; n < N;
         n += gridDim.x * kBlock)
      if (n < g.n_lo() || n >= last) out[n] = T(0);
  }

  // The grid-wide sums of a phase, which also end it; block mode has no
  // sums to take (Chebyshev, abs_term from the caller) and only ends it.
  template <int K> __device__ void sum_all(T (&v)[K]) {
    if (external) {
      barrier();
    } else {
      reduce<SumOp>(v);
    }
  }

  // 1. residual projection: RH (in cx) solves M RH = where(bc, 0, M du +
  // N(u)) by fixed Jacobi-PCG or Chebyshev; N(u) goes to nun. Returns
  // mean(u) (nothing of use in block mode, which takes no sums).
  __device__ T project(const T* u, const T* uo, const T* uoo, bool bdf2,
                       int cg_iters) {
    T acc[2] = {T(0), T(0)};  // rz of CG init, sum(u)
    sweep.template run<2, QuadNl<1>>(
        Reads<T, 3, 0, 1>{{u, uo, bdf2 ? uoo : nullptr}, {Mc}},
        [&](int i, int j, const auto& h, T (&v)[2]) {
          v[0] = bdf2 ? (T(3) * h(0) - T(4) * h(1) + h(2)) / C.two_dt
                      : (h(0) - h(1)) / C.dt;
          v[1] = h(0);
        },
        [&](int i, int j, int n, const auto& s, const auto& f,
            const auto& ops) {
          const T mv = stencil_apply(ops[0], g, i, j, s[0]);
          const T nl = nl_rhs_node<Fl>(C, g, i, j, s[1]);
          nun[n] = nl;
          const T rhs = g.frame(i, j) ? T(0) : mv + nl;
          cx[n] = T(0);
          cr[n] = rhs;
          const T z = inv_diag(i, j, solver_diag(ops[0](0))) * rhs;
          if (cheby) {
            cd0[n] = z / C.m_theta;
          } else {
            cd0[n] = z;
            acc[0] += rhs * z;
          }
          acc[1] += f(0);
        });
    sum_all(acc);
    if (cheby) {
      cheby_solve(mass_planes(), nullptr, C.m_rho0, C.m_two_sigma,
                  C.m_delta, cg_iters);
    } else {
      mass_cg(acc[0], cg_iters);
    }
    return acc[1] / T(N);
  }

  // Fixed Chebyshev on the pinned operator A from the state cx, cr, d = cd0:
  // per iteration x += d, r -= A d, d' = c1 d + c2 pre r, in one sweep;
  // pre is the preconditioner field, or null for 1 / A_00.
  __device__ void cheby_solve(const PT* A, const T* pre, T rho, T two_sigma,
                              T delta, int iters) {
    T *d_in = cd0, *d_out = cd1;
    for (int it = 0; it < iters; ++it) {
      T c1, c2;
      const T rho_new = cheby_next(rho, two_sigma, delta, c1, c2);
      sweep.template run<1>(
          Reads<T, 1, 3, 1, PT>{{d_in, cx, cr, pre}, {A}},
          [&](int i, int j, const auto& h, T (&v)[1]) { v[0] = h(0); },
          [&](int i, int j, int n, const auto& s, const auto& f,
              const auto& ops) {
            const T d = f(0);
            cx[n] = f(1) + d;
            const T r = f(2) - pinned_apply(ops[0], g, i, j, s[0]);
            cr[n] = r;
            const T z = pre ? f(3) : inv_diag(i, j, ops[0](0));
            d_out[n] = c1 * d + c2 * (z * r);
          });
      barrier();
      rho = rho_new;
      T* tmp = d_in; d_in = d_out; d_out = tmp;
    }
  }

  // Fixed Jacobi-PCG on the pinned mass stencil from the state cx, cr,
  // p = cd0 and rz: a sweep forms p = z + beta p (from the second
  // iteration) and q = M p (in cd1), a pointwise pass updates x and r.
  __device__ void mass_cg(T rz, int iters) {
    T beta = T(0);
    T *p_cur = cd0, *p_alt = p2;
    for (int it = 0; it < iters; ++it) {
      const bool first_it = it == 0;
      T* p_out = first_it ? p_cur : p_alt;
      T pap[1] = {T(0)};
      // the direction from p, r and the mass diagonal M_00 (plane 0)
      sweep.template run<1>(
          Reads<T, 3, 0, 1, PT>{{p_cur, first_it ? nullptr : cr,
                                 first_it ? nullptr : Mc},
                                {mass_planes()}},
          [&](int i, int j, const auto& h, T (&v)[1]) {
            v[0] = first_it ? h(0)
                            : inv_diag(i, j, solver_diag(h(2))) * h(1) +
                                  beta * h(0);
          },
          [&](int i, int j, int n, const auto& s, const auto& f,
              const auto& ops) {
            const T p = s[0](i, j);
            const T q = pinned_apply(ops[0], g, i, j, s[0]);
            if (!first_it) p_out[n] = p;
            cd1[n] = q;
            pap[0] += p * q;
          });
      reduce<SumOp>(pap);
      if (!first_it) {
        p_alt = p_cur;
        p_cur = p_out;
      }
      T alpha = rz / (fabs(pap[0]) > T(0) ? pap[0] : C.tiny);
      alpha = rz > T(0) ? alpha : T(0);
      T rzn[1] = {T(0)};
      pointwise(Reads<T, 0, 5, 0>{{cx, p_cur, cr, cd1, Mc}, {}},
                [&](int i, int j, int n, const auto& f) {
                  cx[n] = f(0) + alpha * f(1);
                  const T r = f(2) - alpha * f(3);
                  cr[n] = r;
                  rzn[0] += r * (inv_diag(i, j, solver_diag(f(4))) * r);
                });
      reduce<SumOp>(rzn);
      beta = rzn[0] / (rz > T(0) ? rz : C.tiny);
      rz = rzn[0];
    }
  }

  // max|u - mean u|, the step's one global reduction beside the dots.
  __device__ T abs_term_of(const T* u, T mean_u) {
    T mx[1] = {MaxOp::identity<T>()};
    pointwise(Reads<T, 0, 1, 0>{{u}, {}},
              [&](int i, int j, int n, const auto& f) {
                mx[0] = fmax(mx[0], fabs(f(0) - mean_u));
              });
    reduce<MaxOp>(mx);
    return mx[0];
  }

  // 2. RV epsilon from u, RH (cx) and abs_term; zero for gfem.
  __device__ void rv_eps(const T* u, T abs_term, bool rv) {
    if (rv) {
      sweep.template run<2>(
          Reads<T, 2, 0, 0>{{u, cx}, {}},
          [&](int i, int j, const auto& h, T (&v)[2]) {
            v[0] = h(0);
            v[1] = h(1);
          },
          [&](int i, int j, int n, const auto& s, const auto& f,
              const auto& ops) {
            eps[n] = rv_eps_node<Fl>(C, g, i, j, s[0], s[1], abs_term);
          });
    } else {
      for (int n = first; n < last; n += stride) eps[n] = T(0);
    }
    barrier();
  }

  // 3. eps-stiffness planes (kc), K u_n (kun), uk0 = where(bc, g, u) into
  // uk and, unless Fo is null, F(uk0) into Fo.
  __device__ void planes(const T* u, T* uk, T* Fo) {
    sweep.template run<3, QuadNl<2>>(
        Reads<T, 3, 1, 1>{{eps, u, gv, Fo ? nun : nullptr},
                          {Fo ? Mc : nullptr}},
        [&](int i, int j, const auto& h, T (&v)[3]) {
          v[0] = h(0);
          v[1] = h(1);
          v[2] = g.frame(i, j) ? h(2) : h(1);
        },
        [&](int i, int j, int n, const auto& s, const auto& f,
            const auto& ops) {
          T pl[7];
          keps_planes_node(C, g, i, j, s[0], pl);
#pragma unroll
          for (int k = 0; k < 7; ++k) kc[(size_t)k * N + n] = pl[k];
          const auto K = [&](int k) { return pl[k]; };
          const T ku = stencil_apply(K, g, i, j, s[1]);
          kun[n] = ku;
          uk[n] = s[2](i, j);
          if (Fo)
            Fo[n] = residual_node<Fl>(C, g, ops[0], i, j, s[2], s[1],
                                      stencil_apply(K, g, i, j, s[2]), f(3),
                                      ku, f(2));
        });
    barrier();
    stage(1, kc);
  }

  // Inner-solver initial state from -F at node n: x = 0, r = rhat = p = -F
  // (the Chebyshev direction dJinv (-F) / theta, djn = dJinv at n).
  __device__ void solver_init(int n, T mF, T djn, T& rho) {
    cx[n] = T(0);
    cr[n] = mF;
    if (cheby) {
      cd0[n] = djn * mF / C.l_theta;
    } else {
      cd0[n] = mF;
      rhat[n] = mF;
      rho += mF * mF;
    }
  }

  // 4a. the Jacobian M + dt/2 (Kc + C(w)) into jc, its Jacobi
  // preconditioner into dj and the inner solver's state from Fi; returns
  // r.r.
  __device__ T linearize(const T* w, const T* Fi) {
    T rho[1] = {T(0)};
    sweep.template run<1, QuadConv<0>>(
        Reads<T, 1, 1, 2>{{w, Fi}, {Mc, kc}},
        [&](int i, int j, const auto& h, T (&v)[1]) { v[0] = h(0); },
        [&](int i, int j, int n, const auto& s, const auto& f,
            const auto& ops) {
          const T d = jacobian_node<Fl>(C, g, ops[0], ops[1],
                                          jacobian_planes(), i, j, n, s[0]);
          dj[n] = d;
          solver_init(n, -f(1), d, rho[0]);
        });
    sum_all(rho);
    stage(2, jc);
    return rho[0];
  }

  // 4b. a frozen Jacobian after the first iteration: the state alone.
  __device__ T reinit(const T* Fi) {
    T rho[1] = {T(0)};
    pointwise(Reads<T, 0, 2, 0>{{Fi, dj}, {}},
              [&](int i, int j, int n, const auto& f) {
                solver_init(n, -f(0), f(1), rho[0]);
              });
    sum_all(rho);
    return rho[0];
  }

  // 5. lin_iters fixed iterations of Chebyshev or BiCGStab on J dx = -F
  // (dx in cx), from the state of solver_init.
  __device__ void inner_solve(T rho, int lin_iters) {
    if (cheby) {
      cheby_solve(jacobian_planes(), dj, C.l_rho0, C.l_two_sigma,
                  C.l_delta, lin_iters);
    } else {
      bicgstab(rho, lin_iters);
    }
  }

  // Right-preconditioned BiCGStab, three passes per iteration: a sweep forms
  // p = r + beta (p - omega v) (from the second iteration) and v = J dJinv
  // p, a sweep s = r - alpha v and t = J dJinv s, a pointwise pass updates x
  // and r. p ping-pongs between cd0 and p2, v between cd1 and v2.
  __device__ void bicgstab(T rho, int iters) {
    T alpha = T(1), omega = T(1), beta = T(0);
    T *p_cur = cd0, *p_alt = p2, *v_cur = cd1, *v_alt = v2;
    for (int li = 0; li < iters; ++li) {
      const bool first_it = li == 0;
      T* p_out = first_it ? p_cur : p_alt;
      T* v_out = first_it ? v_cur : v_alt;
      // raw fields: dJinv, p, r, v, rhat
      auto p_at = [&](const auto& h) {
        return first_it ? h(1) : h(2) + beta * (h(1) - omega * h(3));
      };
      T rv[1] = {T(0)};
      sweep.template run<1>(
          Reads<T, 4, 1, 1, PT>{{dj, p_cur, first_it ? nullptr : cr,
                                 first_it ? nullptr : v_cur, rhat},
                                {jacobian_planes()}},
          [&](int i, int j, const auto& h, T (&v)[1]) {
            v[0] = h(0) * p_at(h);
          },
          [&](int i, int j, int n, const auto& s, const auto& f,
              const auto& ops) {
            const T vv = pinned_apply(ops[0], g, i, j, s[0]);
            if (!first_it) p_out[n] = p_at(f);
            v_out[n] = vv;
            rv[0] += f(4) * vv;
          });
      reduce<SumOp>(rv);
      if (!first_it) {
        p_alt = p_cur;
        p_cur = p_out;
        v_alt = v_cur;
        v_cur = v_out;
      }
      alpha = safe_div(rho, rv[0], C.tiny);
      T ts[2] = {T(0), T(0)};
      sweep.template run<1>(
          Reads<T, 3, 0, 1, PT>{{dj, cr, v_cur}, {jacobian_planes()}},
          [&](int i, int j, const auto& h, T (&v)[1]) {
            v[0] = h(0) * (h(1) - alpha * h(2));
          },
          [&](int i, int j, int n, const auto& s, const auto& f,
              const auto& ops) {
            const T sv = f(1) - alpha * f(2);
            const T tv = pinned_apply(ops[0], g, i, j, s[0]);
            bs[n] = sv;
            bt[n] = tv;
            ts[0] += tv * sv;
            ts[1] += tv * tv;
          });
      reduce<SumOp>(ts);
      omega = safe_div(ts[0], ts[1], C.tiny);
      T rn[1] = {T(0)};
      pointwise(Reads<T, 0, 6, 0>{{cx, dj, p_cur, bs, bt, rhat}, {}},
                [&](int i, int j, int n, const auto& f) {
                  cx[n] = f(0) + alpha * (f(1) * f(2)) +
                          omega * (f(1) * f(3));
                  const T r = f(3) - omega * f(4);
                  cr[n] = r;
                  rn[0] += f(5) * r;
                });
      reduce<SumOp>(rn);
      beta = safe_div(rn[0], rho, C.tiny) * safe_div(alpha, omega, C.tiny);
      rho = rn[0];
    }
  }

  // 6. uk_new = uk + dx and F(uk_new) into Fo (uk_new is not uk).
  __device__ void update(const T* u, const T* uk, T* uk_new, T* Fo) {
    sweep.template run<2, QuadNl<0>>(
        Reads<T, 3, 3, 2>{{uk, cx, u, nun, kun, gv}, {Mc, kc}},
        [&](int i, int j, const auto& h, T (&v)[2]) {
          v[0] = h(0) + h(1);
          v[1] = h(2);
        },
        [&](int i, int j, int n, const auto& s, const auto& f,
            const auto& ops) {
          Fo[n] = residual_node<Fl>(C, g, ops[0], i, j, s[0], s[1],
                                    stencil_apply(ops[1], g, i, j, s[0]),
                                    f(3), f(4), f(5));
          uk_new[n] = s[0](i, j);
        });
    barrier();
  }

  // 6b. the last Newton iteration, which needs no residual: uk_new = uk +
  // dx, pointwise (uk_new may be uk).
  __device__ void advance(const T* uk, T* uk_new) {
    pointwise(Reads<T, 0, 2, 0>{{uk, cx}, {}},
              [&](int i, int j, int n, const auto& f) {
                uk_new[n] = f(0) + f(1);
              });
    barrier();
  }

  // CN Newton from uk0 in uk with F(uk0) in F: per iteration the Jacobian
  // at the iterate (the first iteration only for a frozen one) or the
  // solver state alone, the inner solve, and the update. The iterate
  // alternates between uk and uk2 with its residual in F; the last
  // iteration needs no residual and writes uk + dx to uk (advance).
  __device__ void newton(const T* u, T* uk, int iters, int lin_iters,
                         bool freeze) {
    T *cur = uk, *nxt = uk2;
    for (int it = 0; it < iters; ++it) {
      const T rho = (it == 0 || !freeze) ? linearize(cur, F) : reinit(F);
      inner_solve(rho, lin_iters);
      if (it + 1 == iters) {
        advance(cur, uk);
      } else {
        update(u, cur, nxt, F);
        T* tmp = cur; cur = nxt; nxt = tmp;
      }
    }
  }
};

}  // namespace cft
