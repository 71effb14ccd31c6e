// Device phases of the stabilised KPP-RV time step, shared by the three
// step kernels: the single cooperative step (fused_step.cu), the split
// setup and Newton kernels (split_step.cu) and the tiled step
// (tiled_step.cu).
//
// Two levels:
//   * node functions (nl_rhs_node, conv_planes_node, keps_planes_node,
//     rv_eps_node, residual_node, pinned_apply) compute one node's value
//     from field accessors x(i, j), so the same arithmetic reads global
//     memory in the single and split kernels and a staged shared-memory
//     tile in the tiled kernel;
//   * StepPhases, the grid-wide phases of all three kernels (grid.sync()
//     between phases, deterministic two-level reductions from
//     stencil.cuh): residual projection with its mass solve, RV epsilon,
//     eps-stiffness planes, Newton linearisation, the fixed BiCGStab or
//     Chebyshev inner solve and the update with its residual. A phase
//     that reads values at neighbours runs as a sweep over a sweep
//     policy: GridSweep (here; single and split kernels) visits the nodes
//     in a grid-stride loop and forms those values where they are read,
//     TileSweep (tiled_step.cu) stages them in shared memory tile by tile.
// The flux is compiled in: KPP, f = (sin u, cos u), f' = (cos u, -sin u),
// f'' = (-sin u, -cos u), |f'| = 1. sincos is the accurate libdevice one
// (no fast-math): quadrature arguments reach 14 pi / 4.
#pragma once

#include "stencil.cuh"

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
template <typename T, typename X>
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
        T s, co;
        sin_cos(quad_value(C, q, c), &s, &co);
        val += C.W[q][a] * (co * gux + (-s) * guy);
      }
      out += C.two_area * val;
    }
  }
  return out;
}

// Flux-Jacobian stencil planes at node (i, j) (_make_lib.conv_planes).
template <typename T, typename X>
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
        T s, co;
        sin_cos(quad_value(C, q, c), &s, &co);
        const T fx = co, fy = -s;
        const T fg = (-s) * gux + (-co) * guy;
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

// K x at node (i, j) for K's planes held at that node.
template <typename T, typename X>
__device__ __forceinline__ T local_apply(const T (&pl)[7], GridShape g, int i,
                                         int j, X x) {
  T acc = pl[0] * x(i, j);
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    const int ii = i + off_i(k), jj = j + off_j(k);
    if (g.inside(ii, jj)) acc += pl[k] * x(ii, jj);
  }
  return acc;
}

// RV epsilon at node (i, j) (structured.rv_epsilon; |f'| = 1 for KPP):
// patch max/min of u and patch max of |RH| with -inf / +inf fills outside
// the grid, abs_term = max |u - mean u|.
template <typename T, typename U, typename R>
__device__ __forceinline__ T rv_eps_node(const StepConsts<T>& C, GridShape g,
                                         int i, int j, U u, R rh_at,
                                         T abs_term) {
  T umax = u(i, j), umin = umax, rh = fabs(rh_at(i, j));
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    const int ii = i + off_i(k), jj = j + off_j(k);
    if (!g.inside(ii, jj)) continue;  // the -inf / +inf fill
    umax = fmax(umax, u(ii, jj));
    umin = fmin(umin, u(ii, jj));
    rh = fmax(rh, fabs(rh_at(ii, jj)));
  }
  const T n_i = fabs((umax - umin) - abs_term);
  // the patch max of |f'| is 1: cvel_h * 1
  return fmin(C.cvel_h, C.crv_hh * fabs(rh / fmax(n_i, C.tiny)));
}

// CN residual at node (i, j): F(v) = M(v-u) + dt/2 (N(v)+N(u)) + dt/2 (K v
// + K u), v - g on the frame; kv = (K v)(i, j), nun = N(u)(i, j), kun =
// (K u)(i, j).
template <typename T, typename V, typename U>
__device__ __forceinline__ T residual_node(const StepConsts<T>& C,
                                           GridShape g, const T* Mc, int i,
                                           int j, V v, U u, T kv, T nun,
                                           T kun, T gval) {
  if (g.frame(i, j)) return v(i, j) - gval;
  const T mv = stencil_apply(Mc, g, i, j, [&](int ii, int jj) {
    return v(ii, jj) - u(ii, jj);
  });
  const T nl = nl_rhs_node(C, g, i, j, v);
  return mv + C.half_dt * (nl + nun) + C.half_dt * (kv + kun);
}

// Pinned operator (_make_lib.pinned): identity rows/cols on the frame.
template <typename T, typename X>
__device__ __forceinline__ T pinned_apply(const T* coef, GridShape g, int i,
                                          int j, X x) {
  if (g.frame(i, j)) return x(i, j);
  return stencil_apply(coef, g, i, j, [&](int ii, int jj) {
    return g.frame(ii, jj) ? T(0) : x(ii, jj);
  });
}

// Jacobian planes M + dt/2 (K + C(w)) at node n = (i, j) into jc; returns
// the Jacobi preconditioner 1 / J_00 (1 on the frame).
template <typename T, typename W>
__device__ __forceinline__ T jacobian_node(const StepConsts<T>& C,
                                           GridShape g, const T* Mc,
                                           const T* kc, T* jc, int i, int j,
                                           int n, W w) {
  const int N = g.size();
  T cc[7];
  conv_planes_node(C, g, i, j, w, cc);
  T j0 = T(0);
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const size_t o = (size_t)k * N + n;
    const T v = Mc[o] + C.half_dt * (kc[o] + cc[k]);
    jc[o] = v;
    if (k == 0) j0 = v;
  }
  return T(1) / (g.frame(i, j) ? T(1) : j0);
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

// Sweeps. sweep.run<NS>(stage, body) runs body(i, j, n, st) once at every
// node of the grid (a row block's rows outside the grid are never computed
// and never read), where st[s] is an (i, j) accessor of the s-th of the NS values that
// stage(i, j, n, v) forms at a node; a stage reads nothing its body writes,
// because other threads read those values at neighbours meanwhile.

// The values of a stage, formed at the node they are read at.
template <typename T, int NS, typename Stage> struct FormedField {
  const Stage* stage;
  int n1y, s;
  __device__ __forceinline__ T operator()(int i, int j) const {
    T v[NS];
    (*stage)(i, j, i * n1y + j, v);
    return v[s];
  }
};
template <typename T, int NS, typename Stage> struct Formed {
  const Stage* stage;
  int n1y;
  __device__ __forceinline__ FormedField<T, NS, Stage> operator[](
      int s) const {
    return FormedField<T, NS, Stage>{stage, n1y, s};
  }
};

// Grid-stride sweep of the single and split kernels.
template <typename T> struct GridSweep {
  GridShape g;
  template <int NS, typename Stage, typename Body>
  __device__ __forceinline__ void run(Stage stage, Body body) const {
    const Formed<T, NS, Stage> st{&stage, g.n1y};
    const int hi = g.n_hi();
    for (int n = g.n_lo() + blockIdx.x * kBlock + threadIdx.x; n < hi;
         n += gridDim.x * kBlock)
      body(n / g.n1y, n % g.n1y, n, st);
  }
};

// The grid-wide phases of a step. Every block runs every phase, so every
// thread computes the same scalars (a diverging branch would deadlock the
// grid barrier). Fields are addressed by node n = i * n1y + j; pointwise
// passes are grid-stride loops, passes that read neighbours are sweeps.
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
template <typename T, typename Sweep> struct StepPhases {
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

  __device__ StepPhases(cg::grid_group& grid_, RedScratch<T>& scratch_,
                        T* part, const StepConsts<T>& C_, GridShape g_,
                        Sweep sweep_, const T* Mc_, const T* gv_,
                        bool cheby_, T* work, bool external_ = false)
      : grid(grid_), scratch(scratch_), red{part, 0}, C(C_), g(g_),
        N(g_.size()), first(g_.n_lo() + blockIdx.x * kBlock + threadIdx.x),
        last(g_.n_hi()), stride(gridDim.x * kBlock), sweep(sweep_), Mc(Mc_),
        gv(gv_), cheby(cheby_), external(external_) {
    auto field = [&](int f) { return work + (size_t)f * N; };
    nun = field(NUN); kun = field(KUN); eps = field(EPS); cx = field(CX);
    cr = field(CR); cd0 = field(CD0); cd1 = field(CD1); p2 = field(P2);
    v2 = field(V2); dj = field(DJ); F = field(FR); bs = field(BS);
    bt = field(BT); rhat = field(RHAT); uk2 = field(UK2); kc = field(KC);
    jc = field(JC);
  }

  __device__ T dminv(int i, int j, int n) const {
    return T(1) / (g.frame(i, j) ? T(1) : Mc[n]);
  }

  // Block mode: zero `out` on the buffer's rows outside the grid, which no
  // pass visits.
  __device__ void zero_outside(T* out) const {
    for (int n = blockIdx.x * kBlock + threadIdx.x; n < N; n += stride)
      if (n < g.n_lo() || n >= last) out[n] = T(0);
  }

  // The grid-wide sums of a phase, which also end it; block mode has no
  // sums to take (Chebyshev, abs_term from the caller) and only ends it.
  template <int K> __device__ void sum_all(T (&v)[K]) {
    if (external) {
      grid.sync();
    } else {
      red.template run<SumOp>(grid, scratch, v);
    }
  }

  // 1. residual projection: RH (in cx) solves M RH = where(bc, 0, M du +
  // N(u)) by fixed Jacobi-PCG or Chebyshev; N(u) goes to nun. Returns
  // mean(u) (nothing of use in block mode, which takes no sums).
  __device__ T project(const T* u, const T* uo, const T* uoo, bool bdf2,
                       int cg_iters) {
    T acc[2] = {T(0), T(0)};  // rz of CG init, sum(u)
    sweep.template run<2>(
        [&](int i, int j, int n, T (&v)[2]) {
          v[0] = bdf2 ? (T(3) * u[n] - T(4) * uo[n] + uoo[n]) / C.two_dt
                      : (u[n] - uo[n]) / C.dt;
          v[1] = u[n];
        },
        [&](int i, int j, int n, const auto& s) {
          const T mv = stencil_apply(Mc, g, i, j, s[0]);
          const T nl = nl_rhs_node(C, g, i, j, s[1]);
          nun[n] = nl;
          const T rhs = g.frame(i, j) ? T(0) : mv + nl;
          cx[n] = T(0);
          cr[n] = rhs;
          const T z = dminv(i, j, n) * rhs;
          if (cheby) {
            cd0[n] = z / C.m_theta;
          } else {
            cd0[n] = z;
            acc[0] += rhs * z;
          }
          acc[1] += u[n];
        });
    sum_all(acc);
    if (cheby) {
      cheby_solve(Mc, [&](int i, int j, int n) { return dminv(i, j, n); },
                  C.m_rho0, C.m_two_sigma, C.m_delta, cg_iters);
    } else {
      mass_cg(acc[0], cg_iters);
    }
    return acc[1] / T(N);
  }

  // Fixed Chebyshev on the pinned operator A from the state cx, cr, d = cd0:
  // per iteration x += d, r -= A d, d' = c1 d + c2 pre r, in one sweep.
  template <typename Pre>
  __device__ void cheby_solve(const T* A, Pre pre, T rho, T two_sigma,
                              T delta, int iters) {
    T *d_in = cd0, *d_out = cd1;
    for (int it = 0; it < iters; ++it) {
      T c1, c2;
      const T rho_new = cheby_next(rho, two_sigma, delta, c1, c2);
      sweep.template run<1>(
          [&](int i, int j, int n, T (&v)[1]) { v[0] = d_in[n]; },
          [&](int i, int j, int n, const auto& s) {
            const T d = d_in[n];
            cx[n] += d;
            const T r = cr[n] - pinned_apply(A, g, i, j, s[0]);
            cr[n] = r;
            d_out[n] = c1 * d + c2 * (pre(i, j, n) * r);
          });
      grid.sync();
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
      sweep.template run<1>(
          [&](int i, int j, int n, T (&v)[1]) {
            v[0] = first_it ? p_cur[n]
                            : dminv(i, j, n) * cr[n] + beta * p_cur[n];
          },
          [&](int i, int j, int n, const auto& s) {
            const T p = s[0](i, j);
            const T q = pinned_apply(Mc, g, i, j, s[0]);
            if (!first_it) p_out[n] = p;
            cd1[n] = q;
            pap[0] += p * q;
          });
      red.template run<SumOp>(grid, scratch, pap);
      if (!first_it) {
        p_alt = p_cur;
        p_cur = p_out;
      }
      T alpha = rz / (fabs(pap[0]) > T(0) ? pap[0] : C.tiny);
      alpha = rz > T(0) ? alpha : T(0);
      T rzn[1] = {T(0)};
      for (int n = first; n < last; n += stride) {
        const int i = n / g.n1y, j = n % g.n1y;
        cx[n] += alpha * p_cur[n];
        const T r = cr[n] - alpha * cd1[n];
        cr[n] = r;
        rzn[0] += r * (dminv(i, j, n) * r);
      }
      red.template run<SumOp>(grid, scratch, rzn);
      beta = rzn[0] / (rz > T(0) ? rz : C.tiny);
      rz = rzn[0];
    }
  }

  // max|u - mean u|, the step's one global reduction beside the dots.
  __device__ T abs_term_of(const T* u, T mean_u) {
    T mx[1] = {MaxOp::identity<T>()};
    for (int n = first; n < last; n += stride)
      mx[0] = fmax(mx[0], fabs(u[n] - mean_u));
    red.template run<MaxOp>(grid, scratch, mx);
    return mx[0];
  }

  // 2. RV epsilon from u, RH (cx) and abs_term; zero for gfem.
  __device__ void rv_eps(const T* u, T abs_term, bool rv) {
    if (rv) {
      sweep.template run<2>(
          [&](int i, int j, int n, T (&v)[2]) {
            v[0] = u[n];
            v[1] = cx[n];
          },
          [&](int i, int j, int n, const auto& s) {
            eps[n] = rv_eps_node(C, g, i, j, s[0], s[1], abs_term);
          });
    } else {
      for (int n = first; n < last; n += stride) eps[n] = T(0);
    }
    grid.sync();
  }

  // 3. eps-stiffness planes (kc), K u_n (kun), uk0 = where(bc, g, u) into
  // uk and, unless Fo is null, F(uk0) into Fo.
  __device__ void planes(const T* u, T* uk, T* Fo) {
    sweep.template run<3>(
        [&](int i, int j, int n, T (&v)[3]) {
          v[0] = eps[n];
          v[1] = u[n];
          v[2] = g.frame(i, j) ? gv[n] : u[n];
        },
        [&](int i, int j, int n, const auto& s) {
          T pl[7];
          keps_planes_node(C, g, i, j, s[0], pl);
#pragma unroll
          for (int k = 0; k < 7; ++k) kc[(size_t)k * N + n] = pl[k];
          const T ku = local_apply(pl, g, i, j, s[1]);
          kun[n] = ku;
          uk[n] = s[2](i, j);
          if (Fo)
            Fo[n] = residual_node(C, g, Mc, i, j, s[2], s[1],
                                  local_apply(pl, g, i, j, s[2]), nun[n], ku,
                                  gv[n]);
        });
    grid.sync();
  }

  // Inner-solver initial state from -F at node n: x = 0, r = rhat = p = -F
  // (the Chebyshev direction dJinv (-F) / theta).
  __device__ void solver_init(int n, T mF, T& rho) {
    cx[n] = T(0);
    cr[n] = mF;
    if (cheby) {
      cd0[n] = dj[n] * mF / C.l_theta;
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
    sweep.template run<1>(
        [&](int i, int j, int n, T (&v)[1]) { v[0] = w[n]; },
        [&](int i, int j, int n, const auto& s) {
          dj[n] = jacobian_node(C, g, Mc, kc, jc, i, j, n, s[0]);
          solver_init(n, -Fi[n], rho[0]);
        });
    sum_all(rho);
    return rho[0];
  }

  // 4b. a frozen Jacobian after the first iteration: the state alone.
  __device__ T reinit(const T* Fi) {
    T rho[1] = {T(0)};
    for (int n = first; n < last; n += stride)
      solver_init(n, -Fi[n], rho[0]);
    sum_all(rho);
    return rho[0];
  }

  // 5. lin_iters fixed iterations of Chebyshev or BiCGStab on J dx = -F
  // (dx in cx), from the state of solver_init.
  __device__ void inner_solve(T rho, int lin_iters) {
    if (cheby) {
      cheby_solve(jc, [&](int i, int j, int n) { return dj[n]; }, C.l_rho0,
                  C.l_two_sigma, C.l_delta, lin_iters);
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
      auto p_at = [&](int n) {
        return first_it ? p_cur[n]
                        : cr[n] + beta * (p_cur[n] - omega * v_cur[n]);
      };
      T rv[1] = {T(0)};
      sweep.template run<1>(
          [&](int i, int j, int n, T (&v)[1]) { v[0] = dj[n] * p_at(n); },
          [&](int i, int j, int n, const auto& s) {
            const T vv = pinned_apply(jc, g, i, j, s[0]);
            if (!first_it) p_out[n] = p_at(n);
            v_out[n] = vv;
            rv[0] += rhat[n] * vv;
          });
      red.template run<SumOp>(grid, scratch, rv);
      if (!first_it) {
        p_alt = p_cur;
        p_cur = p_out;
        v_alt = v_cur;
        v_cur = v_out;
      }
      alpha = safe_div(rho, rv[0], C.tiny);
      T ts[2] = {T(0), T(0)};
      sweep.template run<1>(
          [&](int i, int j, int n, T (&v)[1]) {
            v[0] = dj[n] * (cr[n] - alpha * v_cur[n]);
          },
          [&](int i, int j, int n, const auto& s) {
            const T sv = cr[n] - alpha * v_cur[n];
            const T tv = pinned_apply(jc, g, i, j, s[0]);
            bs[n] = sv;
            bt[n] = tv;
            ts[0] += tv * sv;
            ts[1] += tv * tv;
          });
      red.template run<SumOp>(grid, scratch, ts);
      omega = safe_div(ts[0], ts[1], C.tiny);
      T rn[1] = {T(0)};
      for (int n = first; n < last; n += stride) {
        cx[n] = cx[n] + alpha * (dj[n] * p_cur[n]) + omega * (dj[n] * bs[n]);
        const T r = bs[n] - omega * bt[n];
        cr[n] = r;
        rn[0] += rhat[n] * r;
      }
      red.template run<SumOp>(grid, scratch, rn);
      beta = safe_div(rn[0], rho, C.tiny) * safe_div(alpha, omega, C.tiny);
      rho = rn[0];
    }
  }

  // 6. uk_new = uk + dx and F(uk_new) into Fo (uk_new is not uk).
  __device__ void update(const T* u, const T* uk, T* uk_new, T* Fo) {
    sweep.template run<2>(
        [&](int i, int j, int n, T (&v)[2]) {
          v[0] = uk[n] + cx[n];
          v[1] = u[n];
        },
        [&](int i, int j, int n, const auto& s) {
          Fo[n] = residual_node(C, g, Mc, i, j, s[0], s[1],
                                stencil_apply(kc, g, i, j, s[0]), nun[n],
                                kun[n], gv[n]);
          uk_new[n] = s[0](i, j);
        });
    grid.sync();
  }

  // CN Newton from uk0 in uk with F(uk0) in F: per iteration the Jacobian
  // at the iterate (the first iteration only for a frozen one) or the
  // solver state alone, the inner solve, and the update. The iterate
  // alternates between uk and uk2 with its residual in F; the last
  // iteration needs no residual and writes uk + dx to uk pointwise.
  __device__ void newton(const T* u, T* uk, int iters, int lin_iters,
                         bool freeze) {
    T *cur = uk, *nxt = uk2;
    for (int it = 0; it < iters; ++it) {
      const T rho = (it == 0 || !freeze) ? linearize(cur, F) : reinit(F);
      inner_solve(rho, lin_iters);
      if (it + 1 == iters) {
        for (int n = first; n < last; n += stride) uk[n] = cur[n] + cx[n];
        grid.sync();
      } else {
        update(u, cur, nxt, F);
        T* tmp = cur; cur = nxt; nxt = tmp;
      }
    }
  }
};

}  // namespace cft
