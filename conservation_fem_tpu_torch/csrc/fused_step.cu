// Hopper kernel for the whole stabilised KPP-RV time step.
//
// Replaces pallas_fused.fused_rv_step (conservation_fem_tpu/ops/
// pallas_fused.py:416, the step of _step_body :333 and _make_lib :97):
// n_substeps full steps, each one
//   1. BDF1/BDF2 residual projection: fixed-iteration Jacobi-CG (or
//      Chebyshev) on the pinned mass stencil;
//   2. RV epsilon: global max|u - mean u|, patch max/min of u, |RH| and
//      |f'(u)| (fills of -inf/+inf outside the grid), eps = min(Cvel h beta,
//      CRV h^2 |Rh_i / max(n_i, tiny)|);
//   3. eps-stiffness planes from cell-mean eps, N(u_n), K u_n;
//   4. CN Newton: F(v) = M(v-u) + dt/2 (N(v)+N(u)) + dt/2 (K v + K u),
//      v|bc = g, Jacobian M + dt/2 (K + C(w)) frozen at uk0 = where(bc,g,u)
//      or fresh per iteration, solved by fixed BiCGStab (safe_div guards)
//      or Chebyshev; F recomputed after every iteration that is followed
//      by another.
// The flux is compiled in: KPP, f = (sin u, cos u), f' = (cos u, -sin u),
// f'' = (-sin u, -cos u), |f'| = 1. sincos is the accurate libdevice one
// (no fast-math): quadrature arguments reach 14 pi / 4.
//
// What bounds it on the H100: at mesh 64 a step moves a few MB — the 7
// mass planes, 7 eps-stiffness and 7 Jacobian planes and ~20 fields, all of
// which stay in the 50 MB L2 — and does four quadrature passes of 36
// sincos per node. Neither is the limit: the step is a chain of 58
// dependent phases (40 of them end in a global reduction: the CG and
// BiCGStab dots, the mean and max of u) with the bench iteration counts,
// so the cost is grid-wide synchronisation latency. Design: ONE cooperative
// persistent kernel per call (every block resident, grid-stride loops over
// nodes, grid.sync() between phases) so no launch and no host round trip
// sits between phases; dots are deterministic two-level reductions
// (stencil.cuh GridReducer), identical from run to run. Cells are indexed
// directly — the TPU kernel's roll + iota-mask layout is not carried over:
// each node gathers the contributions of its (up to) six triangles, so no
// scatter and no atomics are needed, at the price of recomputing a cell's
// quadrature at each of its three corners. Scalars (alpha, omega, rho) live
// in registers, identical in every thread; nothing crosses to the host.

#include "stencil.cuh"

namespace cft {

// Layout of the f64 constant table the wrapper builds
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

// Work fields (each n1x * n1y), allocated by the wrapper.
enum Field {
  NUN = 0, CGR, CGX, CGP, CGAP, EPS, KUN, DJINV, BX, BR, BP, BV, PHAT,
  BS, SHAT, BT, RHAT, KC, JC = KC + 7, N_FIELDS = JC + 7
};

template <typename T> struct StepConsts {
  T G[2][3][2], PHI[6][3], W[6][3], GGA[2][3][3];
  T dt, two_dt, half_dt, two_area, cvel_h, crv_hh, tiny;
  T m_theta, m_delta, m_two_sigma, m_rho0;
  T l_theta, l_delta, l_two_sigma, l_rho0;
};

template <typename T> struct StepParams {
  const T* u_in;
  const T* uo_in;
  const T* uoo_in;
  const T* g;
  const T* Mc;
  T* ring;   // 4 fields: the solution history, rotated per substep
  T* work;   // N_FIELDS fields
  T* part;   // reduction partials
  const double* consts;
  GridShape gs;
  int n_sub, cg_iters, newton_iters, lin_iters;
  int bdf2, rv, freeze, cheby;
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
// outside the (nx, ny) cell grid.
template <typename T, typename X>
__device__ __forceinline__ bool cell_load(const StepConsts<T>& C, GridShape g,
                                          int t, int ci, int cj, X x,
                                          T (&c)[3], T& gux, T& guy) {
  if (ci < 0 || ci >= g.n1x - 1 || cj < 0 || cj >= g.n1y - 1) return false;
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

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den, T tiny) {
  const bool ok = fabs(den) > tiny;
  return ok ? num / den : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
fused_rv_step_kernel(StepParams<T> P) {
  __shared__ RedScratch<T> scratch;
  __shared__ StepConsts<T> C;
  if (threadIdx.x == 0) load_consts(C, P.consts);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  GridReducer<T> red{P.part, 0};
  const GridShape g = P.gs;
  const int N = g.size();
  const int first = blockIdx.x * kBlock + threadIdx.x;
  const int stride = gridDim.x * kBlock;
  auto field = [&](int f) { return P.work + (size_t)f * N; };
  T *Nun = field(NUN), *cgr = field(CGR), *cgx = field(CGX),
    *cgp = field(CGP), *cgap = field(CGAP), *eps = field(EPS),
    *kun = field(KUN), *djinv = field(DJINV),
    *bx = field(BX), *br = field(BR), *bp = field(BP), *bv = field(BV),
    *phat = field(PHAT), *bs = field(BS), *shat = field(SHAT),
    *bt = field(BT), *rhat = field(RHAT), *kc = field(KC), *jc = field(JC);
  const T* Mc = P.Mc;
  const T* gv = P.g;

  // pinned operator (_make_lib.pinned): identity rows/cols on the frame
  auto pinned_mv = [&](const T* coef, const T* v, int i, int j) -> T {
    if (g.frame(i, j)) return v[i * g.n1y + j];
    return stencil_apply(coef, g, i, j, [&](int ii, int jj) {
      return g.frame(ii, jj) ? T(0) : v[ii * g.n1y + jj];
    });
  };
  auto dminv = [&](int i, int j) {
    return T(1) / (g.frame(i, j) ? T(1) : Mc[i * g.n1y + j]);
  };

  for (int n = first; n < N; n += stride) {
    P.ring[n] = P.uoo_in[n];
    P.ring[N + n] = P.uo_in[n];
    P.ring[2 * N + n] = P.u_in[n];
  }
  grid.sync();

  for (int sub = 0; sub < P.n_sub; ++sub) {
    const T* u = P.ring + (size_t)((sub + 2) & 3) * N;
    const T* uo = P.ring + (size_t)((sub + 1) & 3) * N;
    const T* uoo = P.ring + (size_t)(sub & 3) * N;
    T* uk = P.ring + (size_t)((sub + 3) & 3) * N;
    auto at_u = [&](int ii, int jj) { return u[ii * g.n1y + jj]; };
    auto at_uk = [&](int ii, int jj) { return uk[ii * g.n1y + jj]; };

    // 1. residual projection: rhs = where(bc, 0, M du + N(u))
    T acc[2] = {T(0), T(0)};  // rz of CG init, sum(u)
    for (int n = first; n < N; n += stride) {
      const int i = n / g.n1y, j = n % g.n1y;
      const T mv = stencil_apply(Mc, g, i, j, [&](int ii, int jj) {
        const int m = ii * g.n1y + jj;
        return P.bdf2 ? (T(3) * u[m] - T(4) * uo[m] + uoo[m]) / C.two_dt
                      : (u[m] - uo[m]) / C.dt;
      });
      const T nl = nl_rhs_node(C, g, i, j, at_u);
      Nun[n] = nl;
      const T rhs = g.frame(i, j) ? T(0) : mv + nl;
      cgx[n] = T(0);
      cgr[n] = rhs;
      const T z = dminv(i, j) * rhs;
      if (P.cheby) {
        cgp[n] = z / C.m_theta;
      } else {
        cgp[n] = z;
        acc[0] += rhs * z;
      }
      acc[1] += u[n];
    }
    red.template run<SumOp>(grid, scratch, acc);
    const T mean_u = acc[1] / T(N);

    if (P.cheby) {
      T rho = C.m_rho0;
      for (int it = 0; it < P.cg_iters; ++it) {
        for (int n = first; n < N; n += stride) {
          const int i = n / g.n1y, j = n % g.n1y;
          cgx[n] += cgp[n];
          cgr[n] -= pinned_mv(Mc, cgp, i, j);
        }
        grid.sync();
        const T rho_new = T(1) / (C.m_two_sigma - rho);
        const T c1 = rho_new * rho, c2 = T(2) * rho_new / C.m_delta;
        for (int n = first; n < N; n += stride) {
          const int i = n / g.n1y, j = n % g.n1y;
          cgp[n] = c1 * cgp[n] + c2 * (dminv(i, j) * cgr[n]);
        }
        grid.sync();
        rho = rho_new;
      }
    } else {
      T rz = acc[0];
      for (int it = 0; it < P.cg_iters; ++it) {
        T pap[1] = {T(0)};
        for (int n = first; n < N; n += stride) {
          const int i = n / g.n1y, j = n % g.n1y;
          const T a = pinned_mv(Mc, cgp, i, j);
          cgap[n] = a;
          pap[0] += cgp[n] * a;
        }
        red.template run<SumOp>(grid, scratch, pap);
        T alpha = rz / (fabs(pap[0]) > T(0) ? pap[0] : C.tiny);
        alpha = rz > T(0) ? alpha : T(0);
        T rzn[1] = {T(0)};
        for (int n = first; n < N; n += stride) {
          const int i = n / g.n1y, j = n % g.n1y;
          cgx[n] += alpha * cgp[n];
          const T r = cgr[n] - alpha * cgap[n];
          cgr[n] = r;
          rzn[0] += r * (dminv(i, j) * r);
        }
        red.template run<SumOp>(grid, scratch, rzn);
        const T beta = rzn[0] / (rz > T(0) ? rz : C.tiny);
        for (int n = first; n < N; n += stride) {
          const int i = n / g.n1y, j = n % g.n1y;
          cgp[n] = dminv(i, j) * cgr[n] + beta * cgp[n];
        }
        grid.sync();
        rz = rzn[0];
      }
    }
    const T* RH = cgx;

    // 2. RV epsilon (structured.rv_epsilon); |f'| = 1 for KPP
    if (P.rv) {
      T mx[1] = {MaxOp::identity<T>()};
      for (int n = first; n < N; n += stride)
        mx[0] = fmax(mx[0], fabs(u[n] - mean_u));
      red.template run<MaxOp>(grid, scratch, mx);
      const T abs_term = mx[0];
      for (int n = first; n < N; n += stride) {
        const int i = n / g.n1y, j = n % g.n1y;
        T umax = u[n], umin = u[n], rh = fabs(RH[n]);
#pragma unroll
        for (int k = 1; k < 7; ++k) {
          const int ii = i + off_i(k), jj = j + off_j(k);
          if (!g.inside(ii, jj)) continue;  // the -inf / +inf fill
          const int m = ii * g.n1y + jj;
          umax = fmax(umax, u[m]);
          umin = fmin(umin, u[m]);
          rh = fmax(rh, fabs(RH[m]));
        }
        const T n_i = fabs((umax - umin) - abs_term);
        // the patch max of |f'| is 1: cvel_h * 1
        eps[n] = fmin(C.cvel_h, C.crv_hh * fabs(rh / fmax(n_i, C.tiny)));
      }
    } else {
      for (int n = first; n < N; n += stride) eps[n] = T(0);
    }
    grid.sync();

    // 3. eps-stiffness planes from cell-mean eps; K u_n; uk0 = where(bc,g,u)
    for (int n = first; n < N; n += stride) {
      const int i = n / g.n1y, j = n % g.n1y;
      T pl[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) pl[k] = T(0);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int ci = i - corner_i(t, a), cj = j - corner_j(t, a);
          if (ci < 0 || ci >= g.n1x - 1 || cj < 0 || cj >= g.n1y - 1)
            continue;
          T e = T(0);
#pragma unroll
          for (int b = 0; b < 3; ++b)
            e += eps[(ci + corner_i(t, b)) * g.n1y + cj + corner_j(t, b)];
          e = e / T(3);
#pragma unroll
          for (int b = 0; b < 3; ++b) pl[pair_plane(t, a, b)] += C.GGA[t][a][b] * e;
        }
      }
      T ku = pl[0] * u[n];
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        kc[(size_t)k * N + n] = pl[k];
        const int ii = i + off_i(k), jj = j + off_j(k);
        if (k > 0 && g.inside(ii, jj)) ku += pl[k] * u[ii * g.n1y + jj];
      }
      kun[n] = ku;
      uk[n] = g.frame(i, j) ? gv[n] : u[n];
    }
    grid.sync();

    // 4. CN Newton. F phase: F(uk), optionally the Jacobian at uk, and the
    // inner solver's initial state (x = 0, r = rhat = p = -F).
    auto f_phase = [&](bool linearize) {
      T rho[1] = {T(0)};
      for (int n = first; n < N; n += stride) {
        const int i = n / g.n1y, j = n % g.n1y;
        T Fv;
        if (g.frame(i, j)) {
          Fv = uk[n] - gv[n];
        } else {
          const T mv = stencil_apply(Mc, g, i, j, [&](int ii, int jj) {
            const int m = ii * g.n1y + jj;
            return uk[m] - u[m];
          });
          const T nl = nl_rhs_node(C, g, i, j, at_uk);
          const T kv = stencil_apply(kc, g, i, j, at_uk);
          Fv = mv + C.half_dt * (nl + Nun[n]) + C.half_dt * (kv + kun[n]);
        }
        if (linearize) {
          T cc[7];
          conv_planes_node(C, g, i, j, at_uk, cc);
          T j0 = T(0);
#pragma unroll
          for (int k = 0; k < 7; ++k) {
            const size_t o = (size_t)k * N + n;
            const T v = Mc[o] + C.half_dt * (kc[o] + cc[k]);
            jc[o] = v;
            if (k == 0) j0 = v;
          }
          djinv[n] = T(1) / (g.frame(i, j) ? T(1) : j0);
        }
        const T mF = -Fv;
        bx[n] = T(0);
        br[n] = mF;
        if (P.cheby) {
          bp[n] = djinv[n] * mF / C.l_theta;
        } else {
          bp[n] = mF;
          rhat[n] = mF;
          phat[n] = djinv[n] * mF;
          rho[0] += mF * mF;
        }
      }
      red.template run<SumOp>(grid, scratch, rho);
      return rho[0];
    };

    for (int it = 0; it < P.newton_iters; ++it) {
      T rho = f_phase(it == 0 || !P.freeze);
      if (P.cheby) {
        rho = C.l_rho0;
        for (int li = 0; li < P.lin_iters; ++li) {
          for (int n = first; n < N; n += stride) {
            const int i = n / g.n1y, j = n % g.n1y;
            bx[n] += bp[n];
            br[n] -= pinned_mv(jc, bp, i, j);
          }
          grid.sync();
          const T rho_new = T(1) / (C.l_two_sigma - rho);
          const T c1 = rho_new * rho, c2 = T(2) * rho_new / C.l_delta;
          for (int n = first; n < N; n += stride)
            bp[n] = c1 * bp[n] + c2 * (djinv[n] * br[n]);
          grid.sync();
          rho = rho_new;
        }
      } else {
        for (int li = 0; li < P.lin_iters; ++li) {
          T rv[1] = {T(0)};
          for (int n = first; n < N; n += stride) {
            const int i = n / g.n1y, j = n % g.n1y;
            const T v = pinned_mv(jc, phat, i, j);
            bv[n] = v;
            rv[0] += rhat[n] * v;
          }
          red.template run<SumOp>(grid, scratch, rv);
          const T alpha = safe_div(rho, rv[0], C.tiny);
          // t = J shat with shat = dJinv (r - alpha v) formed on the fly
          T ts[2] = {T(0), T(0)};
          for (int n = first; n < N; n += stride) {
            const int i = n / g.n1y, j = n % g.n1y;
            auto shat_at = [&](int m) {
              return djinv[m] * (br[m] - alpha * bv[m]);
            };
            const T s = br[n] - alpha * bv[n];
            const T sh = djinv[n] * s;
            T tv;
            if (g.frame(i, j)) {
              tv = sh;
            } else {
              tv = stencil_apply(jc, g, i, j, [&](int ii, int jj) {
                return g.frame(ii, jj) ? T(0) : shat_at(ii * g.n1y + jj);
              });
            }
            bs[n] = s;
            shat[n] = sh;
            bt[n] = tv;
            ts[0] += tv * s;
            ts[1] += tv * tv;
          }
          red.template run<SumOp>(grid, scratch, ts);
          const T omega = safe_div(ts[0], ts[1], C.tiny);
          T rn[1] = {T(0)};
          for (int n = first; n < N; n += stride) {
            bx[n] = bx[n] + alpha * phat[n] + omega * shat[n];
            const T r = bs[n] - omega * bt[n];
            br[n] = r;
            rn[0] += rhat[n] * r;
          }
          red.template run<SumOp>(grid, scratch, rn);
          const T beta =
              safe_div(rn[0], rho, C.tiny) * safe_div(alpha, omega, C.tiny);
          rho = rn[0];
          for (int n = first; n < N; n += stride) {
            const T p = br[n] + beta * (bp[n] - omega * bv[n]);
            bp[n] = p;
            phat[n] = djinv[n] * p;
          }
          grid.sync();
        }
      }
      for (int n = first; n < N; n += stride) uk[n] += bx[n];
      grid.sync();
    }
  }
}

template <typename T>
int fused_rv_step(const void* u, const void* uo, const void* uoo,
                  const void* gvals, const void* Mc, void* ring, void* work,
                  void* part, const void* consts, int n1x, int n1y,
                  int n_sub, int cg_iters, int newton_iters, int lin_iters,
                  int bdf2, int rv, int freeze, int cheby, void* stream) {
  StepParams<T> P{(const T*)u, (const T*)uo, (const T*)uoo, (const T*)gvals,
                  (const T*)Mc, (T*)ring, (T*)work, (T*)part,
                  (const double*)consts, GridShape{n1x, n1y}, n_sub,
                  cg_iters, newton_iters, lin_iters, bdf2, rv, freeze,
                  cheby};
  void* args[] = {&P};
  const int grid = coop_grid(fused_rv_step_kernel<T>, n1x * n1y);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)fused_rv_step_kernel<T>, grid, kBlock, args, 0,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace cft

extern "C" {

int cft_fused_rv_step_f32(const void* u, const void* uo, const void* uoo,
                          const void* g, const void* Mc, void* ring,
                          void* work, void* part, const void* consts,
                          int n1x, int n1y, int n_sub, int cg_iters,
                          int newton_iters, int lin_iters, int bdf2, int rv,
                          int freeze, int cheby, void* stream) {
  return cft::fused_rv_step<float>(u, uo, uoo, g, Mc, ring, work, part,
                                   consts, n1x, n1y, n_sub, cg_iters,
                                   newton_iters, lin_iters, bdf2, rv, freeze,
                                   cheby, stream);
}
int cft_fused_rv_step_f64(const void* u, const void* uo, const void* uoo,
                          const void* g, const void* Mc, void* ring,
                          void* work, void* part, const void* consts,
                          int n1x, int n1y, int n_sub, int cg_iters,
                          int newton_iters, int lin_iters, int bdf2, int rv,
                          int freeze, int cheby, void* stream) {
  return cft::fused_rv_step<double>(u, uo, uoo, g, Mc, ring, work, part,
                                    consts, n1x, n1y, n_sub, cg_iters,
                                    newton_iters, lin_iters, bdf2, rv, freeze,
                                    cheby, stream);
}

}  // extern "C"
