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
// read no mask. Products and sums use the _rn intrinsics (no contraction
// into fma), as the plain versions round each product.
//
// The flux is compiled into C and D (fused_step.cuh Kpp, Burgers): this
// source builds A, B and the KPP instances, ell_burgers.cu the Burgers
// instances of C and D.

#include "fused_step.cuh"

namespace cft {

constexpr int kEllThreads = 256;

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

#ifndef CFT_ELL_FLUX_ONLY

template <typename T>
__global__ void __launch_bounds__(kEllThreads)
    ell_spmv_kernel(const T* __restrict__ A, const int* __restrict__ cols,
                    const T* __restrict__ x,
                    const unsigned char* __restrict__ bc, T* __restrict__ y,
                    int n, int K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* a = A + (long long)i * K;
  const int* c = cols + (long long)i * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    int j = __ldg(c + k);
    T xj = (bc != nullptr && bc[j]) ? T(0) : __ldg(x + j);
    T p = mul_rn(__ldg(a + k), xj);
    acc = k == 0 ? p : add_rn(acc, p);
  }
  y[i] = (bc != nullptr && bc[i]) ? x[i] : acc;
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

template <typename T>
int ell_spmv(const void* A, const void* cols, const void* x, const void* bc,
             void* y, int n, int K, void* stream) {
  if (n <= 0) return 0;
  ell_spmv_kernel<T><<<ell_blocks(n), kEllThreads, 0,
                       (cudaStream_t)stream>>>(
      (const T*)A, (const int*)cols, (const T*)x, (const unsigned char*)bc,
      (T*)y, n, K);
  return (int)cudaGetLastError();
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

template <typename T, typename Fl>
__global__ void __launch_bounds__(kEllThreads)
    p1_newton_locals_kernel(const int* __restrict__ cells,
                            const T* __restrict__ area,
                            const T* __restrict__ grads,
                            const T* __restrict__ u,
                            const T* __restrict__ eps, T half_dt,
                            T* __restrict__ rhs, T* __restrict__ jac,
                            int M) {
  int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  T uc[3], gx[3], gy[3];
  int node[3];
  for (int a = 0; a < 3; ++a) {
    node[a] = __ldg(cells + 3LL * m + a);
    uc[a] = __ldg(u + node[a]);
    gx[a] = __ldg(grads + 6LL * m + 2 * a);
    gy[a] = __ldg(grads + 6LL * m + 2 * a + 1);
  }
  const T ar = __ldg(area + m);
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
    rhs[3LL * m + a] = v;
  }
  if (want_jac) {
    const T m_diag = ar * (T(2) / T(12)), m_off = ar * (T(1) / T(12));
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        jac[9LL * m + 3 * a + b] =
            ((a == b ? m_diag : m_off) + half_dt * Ke[a][b])
            + half_dt * (two_area * L[a][b]);
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

template <typename T>
int p1_newton_locals(const void* cells, const void* area, const void* grads,
                     const void* u, const void* eps, double half_dt,
                     void* rhs, void* jac, int M, void* stream) {
  if (M <= 0) return 0;
  p1_newton_locals_kernel<T, CFT_FLUX><<<ell_blocks(M), kEllThreads, 0,
                                         (cudaStream_t)stream>>>(
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
      void *stream
#define CFT_LOCALS_CALL cells, area, grads, u, eps, half_dt, rhs, jac, M, stream
#define CFT_RV_ARGS                                                        \
  const void *cols, const void *u_n, const void *rh, const void *uh,       \
      const void *h, const void *abs_term, const void *valid, double cvel, \
      double crv, double tiny, void *eps, int n, int K, void *stream
#define CFT_RV_CALL                                                        \
  cols, u_n, rh, uh, h, abs_term, valid, cvel, crv, tiny, eps, n, K, stream

extern "C" {

#ifndef CFT_ELL_FLUX_ONLY
int cft_ell_spmv_f32(const void* A, const void* cols, const void* x,
                     const void* bc, void* y, int n, int K, void* stream) {
  return cft::ell_spmv<float>(A, cols, x, bc, y, n, K, stream);
}
int cft_ell_spmv_f64(const void* A, const void* cols, const void* x,
                     const void* bc, void* y, int n, int K, void* stream) {
  return cft::ell_spmv<double>(A, cols, x, bc, y, n, K, stream);
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
