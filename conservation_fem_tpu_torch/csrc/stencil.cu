// Hopper kernels for the structured stencil backend.
//
// Replaces the TPU kernels of conservation_fem_tpu/ops/pallas_stencil.py:
//   * stencil_matvec (pallas_stencil.py:40): y = A x for a (7, n1x, n1y)
//     stencil, zero outside the grid;
//   * cg_solve (pallas_stencil.py:64): adaptive Jacobi-PCG with Dirichlet
//     rows pinned, its convergence loop inside the kernel.
//
// What bounds them on the H100: stencil_matvec reads 7 planes + x and
// writes y — 9 field-sized streams, ~4.8 MB at mesh 64 in f64 — so it is
// bound by memory traffic (all of it fits the 50 MB L2 at mesh 64; at mesh
// 256 the 7 planes are 59 MB in f64 and stream from HBM). One thread per
// node, neighbouring threads on neighbouring addresses: coalesced.
// cg_solve is bound by its dependent global reductions (two per iteration
// plus the stopping test): the Pallas kernel's whole-grid-in-VMEM design
// has no counterpart on a machine of 132 independent SMs, so it runs as ONE
// cooperative persistent kernel (every block resident, grid-stride loops,
// grid.sync() between phases). The stopping test Σr² > rtol²Σb² is taken
// on the device from a deterministic grid reduction; no scalar goes to the
// host inside the solve.

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

// Work layout (3 fields): r, p, Ap.
template <typename T>
__global__ void __launch_bounds__(kBlock)
cg_solve_kernel(const T* __restrict__ coef, const T* __restrict__ b,
                const unsigned char* __restrict__ bc,
                const T* __restrict__ diag, T* x, T* work, T* part,
                GridShape g, T rtol2, int maxiter) {
  __shared__ RedScratch<T> scratch;
  cg::grid_group grid = cg::this_grid();
  GridReducer<T> red{part, 0};
  const int N = g.size();
  T* r = work;
  T* p = work + N;
  T* Ap = work + 2 * N;
  const int first = blockIdx.x * kBlock + threadIdx.x;
  const int stride = gridDim.x * kBlock;
  auto dinv = [&](int n) { return T(1) / (bc[n] ? T(1) : diag[n]); };
  // pinned operator: rows/cols of bc nodes replaced by the identity
  auto pinned_mv = [&](const T* v, int i, int j) {
    const int n = i * g.n1y + j;
    if (bc[n]) return v[n];
    return stencil_apply(PlanesAt<T>{coef, n, N}, g, i, j,
                         [&](int ii, int jj) {
                           const int m = ii * g.n1y + jj;
                           return bc[m] ? T(0) : v[m];
                         });
  };

  // x0 = where(bc, b, 0); r = b - A x0 with the pinned A: A x0 is b on bc
  // rows and 0 elsewhere (bc columns are zeroed); p = z = dinv r
  T acc[3] = {T(0), T(0), T(0)};  // rz, rr, bb
  for (int n = first; n < N; n += stride) {
    x[n] = bc[n] ? b[n] : T(0);
    const T rn = bc[n] ? b[n] - b[n] : b[n];
    const T zn = dinv(n) * rn;
    r[n] = rn;
    p[n] = zn;
    acc[0] += rn * zn;
    acc[1] += rn * rn;
    acc[2] += b[n] * b[n];
  }
  red.template run<SumOp>(grid, scratch, acc);
  T rz = acc[0], rr = acc[1];
  const T tol2 = rtol2 * acc[2];
  for (int k = 0; rr > tol2 && k < maxiter; ++k) {
    T pap[1] = {T(0)};
    for (int n = first; n < N; n += stride) {
      const int i = n / g.n1y, j = n % g.n1y;
      const T a = pinned_mv(p, i, j);
      Ap[n] = a;
      pap[0] += p[n] * a;
    }
    red.template run<SumOp>(grid, scratch, pap);
    const T alpha = rz / pap[0];
    T acc2[2] = {T(0), T(0)};  // rz_new, rr
    for (int n = first; n < N; n += stride) {
      x[n] += alpha * p[n];
      const T rn = r[n] - alpha * Ap[n];
      r[n] = rn;
      acc2[0] += rn * (dinv(n) * rn);
      acc2[1] += rn * rn;
    }
    red.template run<SumOp>(grid, scratch, acc2);
    const T beta = acc2[0] / rz;
    for (int n = first; n < N; n += stride)
      p[n] = dinv(n) * r[n] + beta * p[n];
    rz = acc2[0];
    rr = acc2[1];
    grid.sync();
  }
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

template <typename T>
int cg_solve(const void* coef, const void* b, const void* bc,
             const void* diag, void* x, void* work, void* part, int n1x,
             int n1y, double rtol, int maxiter, void* stream) {
  GridShape g = GridShape::whole(n1x, n1y);
  const T* coef_ = (const T*)coef;
  const T* b_ = (const T*)b;
  const unsigned char* bc_ = (const unsigned char*)bc;
  const T* diag_ = (const T*)diag;
  T* x_ = (T*)x;
  T* work_ = (T*)work;
  T* part_ = (T*)part;
  // rtol * rtol in f64, cast once — as the JAX kernel's rtol**2 * sum(b*b)
  T rtol2 = (T)(rtol * rtol);
  void* args[] = {&coef_, &b_, &bc_, &diag_, &x_, &work_, &part_,
                  &g, &rtol2, &maxiter};
  const int grid = coop_grid(cg_solve_kernel<T>, n1x * n1y);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)cg_solve_kernel<T>, grid, kBlock, args, 0, (cudaStream_t)stream);
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
                     int n1x, int n1y, double rtol, int maxiter,
                     void* stream) {
  return cft::cg_solve<float>(coef, b, bc, diag, x, work, part, n1x, n1y,
                              rtol, maxiter, stream);
}
int cft_cg_solve_f64(const void* coef, const void* b, const void* bc,
                     const void* diag, void* x, void* work, void* part,
                     int n1x, int n1y, double rtol, int maxiter,
                     void* stream) {
  return cft::cg_solve<double>(coef, b, bc, diag, x, work, part, n1x, n1y,
                               rtol, maxiter, stream);
}

}  // extern "C"
