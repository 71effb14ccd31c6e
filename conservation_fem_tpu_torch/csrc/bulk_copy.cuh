// Hopper's asynchronous copies into shared memory, for the ELL kernels
// (ell.cu): the 1-D bulk copy of the Tensor Memory Accelerator
// (cp.async.bulk, completion counted in bytes on an mbarrier) and the
// per-thread cp.async of one value, whose completion arrives on the same
// kind of barrier (cp.async.mbarrier.arrive.noinc); L2 eviction policies
// for copies, loads and stores. A bulk copy needs 16-byte aligned
// addresses and a size that is a multiple of 16.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cft {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A barrier that completes its phase after `count` arrivals (and, for
// bulk copies, the bytes its arrivals announced).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the copy engine; then a
// __syncthreads makes them visible to the block.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's earlier reads of shared memory before later
// asynchronous (bulk) writes to it: issued before refilling a stage.
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also announces `bytes` to come by bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` from device memory to shared memory by the copy engine,
// counted on `bar` as they land.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// L2 eviction policies (createpolicy, sm_80 on): for every line a load
// or copy that carries one touches, the priority with which L2 evicts it.
// evict_first for data streamed once, evict_last for data to keep while
// the streams pass.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// bulk_copy with an L2 eviction policy for the lines it reads.
__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src,
                                               unsigned bytes, uint64_t* bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// A read-only load of one value with an L2 eviction policy (not volatile:
// the data do not change during the kernel, so loads may be reordered).
__device__ __forceinline__ float load_hint(const float* p, uint64_t policy) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n"
      : "=f"(v)
      : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ double load_hint(const double* p,
                                            uint64_t policy) {
  double v;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;\n"
      : "=d"(v)
      : "l"(p), "l"(policy));
  return v;
}

// A store of one value with an L2 eviction policy.
__device__ __forceinline__ void store_hint(float* p, float v,
                                           uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;\n" ::"l"(p),
               "f"(v), "l"(policy)
               : "memory");
}
__device__ __forceinline__ void store_hint(double* p, double v,
                                           uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.f64 [%0], %1, %2;\n" ::"l"(p),
               "d"(v), "l"(policy)
               : "memory");
}

// One value of 4 or 8 bytes from device memory to shared memory.
template <typename T>
__device__ __forceinline__ void copy_value_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4 or 8 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"((int)sizeof(T))
               : "memory");
}

// One arrival on `bar` once every copy_value_async this thread issued
// before has landed (the barrier's count includes it: noinc).
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

}  // namespace cft
