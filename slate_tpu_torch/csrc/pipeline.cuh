// Helpers of the update kernels (P6 csrc/chol_update.cu, P7 and P8
// csrc/qr_append.cu): flags in shared memory written with release and read
// with acquire at CTA scope, a CTA's progress counter read with acquire at
// GPU scope (raised after a release fence), one element or 16 bytes (part
// of them zero-filled) copied into shared memory by cp.async, and a row
// read from shared memory 16 bytes at a time.

#pragma once

#include <cuda_runtime.h>

namespace pipe {

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(p))),
               "r"(v)
               : "memory");
}
// a release fence at GPU scope (before a progress counter is raised)
__device__ __forceinline__ void fence_release_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}
__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// cp.async of one element (4, 8 or 16 bytes) into shared memory
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(N));
}
// cp.async of 16 bytes that reads the first src_bytes (0 to 16) and
// zero-fills the rest
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// N consecutive elements from shared memory, 16 bytes a load where the
// row is a whole number of 16-byte words (then it is so aligned)
template <typename V, int N>
__device__ __forceinline__ void lds_row(V (&out)[N], const V* p) {
  if constexpr (N * sizeof(V) % 16 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    uint4* o = reinterpret_cast<uint4*>(out);
#pragma unroll
    for (int i = 0; i < (int)(N * sizeof(V) / 16); ++i) o[i] = q[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

}  // namespace pipe
