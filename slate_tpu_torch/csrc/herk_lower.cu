// Lower-triangle rank-k update C ← C − A·Aᵀ, in place, one thread block
// per lower tile pair.
//
// Replaces the TPU kernel slate_tpu/ops/pallas_ops.py::herk_lower_update
// (body in _herk_lower_call): the Pallas grid walks only the
// nt·(nt+1)/2 tile pairs (i ≥ j) from a scalar-prefetched pair list and
// aliases the strictly-upper tiles through. Here blockIdx.x is the
// linear index of a pair in row-major lower order, mapped to (i, j) in
// closed form, so no pair list is needed. One tightening over the TPU
// kernel: the diagonal tiles are masked to row ≥ col in the epilogue,
// so the WHOLE strict upper triangle of C is left bitwise unchanged
// (the recursive potrf hands over a view of its working copy and reads
// only the lower triangle, but the port's herk_lower_rec promises an
// untouched strict upper). C and A are row-major with unit column
// stride and any row stride (ldc, lda), so C may be a view such as
// a[h:, h:] of a larger matrix. Any n ≥ 1 and k ≥ 1: ragged tiles are
// zero-padded on load and bounds-checked on store. The TPU kernel's
// k-chunking at 1024 (a VMEM limit) does not carry over: one launch
// streams the whole k.
//
// What bounds it: n(n+1)·k flops against n(n+1) + n·k elements moved,
// so at the sizes the recursive potrf gives it (n = k ≥ 2048) it is
// bound by operations. The design is a plain SIMT product: 128 × 128
// output tiles, 256 threads each holding an 8 × 8 register sub-tile
// (rows ty·4 + {0..3} and 64 + ty·4 + {0..3}, columns likewise from tx,
// so the shared-memory reads are 16-byte vectors without bank
// conflicts), a k-loop that stages the two A row panels (Aᵢ and Aⱼ,
// 128 × 16) transposed in shared memory while the next chunk's global
// loads are held in registers, and FMA accumulation in the element type.
// No tensor cores and no TF32: the precision contract is full f32 (the
// reference's HIGHEST). wgmma, TMA, 3×TF32 splitting and FP64 DMMA are
// later work.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math: NaN and Inf
// propagate.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 128;                  // output tile edge
constexpr int kKC = 16;                  // k-chunk staged in shared memory
constexpr int kThreads = 256;            // 16 × 16, an 8 × 8 sub-tile each
constexpr int kLD = kT + 4;              // padded shared row, 16-byte aligned
constexpr int kPer = kT * kKC / kThreads;  // entries of each panel per thread

__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}

// the tile pair (i, j), i ≥ j, at linear index t of the row-major lower
// order (0,0), (1,0), (1,1), (2,0), ...
__device__ __forceinline__ void pair_of(long long t, int& i, int& j) {
  long long r = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  i = (int)r;
  j = (int)(t - r * (r + 1) / 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
herk_lower_kernel(T* __restrict__ c, const T* __restrict__ a, int n, int k,
                  long long ldc, long long lda) {
  __shared__ __align__(16) T si[kKC][kLD];   // Aᵢ chunk, transposed
  __shared__ __align__(16) T sj[kKC][kLD];   // Aⱼ chunk, transposed
  int ti, tj;
  pair_of(blockIdx.x, ti, tj);
  const int r0 = ti * kT, c0 = tj * kT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  T ri[kPer], rj[kPer];   // the next chunk, held in registers
  T acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[m][p] = T(0);

  // 16 consecutive threads read one row's 16 consecutive k entries
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int idx = tid + s * kThreads, r = idx / kKC, kk = idx % kKC;
    const bool kin = kk < k;
    ri[s] = (kin && r0 + r < n) ? a[(r0 + r) * lda + kk] : T(0);
    rj[s] = (kin && c0 + r < n) ? a[(c0 + r) * lda + kk] : T(0);
  }
  for (int k0 = 0; k0 < k; k0 += kKC) {
    __syncthreads();                       // the last chunk's reads are done
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int idx = tid + s * kThreads, r = idx / kKC, kk = idx % kKC;
      si[kk][r] = ri[s];
      sj[kk][r] = rj[s];
    }
    __syncthreads();
    const int k1 = k0 + kKC;
    if (k1 < k) {                          // in flight during the FMAs below
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int idx = tid + s * kThreads, r = idx / kKC, kk = idx % kKC;
        const bool kin = k1 + kk < k;
        ri[s] = (kin && r0 + r < n) ? a[(r0 + r) * lda + k1 + kk] : T(0);
        rj[s] = (kin && c0 + r < n) ? a[(c0 + r) * lda + k1 + kk] : T(0);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      T x[8], y[8];
      ld4(&si[kk][ty * 4], x);
      ld4(&si[kk][64 + ty * 4], x + 4);
      ld4(&sj[kk][tx * 4], y);
      ld4(&sj[kk][64 + tx * 4], y + 4);
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int p = 0; p < 8; ++p) acc[m][p] += x[m] * y[p];
    }
  }

  // C −= acc on the lower triangle only (col ≤ row also keeps col < n)
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int row = r0 + (m < 4 ? ty * 4 + m : 64 + ty * 4 + (m - 4));
    if (row >= n) continue;
    T* crow = c + row * ldc;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int col = c0 + (p < 4 ? tx * 4 + p : 64 + tx * 4 + (p - 4));
      if (col <= row) crow[col] -= acc[m][p];
    }
  }
}

template <typename T>
int herk_lower(void* c, const void* a, int n, int k, long long ldc,
               long long lda, void* stream) {
  if (n <= 0 || k <= 0 || ldc < n || lda < k) return (int)cudaErrorInvalidValue;
  const long long nt = (n + kT - 1) / kT;
  const long long pairs = nt * (nt + 1) / 2;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  herk_lower_kernel<T><<<(unsigned)pairs, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(c), static_cast<const T*>(a), n, k, ldc, lda);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_herk_lower_f32(void* c, const void* a, int n, int k, long long ldc,
                         long long lda, void* stream) {
  return herk_lower<float>(c, a, n, k, ldc, lda, stream);
}

int slate_herk_lower_f64(void* c, const void* a, int n, int k, long long ldc,
                         long long lda, void* stream) {
  return herk_lower<double>(c, a, n, k, ldc, lda, stream);
}

const char* slate_herk_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
