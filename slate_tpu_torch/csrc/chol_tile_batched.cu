// Guarded Cholesky of every item of a (B, s, s) stack, s ≤ 64, in float32
// and float64: L_b lower triangular with L_b·L_bᵀ = A_b, read from the
// lower triangle of each item through its batch, row and column strides,
// written to a contiguous (B, s, s) stack whose strict upper triangles are
// zero. info[b]: the 1-based index of item b's first non-positive or NaN
// leading minor (0 if none); that column divides by a safe 1 and the
// factorization goes on, so one bad item changes nothing in any other.
//
// No Pallas kernel: this is the port's counterpart of the reference's
// batched tile factor, slate_tpu/ops/blocked.py::_chol_unrolled_b (32
// python-unrolled column steps that XLA fuses into one program), with the
// contract of the plain version hopper_ops.chol_tile_batched_plain. Step j
// computes, on every item at once,
//     bad  = isnan(d[j][j]) || d[j][j] <= 0,  root = sqrt(bad ? 1 : d[j][j]),
//     col  = d[:, j] / root below j,  d[j][j] = root,
//     d[r][c] = d[r][c] − col[r]·col[c]   for r > j and c > j,
// with the product and the difference rounded separately (no FMA
// contraction), an IEEE square root and an IEEE division, so the kernel is
// bitwise its plain version.
//
// What bounds it. An item is s³/3 multiply-adds and at most 32 KB: at the
// engine's shapes (B up to 10000 tiles of 32 × 32) the stack crosses HBM
// once each way, which bounds it by bytes once every SM holds enough
// items; each item alone is a chain of s dependent steps (a pivot
// shuffle, a square root, a division, the column's shuffles).
//
// Design: one warp per item, four items per CTA, the item in registers.
// Lane l holds row l (columns 0 … 31) and, for s > 32, row l + 32
// (columns 0 … 63): only those columns can be in the lower triangle. The
// pivot of step j and each column entry col[c] reach the other lanes by
// one shuffle each; every step is unrolled so the registers are indexed at
// compile time. No shared memory and no barrier: the warp's lanes run in
// lock step. Loads and stores go straight to global memory (a lane reads
// its row; the L1 cache catches the neighbouring columns).
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE square root,
// division and NaN handling are part of the contract).

#include <cuda_runtime.h>

namespace {

constexpr int kItems = 4;              // warps, so items, per CTA
constexpr int kThreads = 32 * kItems;  // 128
constexpr int kMaxS = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }

// kHalves = 1: s ≤ 32, one row per lane; 2: s ≤ 64, rows l and l + 32
template <typename T, int kHalves>
__global__ void __launch_bounds__(kThreads)
chol_tile_batched_kernel(const T* __restrict__ a, T* __restrict__ l,
                         int* __restrict__ info, int B, int s, long long bs,
                         long long rs, long long cs) {
  constexpr int kS = 32 * kHalves;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kItems + (threadIdx.x >> 5);
  if (item >= B) return;  // the whole warp leaves together
  const T* src = a + item * bs;
  const int r0 = lane, r1 = lane + 32;

  T m0[32];                       // row r0, columns 0 … 31
  T m1[kHalves == 2 ? kMaxS : 1];  // row r1, columns 0 … 63
#pragma unroll
  for (int c = 0; c < 32; ++c)
    m0[c] = r0 < s && c <= r0 ? src[r0 * rs + c * cs] : T(0);
  if constexpr (kHalves == 2) {
#pragma unroll
    for (int c = 0; c < kMaxS; ++c)
      m1[c] = r1 < s && c <= r1 ? src[r1 * rs + c * cs] : T(0);
  }

  int first_bad = 0;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    if (j >= s) break;
    T d;
    if constexpr (kHalves == 2) {
      d = j < 32 ? __shfl_sync(kFull, m0[j & 31], j)
                 : __shfl_sync(kFull, m1[j], j - 32);
    } else {
      d = __shfl_sync(kFull, m0[j], j);
    }
    const bool bad = isnan(d) || d <= T(0);
    if (bad && first_bad == 0) first_bad = j + 1;
    const T root = sqrt_rn(bad ? T(1) : d);
    T col0 = T(0), col1 = T(0);  // col at rows r0 and r1 (root at row j)
    if (j < 32) {
      col0 = r0 > j ? div_rn(m0[j & 31], root) : (r0 == j ? root : T(0));
      m0[j & 31] = col0;
    }
    if constexpr (kHalves == 2) {
      col1 = r1 > j ? div_rn(m1[j], root) : (r1 == j ? root : T(0));
      m1[j] = col1;
    }
#pragma unroll
    for (int c = j + 1; c < kS; ++c) {
      if (c >= s) break;
      const T cc = __shfl_sync(kFull, c < 32 ? col0 : col1, c & 31);
      if (c < 32 && r0 > j) m0[c & 31] = sub_rn(m0[c & 31], mul_rn(col0, cc));
      if constexpr (kHalves == 2) {
        if (r1 > j) m1[c] = sub_rn(m1[c], mul_rn(col1, cc));
      }
    }
  }

  T* dst = l + item * s * s;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (r0 < s && c < s) dst[r0 * s + c] = c <= r0 ? m0[c] : T(0);
  if constexpr (kHalves == 2) {
    for (int c = 32; c < s; ++c) dst[r0 * s + c] = T(0);  // above row r0
#pragma unroll
    for (int c = 0; c < kMaxS; ++c)
      if (r1 < s && c < s) dst[r1 * s + c] = c <= r1 ? m1[c] : T(0);
  }
  if (lane == 0) info[item] = first_bad;
}

template <typename T>
int chol_tile_batched(const void* a, void* l, void* info, int B, int s,
                      long long bs, long long rs, long long cs,
                      void* stream) {
  if (B < 1 || s < 1 || s > kMaxS) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((B + kItems - 1) / kItems);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(a);
  if (s <= 32)
    chol_tile_batched_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        x, static_cast<T*>(l), static_cast<int*>(info), B, s, bs, rs, cs);
  else
    chol_tile_batched_kernel<T, 2><<<grid, kThreads, 0, st>>>(
        x, static_cast<T*>(l), static_cast<int*>(info), B, s, bs, rs, cs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_chol_tile_batched_f32(const void* a, void* l, void* info, int B,
                                int s, long long bs, long long rs,
                                long long cs, void* stream) {
  return chol_tile_batched<float>(a, l, info, B, s, bs, rs, cs, stream);
}

int slate_chol_tile_batched_f64(const void* a, void* l, void* info, int B,
                                int s, long long bs, long long rs,
                                long long cs, void* stream) {
  return chol_tile_batched<double>(a, l, info, B, s, bs, rs, cs, stream);
}

const char* slate_chol_tile_batched_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
