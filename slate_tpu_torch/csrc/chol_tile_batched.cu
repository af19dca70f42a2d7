// Guarded Cholesky of every item of a (B, s, s) stack, s ≤ 64, in float32,
// float64, complex64 and complex128: L_b lower triangular with
// L_b·L_bᴴ = A_b, read from the
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
//     dj = re(d[j][j]),  bad = isnan(dj) || dj <= 0,
//     root = sqrt(bad ? 1 : dj),
//     col  = d[:, j] / root below j,  d[j][j] = root,
//     d[r][c] = d[r][c] − col[r]·conj(col[c])   for r > j and c > j,
// with the product and the difference rounded separately (no FMA
// contraction; in complex types csrc/cx.cuh's product, and the division
// by the real root part by part), an IEEE square root and an IEEE
// division, so the kernel is bitwise its plain version. The imaginary part
// of a diagonal entry is never read.
//
// What bounds it. An item is s³/3 multiply-adds and at most 32 KB: at the
// engine's shapes (B up to 10000 tiles of 32 × 32) the stack crosses HBM
// once each way, which bounds it by bytes once every SM holds enough
// items; each item alone is a chain of s dependent steps (a pivot, a
// square root, a division).
//
// Design: one warp per item, four items per CTA (two in complex128, whose
// staging tiles would not fit 48 KB of static shared memory four times),
// the item in registers,
// padded to kS = 16, 32 or 64 rows so that every register index is fixed
// at compile time and the steps are one straight block of code. Lane l
// holds row l (columns 0 … 31) and, for kS = 64, row l + 32 (columns
// 0 … 63): only those columns can be in the lower triangle. The padded
// rows and columns are zero; the steps past s touch only entries that are
// never stored, and set no info.
// 1. Coalesced staging: the warp reads its item one row per instruction
//    (32 lanes on neighbouring columns) into a per-warp shared tile padded
//    to 33 columns, in 32 × 32 quadrants; each lane then takes its row
//    from the tile. The store goes back the same way, one row per
//    instruction, zeros above the diagonal.
// 2. Column entries by a broadcast: each step writes its column (one
//    entry per lane) into a per-warp buffer (two buffers, alternating,
//    so one __syncwarp a step suffices), and every lane reads the entries
//    it needs as 16-byte vectors.
// 3. A lookahead step: step j updates column j + 1 first, then takes the
//    pivot of step j + 1 (a shuffle from its lane) and starts its square
//    root and division, and only then finishes the rest of step j's
//    trailing update, so the next pivot's chain overlaps that work where
//    a lane's item takes at most 384 bytes of registers (float32 at any
//    s, float64 and complex64 at s ≤ 32, complex128 at s ≤ 16); the
//    others keep the plain order, where fewer values are live at the
//    pivot. complex128 with s > 32 holds 96 entries (1,536 bytes) a lane
//    and spills whatever the order (chip_smoke.py prints ptxas's counts).
//    Every entry still takes the same sub_rn(x, mul_rn(col_r,
//    conj(col_c))) in increasing j. A lane updates its whole row: the entries of a row
//    above the diagonal are never read and are stored as zeros, so no
//    branch splits a step.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE square root,
// division and NaN handling are part of the contract).

#include <cuda_runtime.h>

#include "cx.cuh"

namespace {

// warps, so items, per CTA
template <typename T>
__host__ __device__ constexpr int items_per_cta() {
  return sizeof(T) == 16 ? 2 : 4;
}
constexpr int kMaxS = 64;
constexpr int kLd = 33;                // the staging tile's row length
constexpr unsigned kFull = 0xFFFFFFFFu;

using cx::mul_rn;
using cx::sub_rn;
using cx::sqrt_rn;

// 16 bytes of entries, for the column buffer's vector loads
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<Cx<float>> { using type = float4; };
template <> struct Vec16<Cx<double>> { using type = double2; };
template <typename T> struct Part;
template <> struct Part<float> {
  __device__ static float get(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
};
template <> struct Part<double> {
  __device__ static double get(const double2& v, int k) {
    return k == 0 ? v.x : v.y;
  }
};
template <> struct Part<Cx<float>> {
  __device__ static Cx<float> get(const float4& v, int k) {
    return k == 0 ? Cx<float>(v.x, v.y) : Cx<float>(v.z, v.w);
  }
};
template <> struct Part<Cx<double>> {
  __device__ static Cx<double> get(const double2& v, int) {
    return Cx<double>(v.x, v.y);
  }
};

// one warp's shared memory: the staging tile and two column buffers
template <typename T, int kS>
struct __align__(16) WarpSmem {
  T tile[32 * kLd];
  T col[2][kS];
};

template <typename T, int kS>
struct Item {
  static constexpr int kHalves = kS > 32 ? 2 : 1;
  static constexpr int kQ = kS < 32 ? kS : 32;  // rows/columns of a quadrant
  T m0[kQ];                                     // row lane, columns 0 … kQ−1
  T m1[kHalves == 2 ? kS : 1];                  // row lane + 32, columns 0 … 63
};

// quadrant (rb, cb) of the item into dst[32·cb …]: the warp reads row
// 32·rb + i in instruction i, then lane l takes row 32·rb + l from the tile
template <typename T, int kQ>
__device__ __forceinline__ void load_quadrant(T* tile, const T* src, int s,
                                              long long rs, long long cs,
                                              int rb, int cb, int lane,
                                              T* dst) {
  const int c = 32 * cb + lane;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int r = 32 * rb + i;
    tile[i * kLd + lane] =
        r < s && c <= r ? src[r * rs + c * cs] : T(0);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kQ; ++k) dst[k] = lane < kQ ? tile[lane * kLd + k] : T(0);
  __syncwarp();
}

// quadrant (rb, cb) from src[32·cb …] (lane l's row 32·rb + l) to the
// output, one row per instruction, zeros above the diagonal
template <typename T, int kQ>
__device__ __forceinline__ void store_quadrant(T* tile, T* dst, int s, int rb,
                                               int cb, int lane,
                                               const T* src) {
#pragma unroll
  for (int k = 0; k < kQ; ++k)
    tile[lane * kLd + k] = 32 * cb + k <= 32 * rb + lane ? src[k] : T(0);
  __syncwarp();
  const int c = 32 * cb + lane;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int r = 32 * rb + i;
    if (r < s && c < s) dst[r * s + c] = tile[i * kLd + lane];
  }
  __syncwarp();
}

// step k's pivot re(d[k][k]) (a shuffle from lane k mod 32), its guard,
// root and column at rows r0 and r1
template <typename T, int kS>
__device__ __forceinline__ void pivot(const Item<T, kS>& it, int k, int s,
                                      int r0, int r1, int& first_bad, T& c0,
                                      T& c1) {
  using It = Item<T, kS>;
  using R = real_t<T>;
  const R d = k < 32
      ? __shfl_sync(kFull, cx::real_part(it.m0[k < It::kQ ? k : 0]), k)
      : __shfl_sync(kFull, cx::real_part(it.m1[It::kHalves == 2 ? k : 0]),
                    k - 32);
  const bool bad = isnan(d) || d <= R(0);
  if (bad && first_bad == 0 && k < s) first_bad = k + 1;
  const R root = sqrt_rn(bad ? R(1) : d);
  c0 = k < It::kQ ? (r0 > k ? cx::div_real_rn(it.m0[k < It::kQ ? k : 0], root)
                            : (r0 == k ? T(root) : T(0)))
                  : T(0);  // rows r0 < 32 ≤ k
  if (It::kHalves == 2)
    c1 = r1 > k ? cx::div_real_rn(it.m1[It::kHalves == 2 ? k : 0], root)
                : (r1 == k ? T(root) : T(0));
}

template <typename T, int kS>
__global__ void __launch_bounds__(32 * items_per_cta<T>())
chol_tile_batched_kernel(const T* __restrict__ a, T* __restrict__ l,
                         int* __restrict__ info, int B, int s, long long bs,
                         long long rs, long long cs) {
  using It = Item<T, kS>;
  constexpr int kH = It::kHalves, kQ = It::kQ;
  constexpr int kV = 16 / sizeof(T);
  constexpr int kItems = items_per_cta<T>();
  // the lookahead where a lane's item takes at most 384 bytes: the f64
  // kS = 64 instance holds 96 doubles a lane, and there step j + 1's pivot
  // waits for the end of step j, where fewer values are live, so it does
  // not spill (ptxas: 255 registers, no spill; with the lookahead it
  // spills 480 bytes)
  constexpr bool kLookahead =
      (kQ + (kH == 2 ? kS : 0)) * sizeof(T) <= 384;
  using V = typename Vec16<T>::type;
  __shared__ WarpSmem<T, kS> smem[kItems];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * kItems + warp;
  if (item >= B) return;  // the whole warp leaves together
  WarpSmem<T, kS>& sm = smem[warp];
  const T* src = a + item * bs;
  const int r0 = lane, r1 = lane + 32;

  It it;
  load_quadrant<T, kQ>(sm.tile, src, s, rs, cs, 0, 0, lane, it.m0);
  if (kH == 2) {
    load_quadrant<T, kQ>(sm.tile, src, s, rs, cs, 1, 0, lane, it.m1);
    load_quadrant<T, kQ>(sm.tile, src, s, rs, cs, 1, 1, lane,
                         it.m1 + (kH == 2 ? 32 : 0));
  }

  int first_bad = 0;
  if (s > 0) {  // the column steps
    T col0, col1 = T(0);  // step j's column at rows r0 and r1
    pivot<T, kS>(it, 0, s, r0, r1, first_bad, col0, col1);
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      if (j < kQ) it.m0[j < kQ ? j : 0] = col0;
      if (kH == 2) it.m1[kH == 2 ? j : 0] = col1;
      if (j + 1 == kS) break;
      const int k = j + 1;
      T* buf = sm.col[j & 1];
      if (kS >= 32 || lane < kS) buf[lane] = col0;
      if (kH == 2) buf[lane + 32] = col1;
      __syncwarp();
      // column j + 1 takes step j first. Every lane updates its whole row:
      // on a row r ≤ j these are entries above the diagonal, which no
      // step reads and the store replaces by zeros, and no branch splits
      // the step
      const T ck = cx::conj(buf[k]);
      if (k < kQ)
        it.m0[k < kQ ? k : 0] = sub_rn(it.m0[k < kQ ? k : 0], mul_rn(col0, ck));
      if (kH == 2)
        it.m1[kH == 2 ? k : 0] = sub_rn(it.m1[kH == 2 ? k : 0],
                                        mul_rn(col1, ck));
      // then step j + 1's pivot, root and column
      T next0, next1 = T(0);
      if (kLookahead) pivot<T, kS>(it, k, s, r0, r1, first_bad, next0, next1);
      // then the rest of step j's trailing update, columns j + 2 …
#pragma unroll
      for (int g = (j + 2) / kV; g < kS / kV; ++g) {
        const V v = reinterpret_cast<const V*>(buf)[g];
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const int c = g * kV + e;
          if (c < j + 2) continue;
          const T cc = cx::conj(Part<T>::get(v, e));
          if (c < kQ)
            it.m0[c < kQ ? c : 0] = sub_rn(it.m0[c < kQ ? c : 0],
                                           mul_rn(col0, cc));
          if (kH == 2)
            it.m1[kH == 2 ? c : 0] = sub_rn(it.m1[kH == 2 ? c : 0],
                                            mul_rn(col1, cc));
        }
      }
      if (!kLookahead) pivot<T, kS>(it, k, s, r0, r1, first_bad, next0, next1);
      col0 = next0;
      col1 = next1;
    }
  }

  T* dst = l + item * s * s;
  store_quadrant<T, kQ>(sm.tile, dst, s, 0, 0, lane, it.m0);
  if (kH == 2) {
    if (32 + lane < s)
      for (int i = 0; i < 32; ++i) dst[i * s + 32 + lane] = T(0);  // above
    store_quadrant<T, kQ>(sm.tile, dst, s, 1, 0, lane, it.m1);
    store_quadrant<T, kQ>(sm.tile, dst, s, 1, 1, lane, it.m1 + (kH == 2 ? 32 : 0));
  }
  if (lane == 0) info[item] = first_bad;
}

template <typename T>
int chol_tile_batched(const void* a, void* l, void* info, int B, int s,
                      long long bs, long long rs, long long cs,
                      void* stream) {
  if (B < 1 || s < 1 || s > kMaxS) return (int)cudaErrorInvalidValue;
  constexpr int kItems = items_per_cta<T>(), kThreads = 32 * kItems;
  const unsigned grid = (unsigned)((B + kItems - 1) / kItems);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(a);
  T* y = static_cast<T*>(l);
  int* f = static_cast<int*>(info);
  if (s <= 16)
    chol_tile_batched_kernel<T, 16><<<grid, kThreads, 0, st>>>(x, y, f, B, s,
                                                               bs, rs, cs);
  else if (s <= 32)
    chol_tile_batched_kernel<T, 32><<<grid, kThreads, 0, st>>>(x, y, f, B, s,
                                                               bs, rs, cs);
  else
    chol_tile_batched_kernel<T, 64><<<grid, kThreads, 0, st>>>(x, y, f, B, s,
                                                               bs, rs, cs);
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

int slate_chol_tile_batched_c64(const void* a, void* l, void* info, int B,
                                int s, long long bs, long long rs,
                                long long cs, void* stream) {
  return chol_tile_batched<Cx<float>>(a, l, info, B, s, bs, rs, cs, stream);
}

int slate_chol_tile_batched_c128(const void* a, void* l, void* info, int B,
                                 int s, long long bs, long long rs,
                                 long long cs, void* stream) {
  return chol_tile_batched<Cx<double>>(a, l, info, B, s, bs, rs, cs, stream);
}

const char* slate_chol_tile_batched_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
