// Inverses of a (B, s, s) stack of lower-triangular leaves, s ≤ 64:
// X_b = L_b⁻¹, unit or non-unit diagonal, in float32, float64, complex64
// and complex128.
//
// No Pallas kernel: this is the port's counterpart of the fused program
// the reference builds for the same work, _trtri_unrolled_u under jax.vmap
// (slate_tpu/ops/blocked.py::trtri_lower_batched and _trtri_unrolled_u),
// with the contract of the plain version hopper_ops.trtri_leaves_plain:
// only the lower triangle of each leaf is read (not the diagonal when
// unit), and the strict upper triangle of each X_b is written as zeros.
//
// What bounds it. A leaf is 87k multiply-adds at s = 64 and 16 KB (f32):
// neither the operation rate nor the bytes. The factors hand P1 one to
// eight leaves per launch, so what a launch costs is the length of its
// dependent chain. Substituting a whole column (one thread per column) is
// a chain of s rows and about s²/2 dependent multiply-adds, each waiting
// on shared-memory loads, with two warps on the SM to hide it. Tensor
// cores would not shorten that chain and are not used.
//
// Design: one block of 256 threads per leaf, in three steps.
// 1. Load. The leaf's lower triangle (the diagonal too unless unit) is
//    read through the batch, row and column strides the launcher is given,
//    so the diagonal blocks of a larger matrix and transposed views need
//    no copy. Lanes run along whichever of the row and column index has
//    stride 1, so both layouts are read coalesced; every thread issues all
//    its 16 loads into registers before it stores any to shared memory.
//    Rows in shared memory are s | 1 entries apart (odd), so a column of a
//    32-lane warp falls into 32 banks.
// 2. Stage 1: the 8 × 8 diagonal sub-blocks are inverted at once, one
//    thread per column of each (64 threads), by the column substitution
//        X[i][j] = (δᵢⱼ − Σ_{j≤k<i} L[i][k]·X[k][j]) / L[i][i]
//    with the column in registers: a chain of at most 8 rows.
// 3. Stage 2: level by level (t = 8, 16, 32 while t < s), each pair of
//    neighbouring t-blocks is joined by the formula the reference uses
//    above the leaf, inv([[A,0],[B,C]]) = [[iA,0],[−iC·B·iA, iC]], as two
//    products through a scratch block T:
//        T[r][j]      = Σ_{j≤k<t} B[r][k]·iA[k][j]
//        X₂₁[r][j]    = −Σ_{0≤k≤r} iC[r][k]·T[k][j]
//    every pair and every entry at once, a __syncthreads after each
//    product. Lanes run along the rows of B (a) or the columns of T (b),
//    each warp takes a few columns (a) or rows (b) of the pair: so a sum
//    has one range across the warp and loops over no k it does not need,
//    iA[k][j] (a) and iC[r][k] (b) are one broadcast read for the warp,
//    and a thread's 1-4 sums run interleaved. At s = 64 the dependent
//    chain is about 28 + 2·(8 + 16 + 32) multiply-adds instead of about
//    2,080; what is left is mostly the shared-memory reads.
// Every sum runs over the triangles only (k ≥ j in iA, k ≤ r in iC) and
// over real indices only: for s that is not a multiple of 8 or not a power
// of two, the blocks past s are never formed and never read, so nothing
// of them (no 0·Inf) reaches a real entry. A zero diagonal entry at p
// therefore makes exactly the entries in rows ≥ p and columns ≤ p
// non-finite, as in the plain version. The error is of the kind of the
// levels above the leaf (the checks are hopper_ops.LEAF_ENTRY_C's).
//
// The dynamic shared memory attribute is set once per element type and
// device, for the largest leaf, not on every launch.
//
// Complex types take csrc/cx.cuh's arithmetic (the products may contract
// to FMAs; the division is Smith's scaled form, so a large |L[i][i]| does
// not overflow the way a·conj(b)/|b|² does).
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE division, no
// TF32: every product is a full-precision FMA).

#include <cuda_runtime.h>

#include <atomic>

#include "cx.cuh"

namespace {

template <typename T>
struct Ops {
  __device__ static T zero() { return T(0); }
  __device__ static T one() { return T(1); }
  __device__ static T fma(T a, T b, T c) { return a * b + c; }
  __device__ static T neg(T a) { return -a; }
  __device__ static T div(T a, T b) { return cx::div(a, b); }
};

constexpr int kMaxLeaf = 64;
constexpr int kSub = 8;  // stage 1's sub-block
constexpr int kThreads = 256;
constexpr int kLoads = kMaxLeaf * kMaxLeaf / kThreads;  // per thread
// the scratch block T: 32 rows of kT + 1 (one 32-row pair, two 16-row or
// four 8-row ones)
constexpr int kScratch = 32 * 33;

__host__ __device__ inline int row_stride(int s) { return s | 1; }

template <typename T>
size_t smem_bytes(int s) {
  return (2 * (size_t)s * row_stride(s) + kScratch) * sizeof(T);
}

// One combine level at block width kT: X₂₁ of every pair (A, C) with A at
// rows a0 = 2·kT·p and C at c0 = a0 + kT < s. Lane l of every warp works on
// pair p = l / kT (32 / kT pairs at most) and on row (a) or column (b)
// q = l mod kT; warp w takes columns (a) or rows (b) w + 8·m, m < kT / 8.
// So the range of every sum is the same across a warp: its loop runs over
// exactly the k it needs, and the operand that depends only on w and m is
// read once for all lanes.
template <typename T, int kT>
__device__ void combine_level(const T* ls, T* xs, T* ts, int s, int ld) {
  using O = Ops<T>;
  constexpr int kM = kT / kSub;  // columns or rows per warp
  constexpr int kTs = kT + 1;    // T's row stride: odd, rows in distinct banks
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p = lane / kT, q = lane & (kT - 1);
  const int a0 = 2 * kT * p, c0 = a0 + kT;
  T* tp = ts + p * kT * kTs;  // this pair's T
  // (a) T[q][j] = Σ_{j≤k<kT} B[q][k]·iA[k][j] for j = w + 8·m
  {
    const bool live = c0 + q < s;
    const T* brow = live ? ls + (c0 + q) * ld + a0 : ls;
    const T* ia = c0 < s ? xs + a0 * ld + a0 : xs;
    T acc[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) acc[m] = O::zero();
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      if (k >= w) {
        const T b = brow[k];
#pragma unroll
        for (int m = 0; m < kM; ++m)
          if (k >= w + kSub * m)
            acc[m] = O::fma(b, ia[k * ld + w + kSub * m], acc[m]);
      }
    }
    if (live) {
#pragma unroll
      for (int m = 0; m < kM; ++m) tp[q * kTs + w + kSub * m] = acc[m];
    }
  }
  __syncthreads();
  // (b) X₂₁[r][q] = −Σ_{0≤k≤r} iC[r][k]·T[k][q] for r = w + 8·m < s − c0:
  // a row of a ragged C past s is neither read nor written (its address
  // can lie past the shared memory of a small leaf)
  {
    const T* ic = c0 < s ? xs + c0 * ld + c0 : xs;
    const int nr = s - c0;  // C's real rows
    T acc[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) acc[m] = O::zero();
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      if (k <= w + kSub * (kM - 1)) {
        const T t = tp[k * kTs + q];
#pragma unroll
        for (int m = 0; m < kM; ++m)
          if (k <= w + kSub * m && w + kSub * m < nr)
            acc[m] = O::fma(ic[(w + kSub * m) * ld + k], t, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m)
      if (w + kSub * m < nr)
        xs[(c0 + w + kSub * m) * ld + a0 + q] = O::neg(acc[m]);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    trtri_leaves_kernel(const T* __restrict__ l, T* __restrict__ x, int s,
                        long long sb, long long sr, long long sc, int unit) {
  using O = Ops<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = row_stride(s);
  T* ls = reinterpret_cast<T*>(smem_raw);  // L: s rows, ld apart
  T* xs = ls + s * ld;                      // X: s rows, ld apart
  T* ts = xs + s * ld;                      // T: the combine's scratch
  const int tid = threadIdx.x;

  // 1. load the lower triangle, lanes along the unit-stride index
  {
    const T* src = l + (long long)blockIdx.x * sb;
    const bool rows_fast = sc != 1 && sr == 1;
    T v[kLoads];
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int e = tid + m * kThreads;
      const int f = e & (kMaxLeaf - 1), g = e / kMaxLeaf;
      const int i = rows_fast ? f : g, k = rows_fast ? g : f;
      if (i < s && (unit ? k < i : k <= i)) v[m] = src[i * sr + k * sc];
    }
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int e = tid + m * kThreads;
      const int f = e & (kMaxLeaf - 1), g = e / kMaxLeaf;
      const int i = rows_fast ? f : g, k = rows_fast ? g : f;
      if (i < s && (unit ? k < i : k <= i)) ls[i * ld + k] = v[m];
    }
  }
  __syncthreads();

  // 2. the 8 × 8 diagonal sub-blocks, thread (b, jj) on column 8b + jj
  if (tid < kMaxLeaf) {
    const int r0 = (tid / kSub) * kSub, jj = tid & (kSub - 1), j = r0 + jj;
    const int n = min(kSub, s - r0);
    if (jj < n) {
      T xr[kSub];
#pragma unroll
      for (int ii = 0; ii < kSub; ++ii) {
        if (ii >= jj && ii < n) {
          const T* lrow = ls + (r0 + ii) * ld + r0;
          T acc = ii == jj ? O::one() : O::zero();
#pragma unroll
          for (int kk = 0; kk < ii; ++kk)
            if (kk >= jj) acc = O::fma(O::neg(lrow[kk]), xr[kk], acc);
          xr[ii] = unit ? acc : O::div(acc, lrow[ii]);
          xs[(r0 + ii) * ld + j] = xr[ii];
        }
      }
    }
  }
  __syncthreads();

  // 3. join the blocks level by level
  if (s > 8) combine_level<T, 8>(ls, xs, ts, s, ld);
  if (s > 16) combine_level<T, 16>(ls, xs, ts, s, ld);
  if (s > 32) combine_level<T, 32>(ls, xs, ts, s, ld);

  // the lower triangle of X and zeros above it, contiguous
  T* dst = x + (long long)blockIdx.x * s * s;
#pragma unroll
  for (int m = 0; m < kLoads; ++m) {
    const int e = tid + m * kThreads;
    const int j = e & (kMaxLeaf - 1), i = e / kMaxLeaf;
    if (i < s && j < s) dst[i * s + j] = j <= i ? xs[i * ld + j] : O::zero();
  }
}

// The dynamic shared memory limit, raised once per element type and
// device to what the largest leaf needs.
template <typename T>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(trtri_leaves_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<T>(kMaxLeaf));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <typename T>
int trtri_leaves(const void* l, void* x, int batch, int s, long long sb,
                 long long sr, long long sc, int unit, void* stream) {
  if (batch < 0 || s < 1 || s > kMaxLeaf) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const cudaError_t e = allow_smem<T>();
  if (e != cudaSuccess) return (int)e;
  trtri_leaves_kernel<T>
      <<<batch, kThreads, smem_bytes<T>(s), (cudaStream_t)stream>>>(
          static_cast<const T*>(l), static_cast<T*>(x), s, sb, sr, sc, unit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define SLATE_TRTRI_ENTRY(suffix, T)                                         \
  int slate_trtri_leaves_##suffix(const void* l, void* x, int batch, int s,  \
                                  long long sb, long long sr, long long sc,  \
                                  int unit, void* stream) {                  \
    return trtri_leaves<T>(l, x, batch, s, sb, sr, sc, unit, stream);        \
  }

SLATE_TRTRI_ENTRY(f32, float)
SLATE_TRTRI_ENTRY(f64, double)
SLATE_TRTRI_ENTRY(c64, Cx<float>)
SLATE_TRTRI_ENTRY(c128, Cx<double>)

#undef SLATE_TRTRI_ENTRY

const char* slate_trtri_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
