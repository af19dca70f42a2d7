// Inverses of a (B, s, s) stack of lower-triangular leaves, s ≤ 64:
// X_b = L_b⁻¹, unit or non-unit diagonal, in float32, float64, complex64
// and complex128.
//
// No Pallas kernel: this is the port's counterpart of the fused program
// the reference builds for the same work, _trtri_unrolled_u under jax.vmap
// (slate_tpu/ops/blocked.py::trtri_lower_batched and _trtri_unrolled_u),
// with the contract of the plain version hopper_ops.trtri_leaves_plain:
// only the lower triangle of each leaf is read (the diagonal too unless
// unit), and the strict upper triangle of each X_b is written as zeros.
//
// Design. One block per leaf. The leaf's lower triangle is read once
// through the batch, row and column strides the launcher is given (so the
// diagonal blocks of a larger matrix, and transposed views, need no copy)
// into shared memory. Column j of X is a forward substitution on e_j and
// the columns are independent, so thread j owns column j and keeps it in
// shared memory: for row i ≥ j,
//     X[i][j] = (δᵢⱼ − Σ_{k<i} L[i][k]·X[k][j]) / L[i][i]
// (no division when unit), with X[k][j] = 0 above the diagonal, which is
// the plain version's row substitution taken column by column. At each i
// the threads of a warp read the same L[i][k] (a broadcast) and their own
// X[k][j] (consecutive addresses), and no thread reads another's column,
// so the substitution needs no barrier. A zero diagonal entry gives
// non-finite entries in the same places as the plain version's (the sum
// runs over the same k < i).
//
// What bounds it: the s serial rows of the substitution (about s²/2
// dependent multiply-adds per thread), not the bytes (a leaf read once and
// its inverse written once) nor the s³/3 operations. A first, simple
// kernel; PERF.md keeps its times.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math.

#include <cuda_runtime.h>

namespace {

template <typename R>
struct alignas(2 * sizeof(R)) Cx {  // torch's complex layout
  R re, im;
};

template <typename T>
struct Ops {
  __device__ static T zero() { return T(0); }
  __device__ static T one() { return T(1); }
  __device__ static T fma(T a, T b, T c) { return a * b + c; }
  __device__ static T neg(T a) { return -a; }
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T div(T a, T b) { return a / b; }
};

template <typename R>
struct Ops<Cx<R>> {
  using T = Cx<R>;
  __device__ static T zero() { return {R(0), R(0)}; }
  __device__ static T one() { return {R(1), R(0)}; }
  __device__ static T fma(T a, T b, T c) {
    return {a.re * b.re - a.im * b.im + c.re, a.re * b.im + a.im * b.re + c.im};
  }
  __device__ static T neg(T a) { return {-a.re, -a.im}; }
  __device__ static T add(T a, T b) { return {a.re + b.re, a.im + b.im}; }
  __device__ static T div(T a, T b) {  // a·conj(b) / |b|²
    const R d = b.re * b.re + b.im * b.im;
    return {(a.re * b.re + a.im * b.im) / d, (a.im * b.re - a.re * b.im) / d};
  }
};

constexpr int kMaxLeaf = 64;

template <typename T>
__global__ void trtri_leaves_kernel(const T* __restrict__ l, T* __restrict__ x,
                                    int s, long long sb, long long sr,
                                    long long sc, int unit) {
  using O = Ops<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lsh = reinterpret_cast<T*>(smem_raw);  // s × s, the lower triangle
  T* xsh = lsh + s * s;                      // s × s, X by columns' threads
  const T* src = l + (long long)blockIdx.x * sb;
  for (int e = threadIdx.x; e < s * s; e += blockDim.x) {
    const int i = e / s, k = e - i * s;
    lsh[e] = k <= i ? src[i * sr + k * sc] : O::zero();
    xsh[e] = O::zero();
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j < s) {
    for (int i = j; i < s; ++i) {
      T acc = O::zero();
      const T* lrow = lsh + i * s;
      for (int k = 0; k < i; ++k) acc = O::fma(lrow[k], xsh[k * s + j], acc);
      T v = O::neg(acc);
      if (i == j) v = O::add(v, O::one());
      xsh[i * s + j] = unit ? v : O::div(v, lrow[i]);
    }
  }
  __syncthreads();
  T* dst = x + (long long)blockIdx.x * s * s;
  for (int e = threadIdx.x; e < s * s; e += blockDim.x) dst[e] = xsh[e];
}

template <typename T>
int trtri_leaves(const void* l, void* x, int batch, int s, long long sb,
                 long long sr, long long sc, int unit, void* stream) {
  if (batch < 0 || s < 1 || s > kMaxLeaf) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t smem = 2 * (size_t)s * s * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      trtri_leaves_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (s + 31) / 32 * 32;
  trtri_leaves_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
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
