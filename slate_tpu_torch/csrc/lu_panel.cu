// Partial-pivot LU of one tall (H × w) row-major panel, one thread block.
//
// Replaces the TPU kernel slate_tpu/ops/pallas_ops.py::lu_panel_base
// (body _lu_panel_kernel) with the contract of
// slate_tpu/ops/blocked.py::_panel_getrf_base: returns lu (L below the
// diagonal with unit diagonal implied, U on and above), a gather perm
// with a[perm] = L·U, and info = 1-based index of the first zero or NaN
// pivot (0 if none; that column divides by 1 instead).
//
// Per column j: (1) block-wide argmax of |lu[i, j]| over i >= j with the
// rule of jnp.argmax — NaN is the maximum, ties go to the LOWEST index —
// reduced as (value, index) pairs by warp shuffles and one cross-warp
// pass; (2) swap rows j and p of the panel and of perm; (3) info and the
// safe divisor; (4) scale the column below j; (5) rank-1 update of the
// trailing (H−j−1)×(w−j−1) block, one warp per row so that each row's
// columns are read and written coalesced. Products and differences are
// rounded separately (__fmul_rn/__fsub_rn, no FMA contraction) and the
// scale is an IEEE division, so the result is bitwise the plain
// PyTorch version's for the same input.
//
// What bounds it: the panel's bytes. One block cannot hold an H×w panel
// (8 MiB at 16384×128 f32) in shared memory or registers, so the panel
// stays in global memory (L2-resident) and the trailing block is read
// and written once per column: about H·w²/2 element updates through one
// SM, plus the w serial argmax/barrier steps. A multi-block version with
// a grid-wide barrier per column, holding the panel on chip across SMs,
// is the later, faster design.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE division and
// NaN handling are part of the contract).

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }

// does candidate (va, ia) beat (vb, ib) under jnp.argmax's rule?
template <typename T>
__device__ __forceinline__ bool beats(T va, int ia, T vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

template <typename T>
__device__ __forceinline__ void warp_argmax(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_panel_kernel(const T* __restrict__ a, T* __restrict__ lu,
                int* __restrict__ perm, int* __restrict__ info, int H, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* urow = reinterpret_cast<T*>(smem_raw);  // pivot row, w entries
  __shared__ T red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int first_bad = 0;  // meaningful in thread 0

  const size_t cells = (size_t)H * w;
  for (size_t k = tid; k < cells; k += kThreads) lu[k] = a[k];
  for (int i = tid; i < H; i += kThreads) perm[i] = i;
  __syncthreads();

  for (int j = 0; j < w; ++j) {
    // (1) pivot search
    T bv = T(-1);
    int bi = INT_MAX;
    for (int i = j + tid; i < H; i += kThreads) {
      const T v = fabs(lu[(size_t)i * w + j]);
      if (beats(v, i, bv, bi)) { bv = v; bi = i; }
    }
    warp_argmax(bv, bi);
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) s_p = bi;
    }
    __syncthreads();
    const int p = s_p;
    // (2) row and perm swap
    if (p != j) {
      for (int c = tid; c < w; c += kThreads) {
        const T t = lu[(size_t)j * w + c];
        lu[(size_t)j * w + c] = lu[(size_t)p * w + c];
        lu[(size_t)p * w + c] = t;
      }
      if (tid == 0) {
        const int t = perm[j];
        perm[j] = perm[p];
        perm[p] = t;
      }
    }
    __syncthreads();
    for (int c = tid; c < w; c += kThreads) urow[c] = lu[(size_t)j * w + c];
    __syncthreads();
    // (3) info and safe divisor
    const T d = urow[j];
    const bool bad = isnan(d) || d == T(0);
    if (tid == 0 && bad && first_bad == 0) first_bad = j + 1;
    const T dsafe = bad ? T(1) : d;
    // (4) + (5): scale the column, rank-1 update of the trailing block
    for (int i = j + 1 + warp; i < H; i += kWarps) {
      T* row = lu + (size_t)i * w;
      const T l = div_rn(row[j], dsafe);
      for (int c = j + 1 + lane; c < w; c += 32)
        row[c] = sub_rn(row[c], mul_rn(l, urow[c]));
      __syncwarp();
      if (lane == 0) row[j] = l;
    }
    __syncthreads();
  }
  if (tid == 0) *info = first_bad;
}

template <typename T>
int lu_panel(const void* a, void* lu, void* perm, void* info, int H, int w,
             void* stream) {
  if (w <= 0 || H < w) return (int)cudaErrorInvalidValue;
  lu_panel_kernel<T><<<1, kThreads, (size_t)w * sizeof(T),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(lu), static_cast<int*>(perm),
      static_cast<int*>(info), H, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_lu_panel_f32(const void* a, void* lu, void* perm, void* info,
                       int H, int w, void* stream) {
  return lu_panel<float>(a, lu, perm, info, H, w, stream);
}

int slate_lu_panel_f64(const void* a, void* lu, void* perm, void* info,
                       int H, int w, void* stream) {
  return lu_panel<double>(a, lu, perm, info, H, w, stream);
}

const char* slate_lu_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
