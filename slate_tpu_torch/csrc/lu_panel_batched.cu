// Partial-pivot LU of every (H × w) chunk of a contiguous row-major
// (B, H, w) stack, w ≤ H: one thread block per chunk, the whole stack in
// one launch, so one launch is one round of the CALU tournament.
//
// No Pallas kernel: replaces the reference's one batched program per
// tournament round, slate_tpu/ops/blocked.py::panel_getrf_batched (body
// _panel_getrf_batched_impl, a fori_loop of w column steps over every
// chunk at once), with its contract per chunk, which is
// _panel_getrf_base's: lu (L below the diagonal with unit diagonal
// implied, U on and above), a gather perm with chunk[perm] = L·U, and
// info = 1-based index of the first zero or NaN pivot (0 if none; that
// column divides by 1 instead).
//
// Design. Block b copies chunk b into lu and factors it there, in global
// memory (a tournament round's stack is at most 32 MB in f32 at nb = 512,
// which the 50 MB L2 mostly holds). Per column j:
//  (1) the block argmax of |lu[i, j]| over the rows i ≥ j, under
//      jnp.argmax's rule (NaN is the maximum, ties go to the lowest row;
//      beats() is a total order on (value, row), so any reduction order
//      gives the same p). Each warp's candidates come from the previous
//      column's update, which wrote column j;
//  (2) rows j and p and their perm entries swap, and the new row j (the
//      U row) is kept in shared memory;
//  (3) one warp per row below j: the multiplier l = lu[i, j] / pivot
//      (the pivot taken as 1 when it is zero or NaN), then
//      lu[i, c] −= l·u[c] for c > j, lanes along the row; lane 0 keeps
//      the row's new |lu[i, j + 1]| as its warp's candidate for (1).
// Products and differences are rounded separately (mul_rn/sub_rn, no FMA
// contraction) and the scale is an IEEE division, so lu, perm and info
// are bitwise the plain PyTorch version's
// (hopper_ops.lu_panel_batched_plain), as csrc/lu_panel.cu is K2's.
//
// What bounds it: each chunk's Σⱼ (H − j)(w − j) trailing entries are
// read and written once per column step through one SM's path to L2
// (about 0.9 GB at 1024 × 512 f32), not the card's operations or HBM
// bytes, and a round with few chunks uses few SMs. A thread-block cluster
// per chunk (the chunk in distributed shared memory) and a width
// recursion onto a narrow batched base are the redesigns this leaves for
// later.
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
__global__ void __launch_bounds__(kThreads, 1)
lu_panel_batched_kernel(const T* __restrict__ a, T* __restrict__ lu_all,
                        int* __restrict__ perm_all, int* __restrict__ info,
                        int H, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* urow = reinterpret_cast<T*>(smem_raw);  // the U row of column j
  __shared__ T red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t cells = (size_t)H * w;
  const T* src = a + blockIdx.x * cells;
  T* lu = lu_all + blockIdx.x * cells;
  int* perm = perm_all + (size_t)blockIdx.x * H;

  for (size_t k = tid; k < cells; k += kThreads) lu[k] = src[k];
  for (int i = tid; i < H; i += kThreads) perm[i] = i;
  // column 0's candidates, straight from the input
  T bv = T(-1);
  int bi = INT_MAX;
  for (int i = tid; i < H; i += kThreads) {
    const T v = fabs(src[(size_t)i * w]);
    if (beats(v, i, bv, bi)) { bv = v; bi = i; }
  }
  warp_argmax(bv, bi);
  if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
  int first_bad = 0;

  for (int j = 0; j < w; ++j) {
    __syncthreads();  // column j written, its candidates in red_v/red_i
    // (1) the pivot row
    if (warp == 0) {
      T v = lane < kWarps ? red_v[lane] : T(-1);
      int i = lane < kWarps ? red_i[lane] : INT_MAX;
      warp_argmax(v, i);
      if (lane == 0) s_p = i;
    }
    __syncthreads();
    const int p = s_p;
    // (2) swap rows j and p (p == j writes row j onto itself)
    T* rj = lu + (size_t)j * w;
    T* rp = lu + (size_t)p * w;
    for (int c = tid; c < w; c += kThreads) {
      const T vj = rj[c], vp = rp[c];
      rp[c] = vj;
      rj[c] = vp;
      urow[c] = vp;
    }
    if (tid == 0) {
      const int t = perm[j];
      perm[j] = perm[p];
      perm[p] = t;
    }
    __syncthreads();
    // (3) info, the safe divisor, scale and rank-1 update below row j
    const T d = urow[j];
    const bool bad = isnan(d) || d == T(0);
    if (bad && first_bad == 0) first_bad = j + 1;
    const T dsafe = bad ? T(1) : d;
    bv = T(-1);
    bi = INT_MAX;
    for (int i = j + 1 + warp; i < H; i += kWarps) {
      T* row = lu + (size_t)i * w;
      const T l = div_rn(row[j], dsafe);
#pragma unroll 4
      for (int c = j + 1 + lane; c < w; c += 32)
        row[c] = sub_rn(row[c], mul_rn(l, urow[c]));
      __syncwarp();
      if (lane == 0) {
        row[j] = l;
        if (j + 1 < w) {  // lane 0 wrote column j + 1 of this row
          const T v = fabs(row[j + 1]);
          if (beats(v, i, bv, bi)) { bv = v; bi = i; }
        }
      }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
  }
  if (tid == 0) info[blockIdx.x] = first_bad;
}

template <typename T>
int lu_panel_batched(const void* a, void* lu, void* perm, void* info, int B,
                     int H, int w, void* stream) {
  if (B <= 0 || w <= 0 || H < w) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)w * sizeof(T);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    const cudaError_t e = cudaFuncSetAttribute(
        lu_panel_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lu_panel_batched_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(a), static_cast<T*>(lu), static_cast<int*>(perm),
      static_cast<int*>(info), H, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_lu_panel_batched_f32(const void* a, void* lu, void* perm, void* info,
                               int B, int H, int w, void* stream) {
  return lu_panel_batched<float>(a, lu, perm, info, B, H, w, stream);
}

int slate_lu_panel_batched_f64(const void* a, void* lu, void* perm, void* info,
                               int B, int H, int w, void* stream) {
  return lu_panel_batched<double>(a, lu, perm, info, B, H, w, stream);
}

const char* slate_lu_panel_batched_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
