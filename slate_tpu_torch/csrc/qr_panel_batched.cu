// Householder QR of every (H, w) panel of a (B, H, w) stack, w ≤ H and
// w ≤ 128, in float32 and float64 → the packed V\R of each item (R on and
// above the diagonal, the reflectors' tails below it, their unit heads
// implied) in a contiguous (B, H, w) stack, and the taus in a (B, w) one.
// The input is read through its batch, row and column strides.
//
// No Pallas kernel: this is the port's counterpart of the reference's
// batched panel, slate_tpu/ops/blocked.py::_panel_geqrf_batched (a
// fori_loop of w Householder steps over the whole stack), with the
// contract of the plain version hopper_ops.qr_panel_batched_plain. Column
// j of each item takes LAPACK's larfg of [alpha; x] = its entries on and
// below the diagonal, sig = ‖x‖²,
//     beta  = alpha ≤ 0 ? +sqrt(alpha² + sig) : −sqrt(alpha² + sig),
//     tau   = (beta − alpha) / beta,   v = [1; x / (alpha − beta)],
// a degenerate column (sig = 0) keeping alpha with tau = 0 and v = [1; 0],
// then the columns right of j take the reflector:
//     w_row[c] = Σ_{r ≥ j} v[r]·a[r][c],   a[r][c] −= (tau·v[r])·w_row[c].
// Items never mix, so a NaN stays in its item (its columns from the NaN
// on turn NaN, as in the plain version).
//
// What bounds it. An item is 2Hw² − 2w³/3 operations on H·w entries: at
// the engine's shapes (B = 1000 panels of 512 × 32, B = 10000 of 64 × 32)
// neither the bytes nor the operation rate, but each item's w dependent
// steps, each a reduction over the panel's height and a rank-1 update.
//
// Design: one CTA of 256 threads per item, the item resident in shared
// memory (rows w + 1 entries apart, so a warp reading down a column hits
// distinct banks) when hopper_ops.qr_panel_batched_plan says it fits, else
// worked in place in the output stack in global memory; the plan's shared
// memory is this file's smem_bytes. Per column:
// 1. sig: each thread sums the squares of its rows (r = j + 1 + tid,
//    + 256, …) in row order, each warp by one butterfly, then every thread
//    adds the 8 warp sums in warp order: one fixed order, so every thread
//    takes the same larfg scalars;
// 2. the tail of column j is scaled into v in place;
// 3. w_row: warp k takes the columns j + 1 + k, + 8, …, its lanes the
//    rows j + lane, + 32, … (v[j] = 1), one butterfly per column;
// 4. the rank-1 update of the trailing (H − j) × (w − j − 1) block, the
//    entries dealt to the threads in row-major order (index arithmetic by
//    increments, no division per entry); thread 0 writes beta and tau.
// Four __syncthreads a column. Products and sums may contract to FMAs: the
// kernel is held to its plain version within a tolerance, not bitwise.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE square root and
// division, NaN propagation).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

// shared memory per CTA (hopper_ops.qr_panel_batched_smem_bytes): the item
// when resident, then w_row and the warps' partial sums
long long smem_bytes(int H, int w, int resident, int itemsize) {
  const long long item = resident ? (long long)H * (w + 1) : 0;
  return (item + w + kWarps) * itemsize;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qr_panel_batched_kernel(const T* __restrict__ a, T* __restrict__ vr,
                        T* __restrict__ taus, int H, int w, long long bs,
                        long long rs, long long cs, int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long item = blockIdx.x;
  const int hw = H * w;
  const T* src = a + item * bs;
  T* out = vr + item * hw;
  T* m = resident ? sh : out;     // the item being factored
  const int ld = resident ? w + 1 : w;  // the launcher holds H·w < 2³¹
  T* wrow = sh + (resident ? (long long)H * (w + 1) : 0);
  T* part = wrow + w;

  for (int e = tid; e < hw; e += kThreads) {
    const int r = e / w, c = e % w;
    m[r * ld + c] = src[r * rs + c * cs];
  }
  __syncthreads();

  for (int j = 0; j < w; ++j) {
    T p = T(0);
    for (int r = j + 1 + tid; r < H; r += kThreads) {
      const T x = m[r * ld + j];
      p += x * x;
    }
    p = warp_sum(p);
    if (lane == 0) part[warp] = p;
    __syncthreads();
    T sig = T(0);
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sig += part[k];
    const T alpha = m[j * ld + j];
    const T anorm = sqrt(alpha * alpha + sig);
    const T beta = alpha <= T(0) ? anorm : -anorm;
    const bool degen = sig == T(0);
    const T beta_safe = degen || beta == T(0) ? T(1) : beta;
    const T denom_safe = degen ? T(1) : alpha - beta;
    const T tau = degen ? T(0) : (beta - alpha) / beta_safe;
    const T scale = degen ? T(0) : T(1) / denom_safe;
    for (int r = j + 1 + tid; r < H; r += kThreads)
      m[r * ld + j] *= scale;
    __syncthreads();  // v in column j; alpha read by every thread

    for (int c = j + 1 + warp; c < w; c += kWarps) {
      T q = T(0);
      for (int r = j + lane; r < H; r += 32)
        q += (r == j ? T(1) : m[r * ld + j]) * m[r * ld + c];
      q = warp_sum(q);
      if (lane == 0) wrow[c] = q;
    }
    if (tid == 0) {
      m[j * ld + j] = degen ? alpha : beta;
      taus[item * w + j] = tau;
    }
    __syncthreads();  // w_row complete

    const int nc = w - j - 1;
    if (nc > 0) {  // entry e = (r − j)·nc + (c − j − 1), stepped by kThreads
      int r = j + tid / nc, c = tid % nc;
      const int dr = kThreads / nc, dc = kThreads % nc;
      for (int e = tid; e < (H - j) * nc; e += kThreads) {
        const T v = r == j ? T(1) : m[r * ld + j];
        m[r * ld + j + 1 + c] -= (tau * v) * wrow[j + 1 + c];
        r += dr;
        c += dc;
        if (c >= nc) {
          c -= nc;
          ++r;
        }
      }
    }
    __syncthreads();  // column j + 1 updated before its norm
  }

  if (resident)
    for (int e = tid; e < hw; e += kThreads) out[e] = sh[(e / w) * ld + e % w];
}

template <typename T>
int qr_panel_batched(const void* a, void* vr, void* taus, int B, int H, int w,
                     long long bs, long long rs, long long cs, int resident,
                     void* stream) {
  if (B < 1 || w < 1 || w > kMaxW || H < w || (long long)H * w > INT_MAX)
    return (int)cudaErrorInvalidValue;  // rows and columns index as int
  const long long smem = smem_bytes(H, w, resident, sizeof(T));
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(qr_panel_batched_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  qr_panel_batched_kernel<T><<<(unsigned)B, kThreads, (size_t)smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(vr), static_cast<T*>(taus), H,
      w, bs, rs, cs, resident);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_qr_panel_batched_f32(const void* a, void* vr, void* taus, int B,
                               int H, int w, long long bs, long long rs,
                               long long cs, int resident, void* stream) {
  return qr_panel_batched<float>(a, vr, taus, B, H, w, bs, rs, cs, resident,
                                 stream);
}

int slate_qr_panel_batched_f64(const void* a, void* vr, void* taus, int B,
                               int H, int w, long long bs, long long rs,
                               long long cs, int resident, void* stream) {
  return qr_panel_batched<double>(a, vr, taus, B, H, w, bs, rs, cs, resident,
                                  stream);
}

// the shared memory per CTA that the launcher sizes a plan with, so the
// plan's copy of the formula can be held against it
long long slate_qr_panel_batched_smem_bytes(int H, int w, int resident,
                                            int itemsize) {
  return smem_bytes(H, w, resident, itemsize);
}

const char* slate_qr_panel_batched_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
