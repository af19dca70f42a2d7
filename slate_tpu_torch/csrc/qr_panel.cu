// Householder QR of one tall (H × w) row-major panel, one thread block:
// K3 qr_panel_base (1 <= w <= 32) and K4 qr_panel_base_wide
// (32 < w <= 128, w % 32 == 0).
//
// Replaces the TPU kernels slate_tpu/ops/pallas_ops.py::qr_panel_base
// (body _qr_panel_kernel) and ::qr_panel_base_wide (bodies
// _qr_panel_wide_kernel, _qr_wide_micro_fori), with the contract of
// slate_tpu/ops/blocked.py::_panel_geqrf_base: returns vr (R on and above
// the diagonal, beta on it, the Householder tails v below) and the w
// LAPACK taus, H_j = I − tau_j·v_j·v_jᵀ, Q = H_0·H_1·…
//
// Per column j (both kernels), with the update confined to the lanes
// j < c < hi (hi = w for K3, the end of the 32-column micro-block for K4):
//  (A) one pass over the rows i > j, one warp per row so that each row is
//      read coalesced (lane l holds a[i, j + l]; x = a[i, j] is lane 0's
//      and reaches the others by a shuffle): sigma = Σ x² and
//      p[c] = Σ x·a[i,c]; per-warp partial sums reduced across warps in a
//      fixed order;
//  (B) the larfg scalars in one thread, IEEE sqrt and division with each
//      product and sum rounded on its own (no FMA contraction):
//      beta = +‖x‖ if alpha <= 0 else −‖x‖, tau = (beta − alpha)/beta,
//      scale = 1/(alpha − beta); a zero tail (sigma == 0) gives tau = 0,
//      scale = 0 and alpha kept on the diagonal; NaN propagates;
//      then w_row[c] = a[j,c] + scale·p[c] (= vᵀ·A[:, c] with v_j = 1);
//  (C) one pass over the rows i >= j: v_i = a[i,j]·scale (v_j = 1),
//      a[i,c] −= (tau·v_i)·w_row[c], column j ← v (beta on the diagonal).
// K4 then updates the lanes right of each micro-block at once by compact
// WY, C ← C − V·(Tᵀ·(Vᵀ·C)): G = VᵀV and Y = VᵀC in one pass over row
// chunks of 32 staged in shared memory; T from LAPACK's forward
// column recurrence T[:i,i] = −tau_i·(T[:i,:i]·G[:i,i]), T[i,i] = tau_i
// (the reference's _larft_base; the TPU kernel reaches the same T by a
// nilpotent fixed point); Z = TᵀY; C −= V·Z, one warp per row. T sees only
// the micro-block's own columns.
//
// What bounds it: the panel's bytes through one SM. The panel (16 MiB at
// 32768×128 f32) cannot live in one SM's shared memory, so it stays in
// global memory (L2-resident) and the trailing lanes are read twice and
// written once per column. Each warp keeps a few rows' loads in flight to
// hide L2 latency. A multi-block version with a grid-wide barrier per
// column, and tensor cores for the compact-WY products, are later work.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE sqrt, division
// and NaN propagation are part of the contract).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 128;              // widest (K4) panel
constexpr int kMB = 32;                 // K3's widest panel, K4's micro-block
constexpr int kMaxTrail = kMaxW - kMB;  // lanes right of a micro-block
constexpr int kTS = kMB + 1;            // padded row stride of T

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }

// rows a warp keeps in flight per loop step
template <typename T>
__host__ __device__ constexpr int row_batch() { return sizeof(T) == 4 ? 8 : 4; }

// shared memory of one block, in elements of T
template <bool kWide>
constexpr int smem_elems() {
  return kWarps * kMaxW      // per-warp partial sums / K4's 32-row tile
         + kMB               // w_row
         + kWarps            // per-warp sigma
         + 4                 // tau, scale, beta_out
         + (kWide ? kMB * kMB + kMB * kTS + 2 * kMB * kMaxTrail : 0);
}

template <typename T>
struct Smem {
  T* buf;
  T* wrow;
  T* sig;
  T* scal;
  T* g;
  T* tm;
  T* y;
  T* z;
  __device__ explicit Smem(T* base) {
    buf = base;
    wrow = buf + kWarps * kMaxW;
    sig = wrow + kMB;
    scal = sig + kWarps;
    g = scal + 4;
    tm = g + kMB * kMB;
    y = tm + kMB * kTS;
    z = y + kMB * kMaxTrail;
  }
};

// One Householder column j; the update reaches the lanes j < c < hi
// (hi − j <= 32). Lane l of a warp holds the row's entry c = j + l.
template <typename T>
__device__ void householder_column(T* __restrict__ vr, T* __restrict__ taus,
                                   int H, int w, int j, int hi,
                                   const Smem<T>& s) {
  constexpr int U = row_batch<T>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int c = j + lane;  // this lane's column
  const bool in = c < hi;

  // (A) sigma and p[c] over the rows below j
  T acc = T(0), sig = T(0);
  for (int i0 = j + 1 + warp; i0 < H; i0 += kWarps * U) {
    T r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kWarps;
      r[u] = (i < H && in) ? vr[(size_t)i * w + c] : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T x = __shfl_sync(0xffffffffu, r[u], 0);
      sig += x * x;
      acc += x * r[u];
    }
  }
  s.buf[warp * kMB + lane] = acc;
  if (lane == 0) s.sig[warp] = sig;
  __syncthreads();

  // (B) larfg scalars (one thread) and the cross-warp sums of p
  if (warp == 0) {
    T t = s.sig[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0) {
      const T alpha = vr[(size_t)j * w + j];
      const T anorm = sqrt(add_rn(mul_rn(alpha, alpha), t));
      const T beta = alpha <= T(0) ? anorm : -anorm;
      const bool degen = t == T(0);
      const T beta_safe = (degen || beta == T(0)) ? T(1) : beta;
      const T denom_safe = degen ? T(1) : sub_rn(alpha, beta);
      s.scal[0] = degen ? T(0) : div_rn(sub_rn(beta, alpha), beta_safe);
      s.scal[1] = degen ? T(0) : div_rn(T(1), denom_safe);
      s.scal[2] = degen ? alpha : beta;
    }
  }
  const bool owns = tid > 0 && tid < kMB && j + tid < hi;  // lane c = j + tid
  if (owns) {
    T p = T(0);
    for (int wp = 0; wp < kWarps; ++wp) p += s.buf[wp * kMB + tid];
    s.wrow[tid] = p;
  }
  __syncthreads();
  const T tau = s.scal[0], scale = s.scal[1], beta_out = s.scal[2];
  if (owns) s.wrow[tid] = vr[(size_t)j * w + j + tid] + scale * s.wrow[tid];
  __syncthreads();

  // (C) scale the tail and apply the reflector to the lanes j < c < hi
  for (int i0 = j + warp; i0 < H; i0 += kWarps * U) {
    T r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kWarps;
      r[u] = (i < H && in) ? vr[(size_t)i * w + c] : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kWarps;
      const T x = __shfl_sync(0xffffffffu, r[u], 0);
      if (i >= H) break;
      const T v = i == j ? T(1) : mul_rn(x, scale);
      const T tv = mul_rn(tau, v);
      if (lane > 0 && in)
        vr[(size_t)i * w + c] = sub_rn(r[u], mul_rn(tv, s.wrow[lane]));
      else if (lane == 0)
        vr[(size_t)i * w + j] = i == j ? beta_out : v;
    }
  }
  if (tid == 0) taus[j] = tau;
  __syncthreads();
}

// K4: C ← C − V·(Tᵀ·(Vᵀ·C)) for the lanes right of the micro-block m0.
template <typename T>
__device__ void reflect_trailing(T* __restrict__ vr, const T* __restrict__ taus,
                                 int H, int w, int m0, const Smem<T>& s) {
  constexpr int U = row_batch<T>() / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hi = m0 + kMB, nc = w - hi, wm = w - m0;
  constexpr int kYPer = kMB * kMaxTrail / kThreads;  // Y entries per thread

  // G = VᵀV (one entry per thread) and Y = VᵀC over 32-row chunks
  const int g1 = tid >> 5, g2 = tid & 31;
  T gacc = T(0), yacc[kYPer];
#pragma unroll
  for (int q = 0; q < kYPer; ++q) yacc[q] = T(0);
  T* tile = s.buf;  // [32][kMaxW]: 32 unit-lower V columns, then C
  for (int r0 = m0; r0 < H; r0 += 32) {
    for (int e = tid; e < 32 * wm; e += kThreads) {
      const int rr = e / wm, cc = e - rr * wm, i = r0 + rr;
      T val = T(0);
      if (i < H) {
        val = vr[(size_t)i * w + m0 + cc];
        if (cc < kMB) val = i > m0 + cc ? val : (i == m0 + cc ? T(1) : T(0));
      }
      tile[rr * kMaxW + cc] = val;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < 32; ++rr)
      gacc += tile[rr * kMaxW + g1] * tile[rr * kMaxW + g2];
#pragma unroll
    for (int q = 0; q < kYPer; ++q) {
      const int e = tid + q * kThreads;
      if (e < kMB * nc) {
        const int k = e / nc, c = e - k * nc;
#pragma unroll 8
        for (int rr = 0; rr < 32; ++rr)
          yacc[q] += tile[rr * kMaxW + k] * tile[rr * kMaxW + kMB + c];
      }
    }
    __syncthreads();
  }
  s.g[g1 * kMB + g2] = gacc;
#pragma unroll
  for (int q = 0; q < kYPer; ++q) {
    const int e = tid + q * kThreads;
    if (e < kMB * nc) s.y[e] = yacc[q];
  }
  for (int e = tid; e < kMB * kTS; e += kThreads) s.tm[e] = T(0);
  __syncthreads();

  // T by LAPACK's forward column recurrence (larft)
  for (int i = 0; i < kMB; ++i) {
    const T ti = taus[m0 + i];
    if (tid < i) {
      T d = T(0);
      for (int l = 0; l < i; ++l) d += s.tm[tid * kTS + l] * s.g[l * kMB + i];
      s.tm[tid * kTS + i] = -ti * d;
    } else if (tid == i) {
      s.tm[i * kTS + i] = ti;
    }
    __syncthreads();
  }

  // Z = TᵀY
  for (int e = tid; e < kMB * nc; e += kThreads) {
    const int k = e / nc, c = e - k * nc;
    T d = T(0);
    for (int l = 0; l < kMB; ++l) d += s.tm[l * kTS + k] * s.y[l * nc + c];
    s.z[e] = d;
  }
  __syncthreads();

  // C −= V·Z over the rows >= m0, one warp per row, lane k holds V[i, k]
  for (int i0 = m0 + warp; i0 < H; i0 += kWarps * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kWarps;
      if (i >= H) break;
      T* row = vr + (size_t)i * w;
      const int kc = m0 + lane;
      const T vk = i > kc ? row[kc] : (i == kc ? T(1) : T(0));
      for (int c = lane; c < nc; c += 32) {
        T d = T(0);
#pragma unroll
        for (int k = 0; k < kMB; ++k)
          d += __shfl_sync(0xffffffffu, vk, k) * s.z[k * nc + c];
        row[hi + c] = sub_rn(row[hi + c], d);
      }
    }
  }
  __syncthreads();
}

template <typename T>
__device__ void copy_panel(const T* __restrict__ a, T* __restrict__ vr,
                           int H, int w) {
  const size_t cells = (size_t)H * w;
  for (size_t k = threadIdx.x; k < cells; k += kThreads) vr[k] = a[k];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qr_panel_kernel(const T* __restrict__ a, T* __restrict__ vr,
                T* __restrict__ taus, int H, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(reinterpret_cast<T*>(smem_raw));
  copy_panel(a, vr, H, w);
  for (int j = 0; j < w; ++j) householder_column(vr, taus, H, w, j, w, s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qr_panel_wide_kernel(const T* __restrict__ a, T* __restrict__ vr,
                     T* __restrict__ taus, int H, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(reinterpret_cast<T*>(smem_raw));
  copy_panel(a, vr, H, w);
  for (int m0 = 0; m0 < w; m0 += kMB) {
    const int hi = m0 + kMB;
    for (int j = m0; j < hi; ++j) householder_column(vr, taus, H, w, j, hi, s);
    if (hi < w) reflect_trailing(vr, taus, H, w, m0, s);
  }
}

template <typename T, bool kWide>
int qr_panel(const void* a, void* vr, void* taus, int H, int w, void* stream) {
  if (w <= 0 || H < w) return (int)cudaErrorInvalidValue;
  if (kWide ? (w <= kMB || w > kMaxW || w % kMB != 0) : w > kMB)
    return (int)cudaErrorInvalidValue;
  auto kernel = kWide ? qr_panel_wide_kernel<T> : qr_panel_kernel<T>;
  const int smem = smem_elems<kWide>() * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(vr), static_cast<T*>(taus),
      H, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_qr_panel_f32(const void* a, void* vr, void* taus, int H, int w,
                       void* stream) {
  return qr_panel<float, false>(a, vr, taus, H, w, stream);
}

int slate_qr_panel_f64(const void* a, void* vr, void* taus, int H, int w,
                       void* stream) {
  return qr_panel<double, false>(a, vr, taus, H, w, stream);
}

int slate_qr_panel_wide_f32(const void* a, void* vr, void* taus, int H, int w,
                            void* stream) {
  return qr_panel<float, true>(a, vr, taus, H, w, stream);
}

int slate_qr_panel_wide_f64(const void* a, void* vr, void* taus, int H, int w,
                            void* stream) {
  return qr_panel<double, true>(a, vr, taus, H, w, stream);
}

const char* slate_qr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
