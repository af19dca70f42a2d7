// Householder QR of one tall (H × w) row-major panel: K3 qr_panel_base
// (1 <= w <= 32, one thread block) and K4 qr_panel_base_wide
// (32 < w <= 128, w % 32 == 0, one cooperative launch of G blocks).
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
//
// K3 runs this in one block of 1024 threads with the panel in global
// memory (L2): it is bound by the panel's bytes re-read through one SM,
// twice per column.
//
// K4 spreads the panel over the SMs (grid_panel.cuh): block b owns a row
// slab, held in shared memory (resident mode) or, when it does not fit,
// read in place through L1/L2 (streaming mode). In (A) each block sums its
// own rows and publishes 32 partials (lane 0 is sigma), the owner of row j
// publishes row j's micro lanes, and one grid barrier follows; in (B)
// every block sums the G partials in the same fixed order, with no float
// atomics, so every block takes bitwise the same scalars and w_row; (C)
// runs on each block's own rows. After each micro-block but the last,
// the lanes to its right get the compact-WY update C ← C − V·(Tᵀ·(Vᵀ·C)):
// each block's partial E = Vᵀ·[V | C] over its rows (32 × 128), a barrier,
// block b sums a slice of E's entries over the G partials in a fixed
// order, a second barrier; then every block reads G = VᵀV and Y = VᵀC,
// takes T by LAPACK's forward column recurrence
// T[:i,i] = −tau_i·(T[:i,:i]·G[:i,i]), T[i,i] = tau_i (the reference's
// _larft_base; the TPU kernel reaches the same T by a nilpotent fixed
// point) and Z = TᵀY, and applies C −= V·Z to its own rows. T sees only
// the micro-block's own columns, as in hopper_ops.qr_panel_base_wide_plain.
//
// What bounds K4: the w serial column steps (a grid barrier and a few
// block barriers each) and the 2·(w/32 − 1) barriers of the updates; the
// panel crosses HBM once each way (16 MiB at 32768 × 128 f32), and its
// 2·H·w² flops at 67 TFLOP/s set a 16.0 µs bound. Measured by
// chip_smoke.py on an H100 80GB HBM3 at 700 W: about 1 ms at
// 32768 × 128 f32 (132 resident slabs of 249 rows), against 62.5 ms for
// the one-block version before it; about 1.7–1.8 ms at 32768 × 128 f64
// (streaming). PERF.md keeps the times of each run. FMA loops in the element type;
// tensor cores come later.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE sqrt, division
// and NaN propagation are part of the contract).

#include <cuda_runtime.h>

#include "grid_panel.cuh"

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

// shared memory of one K3 block, in elements of T
constexpr int smem_elems() {
  return kWarps * kMaxW      // per-warp partial sums
         + kMB               // w_row
         + kWarps            // per-warp sigma
         + 4;                // tau, scale, beta_out
}

template <typename T>
struct Smem {
  T* buf;
  T* wrow;
  T* sig;
  T* scal;
  __device__ explicit Smem(T* base) {
    buf = base;
    wrow = buf + kWarps * kMaxW;
    sig = wrow + kMB;
    scal = sig + kWarps;
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

// ---------------------------------------------------------------------------
// K4: one cooperative launch of G blocks (grid_panel.cuh), 512 threads each
// ---------------------------------------------------------------------------

constexpr int kGThreads = grid_panel::kThreads;
constexpr int kGWarps = grid_panel::kWarps;
constexpr int kE = kMB * kMaxW;  // one block's partial E = Vᵀ·[V | C], 32 × 128
constexpr int kZPer = kMB * kMaxTrail / kGThreads;  // Z entries per thread
static_assert(kGThreads == 4 * kMaxW, "E's thread map: 4 groups of 8 k");

// K4's shared memory beside the slab, in elements of T
constexpr int kWideFixed = kMB             // w_row
                           + kMB           // the micro-block's taus
                           + kGWarps * kMB // per-warp partial sums
                           + 8             // tau, scale, beta_out
                           + kMB * kMB     // G = VᵀV
                           + kMB * kTS     // T
                           + kMB * kMaxTrail;  // Y, then Z

// the global scratch, in elements of T: two parities of G + 1 column
// slots of 32 (block partials, then row j's micro lanes), G partial E's
// and the reduced E
__host__ __device__ inline size_t wide_scratch_elems(int G) {
  return 2 * (size_t)(G + 1) * kMB + (size_t)(G + 1) * kE;
}

// V[i, m0 + k] of the unit-lower micro-block from the packed row value x
template <typename T>
__device__ __forceinline__ T vmask(T x, int i, int col) {
  return i > col ? x : (i == col ? T(1) : T(0));
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kGThreads, 1)
qr_wide_kernel(const T* __restrict__ a, T* vr, T* taus, int H, int w, int R,
               T* scratch, unsigned int* bar) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = b * R, r1 = min(H, r0 + R);
  T* wrow = reinterpret_cast<T*>(smem_raw);
  T* mtau = wrow + kMB;
  T* red = mtau + kMB;
  T* scal = red + kGWarps * kMB;
  T* gm = scal + 8;
  T* tm = gm + kMB * kMB;
  T* yz = tm + kMB * kTS;
  T* slab = kResident ? yz + kMB * kMaxTrail : vr + (size_t)r0 * w;
  T* part = scratch + 2 * (size_t)(G + 1) * kMB;
  T* redE = part + (size_t)G * kE;
  unsigned int n_bar = 0;

  const size_t cells = (size_t)(r1 - r0) * w;
  for (size_t k = tid; k < cells; k += kGThreads) slab[k] = a[(size_t)r0 * w + k];
  __syncthreads();

  for (int m0 = 0; m0 < w; m0 += kMB) {
    const int hi = m0 + kMB;
    for (int j = m0; j < hi; ++j) {
      T* cp = scratch + (size_t)(j & 1) * (G + 1) * kMB;
      const int c = j + lane;  // this lane's column
      const bool in = c < hi;
      // (A) this block's sigma (lane 0) and p[c] over its rows i > j
      T acc = T(0);
#pragma unroll 4
      for (int i = max(j + 1, r0) + warp; i < r1; i += kGWarps) {
        const T r = in ? slab[(size_t)(i - r0) * w + c] : T(0);
        acc += __shfl_sync(0xffffffffu, r, 0) * r;
      }
      red[warp * kMB + lane] = acc;
      __syncthreads();
      if (warp == 0) {
        T s = T(0);
        for (int k = 0; k < kGWarps; ++k) s += red[k * kMB + lane];
        cp[b * kMB + lane] = s;
      } else if (warp == 1 && r0 <= j && j < r1) {
        cp[G * kMB + lane] = in ? slab[(size_t)(j - r0) * w + c] : T(0);
      }
      grid_panel::grid_barrier(bar, ++n_bar * G);
      // (B) every block sums the G partials in the same order and takes
      // the same larfg scalars and w_row
      {
        T s = T(0);
        for (int g = warp; g < G; g += kGWarps) s += __ldcg(cp + g * kMB + lane);
        red[warp * kMB + lane] = s;
      }
      __syncthreads();
      if (warp == 0) {
        T t = T(0);
        for (int k = 0; k < kGWarps; ++k) t += red[k * kMB + lane];
        const T arow = __ldcg(cp + G * kMB + lane);  // a[j, c]
        T scale = T(0);
        if (lane == 0) {
          const T alpha = arow;
          const T anorm = sqrt(add_rn(mul_rn(alpha, alpha), t));
          const T beta = alpha <= T(0) ? anorm : -anorm;
          const bool degen = t == T(0);
          const T beta_safe = (degen || beta == T(0)) ? T(1) : beta;
          const T denom_safe = degen ? T(1) : sub_rn(alpha, beta);
          const T tau = degen ? T(0) : div_rn(sub_rn(beta, alpha), beta_safe);
          scale = degen ? T(0) : div_rn(T(1), denom_safe);
          scal[0] = tau;
          scal[1] = scale;
          scal[2] = degen ? alpha : beta;
          mtau[j - m0] = tau;
        }
        scale = __shfl_sync(0xffffffffu, scale, 0);
        if (lane > 0 && in) wrow[lane] = arow + scale * t;
      }
      __syncthreads();
      const T tau = scal[0], scale = scal[1], beta_out = scal[2];
      // (C) the reflector on this block's rows i >= j, v into column j
      for (int i = max(j, r0) + warp; i < r1; i += kGWarps) {
        T* row = slab + (size_t)(i - r0) * w;
        const T r = in ? row[c] : T(0);
        const T x = __shfl_sync(0xffffffffu, r, 0);
        const T v = i == j ? T(1) : mul_rn(x, scale);
        const T tv = mul_rn(tau, v);
        if (lane > 0 && in)
          row[c] = sub_rn(r, mul_rn(tv, wrow[lane]));
        else if (lane == 0)
          row[j] = i == j ? beta_out : v;
      }
      if (b == 0 && tid == 0) taus[j] = tau;
      __syncthreads();
    }
    if (hi >= w) break;

    // compact-WY update of the lanes right of the micro-block:
    // C ← C − V·(Tᵀ·(Vᵀ·C)) on the rows >= m0
    const int wm = w - m0, nc = w - hi;
    {  // this block's partial E[k][cc] = Σ V[i, k]·[V | C][i, cc]
      const int cc = tid % kMaxW, k0 = (tid / kMaxW) * 8;
      T acc[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] = T(0);
      for (int i = max(m0, r0); i < r1; ++i) {
        const T* row = slab + (size_t)(i - r0) * w + m0;
        const T x = cc < kMB ? vmask(row[cc], i, m0 + cc)
                             : (cc < wm ? row[cc] : T(0));
#pragma unroll
        for (int q = 0; q < 8; ++q)
          acc[q] += vmask(row[k0 + q], i, m0 + k0 + q) * x;
      }
      if (cc < wm) {
        T* mine = part + (size_t)b * kE;
#pragma unroll
        for (int q = 0; q < 8; ++q) mine[(k0 + q) * kMaxW + cc] = acc[q];
      }
    }
    grid_panel::grid_barrier(bar, ++n_bar * G);
    {  // block b sums its slice of the 32·wm entries over the G partials
      const int n_e = kMB * wm, per = (n_e + G - 1) / G;
      const int e_lo = min(n_e, b * per), e_hi = min(n_e, e_lo + per);
      for (int e0 = e_lo; e0 < e_hi; e0 += 32) {
        const int e = e0 + lane;
        const int off = e < e_hi ? (e / wm) * kMaxW + e % wm : 0;
        T s = T(0);
        if (e < e_hi)
          for (int g = warp; g < G; g += kGWarps) s += __ldcg(part + (size_t)g * kE + off);
        red[warp * kMB + lane] = s;
        __syncthreads();
        if (warp == 0 && e < e_hi) {
          T t = T(0);
          for (int k = 0; k < kGWarps; ++k) t += red[k * kMB + lane];
          redE[off] = t;
        }
        __syncthreads();
      }
    }
    grid_panel::grid_barrier(bar, ++n_bar * G);
    for (int e = tid; e < kMB * kMB; e += kGThreads)
      gm[e] = __ldcg(redE + (e / kMB) * kMaxW + e % kMB);
    for (int e = tid; e < kMB * nc; e += kGThreads)
      yz[e] = __ldcg(redE + (e / nc) * kMaxW + kMB + e % nc);
    for (int e = tid; e < kMB * kTS; e += kGThreads) tm[e] = T(0);
    __syncthreads();
    // T by LAPACK's forward column recurrence (larft)
    for (int i = 0; i < kMB; ++i) {
      const T ti = mtau[i];
      if (tid < i) {
        T d = T(0);
        for (int l = 0; l < i; ++l) d += tm[tid * kTS + l] * gm[l * kMB + i];
        tm[tid * kTS + i] = -ti * d;
      } else if (tid == i) {
        tm[i * kTS + i] = ti;
      }
      __syncthreads();
    }
    {  // Z = TᵀY, in place of Y
      T z[kZPer];
#pragma unroll
      for (int q = 0; q < kZPer; ++q) {
        const int e = tid + q * kGThreads;
        z[q] = T(0);
        if (e < kMB * nc) {
          const int k = e / nc, cz = e - k * nc;
          for (int l = 0; l < kMB; ++l) z[q] += tm[l * kTS + k] * yz[l * nc + cz];
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kZPer; ++q) {
        const int e = tid + q * kGThreads;
        if (e < kMB * nc) yz[e] = z[q];
      }
      __syncthreads();
    }
    // C −= V·Z on this block's rows >= m0, one warp per row, lane k holds V[i, k]
    for (int i = max(m0, r0) + warp; i < r1; i += kGWarps) {
      T* row = slab + (size_t)(i - r0) * w;
      const T vk = vmask(row[m0 + lane], i, m0 + lane);
      for (int cz = lane; cz < nc; cz += 32) {
        T d = T(0);
#pragma unroll
        for (int k = 0; k < kMB; ++k) d += __shfl_sync(0xffffffffu, vk, k) * yz[k * nc + cz];
        row[hi + cz] = sub_rn(row[hi + cz], d);
      }
    }
    __syncthreads();
  }
  if (kResident)
    for (size_t k = tid; k < cells; k += kGThreads) vr[(size_t)r0 * w + k] = slab[k];
}

template <typename T>
int qr_panel_wide(const void* a, void* vr, void* taus, int H, int w, int G,
                  int R, int resident, void* scratch, void* bar, void* stream) {
  if (H < w || w <= kMB || w > kMaxW || w % kMB != 0 ||
      !grid_panel::plan_covers(H, G, R))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (kWideFixed + (resident ? (size_t)R * w : 0)) * sizeof(T);
  void* args[] = {&a, &vr, &taus, &H, &w, &R, &scratch, &bar};
  return resident
             ? grid_panel::launch_cooperative(qr_wide_kernel<T, true>, G, smem,
                                              args, stream)
             : grid_panel::launch_cooperative(qr_wide_kernel<T, false>, G,
                                              smem, args, stream);
}

template <typename T>
int qr_panel(const void* a, void* vr, void* taus, int H, int w, void* stream) {
  if (w <= 0 || H < w || w > kMB) return (int)cudaErrorInvalidValue;
  const int smem = smem_elems() * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      qr_panel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  qr_panel_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(vr), static_cast<T*>(taus),
      H, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_qr_panel_f32(const void* a, void* vr, void* taus, int H, int w,
                       void* stream) {
  return qr_panel<float>(a, vr, taus, H, w, stream);
}

int slate_qr_panel_f64(const void* a, void* vr, void* taus, int H, int w,
                       void* stream) {
  return qr_panel<double>(a, vr, taus, H, w, stream);
}

// bytes of global scratch one K4 launch of G blocks needs
long long slate_qr_panel_wide_scratch_bytes(int G, int itemsize) {
  return (long long)(wide_scratch_elems(G) * (size_t)itemsize);
}

int slate_qr_panel_wide_f32(const void* a, void* vr, void* taus, int H, int w,
                            int G, int R, int resident, void* scratch,
                            void* bar, void* stream) {
  return qr_panel_wide<float>(a, vr, taus, H, w, G, R, resident, scratch, bar,
                              stream);
}

int slate_qr_panel_wide_f64(const void* a, void* vr, void* taus, int H, int w,
                            int G, int R, int resident, void* scratch,
                            void* bar, void* stream) {
  return qr_panel_wide<double>(a, vr, taus, H, w, G, R, resident, scratch, bar,
                               stream);
}

const char* slate_qr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
