// Householder QR of one tall (H × w) row-major panel, one kernel body for
// K3 qr_panel_base (1 <= w <= 32) and K4 qr_panel_base_wide
// (32 < w <= 128, w % 32 == 0): one cooperative launch of G blocks, in
// float32, float64, complex64 and complex128 (cx.cuh's Cx<R>).
//
// Replaces the TPU kernels slate_tpu/ops/pallas_ops.py::qr_panel_base
// (body _qr_panel_kernel) and ::qr_panel_base_wide (bodies
// _qr_panel_wide_kernel, _qr_wide_micro_fori), with the contract of
// slate_tpu/ops/blocked.py::_panel_geqrf_base: returns vr (R on and above
// the diagonal, beta on it, the Householder tails v below) and the w
// LAPACK taus, H_j = I − tau_j·v_j·v_jᴴ, Q = H_0·H_1·…, each column
// eliminated by H_jᴴ = I − conj(tau_j)·v_j·v_jᴴ (in a real type conj is
// the identity and ᴴ is ᵀ).
//
// The panel is spread over the SMs (grid_panel.cuh): block b owns a row
// slab, held in shared memory (resident mode) or, when it does not fit,
// read in place through L1/L2 (streaming mode). The columns go in
// micro-blocks of 32 (one micro-block for K3). Per column j, with the
// update confined to the lanes j < c < hi (hi = the end of j's
// micro-block, at most w):
//  (A) one pass over each block's rows i > j, one warp per row so that
//      each row is read coalesced (lane l holds a[i, j + l]; x = a[i, j]
//      is lane 0's and reaches the others by a shuffle): the block's
//      p[c] = Σ conj(x)·a[i,c], lane 0's being sigma = Σ |x|² (its real
//      part), per-warp partials summed in a fixed order; each block
//      publishes its 32 partials, the owner of row j publishes row j's
//      micro lanes, one grid barrier;
//  (B) every block sums the G partials in the same fixed order, with no
//      float atomics, so every block takes bitwise the same larfg scalars
//      and w_row: IEEE sqrt and division with each product and sum
//      rounded on its own (no FMA contraction; the complex quotient is
//      cx.cuh's Smith form), anorm = √(|alpha|² + sigma), beta = +anorm
//      if real(alpha) <= 0 else −anorm (real), tau = (beta − alpha)/beta,
//      scale = 1/(alpha − beta); a degenerate column (sigma == 0 and
//      imag(alpha) == 0) gives tau = 0, scale = 0 and alpha kept on the
//      diagonal; NaN propagates; w_row[c] = a[j,c] + conj(scale)·p[c]
//      (= vᴴ·A[:, c] with v_j = 1);
//  (C) on each block's own rows i >= j: v_i = a[i,j]·scale (v_j = 1),
//      a[i,c] −= (conj(tau)·v_i)·w_row[c], column j ← v (beta on the
//      diagonal).
// A panel of w <= 32 (K3) ends there. After each micro-block of a wider
// one (K4) but the last, the lanes to its right get the compact-WY update
// C ← C − V·(Tᴴ·(Vᴴ·C)): each block's partial E = Vᴴ·[V | C] over its
// rows (32 × 128), a barrier, block b sums a slice of E's entries over
// the G partials in a fixed order, a second barrier; then every block
// reads G = VᴴV and Y = VᴴC, takes T by LAPACK's forward column
// recurrence T[:i,i] = −tau_i·(T[:i,:i]·G[:i,i]), T[i,i] = tau_i (the
// reference's _larft_base; the TPU kernel reaches the same T by a
// nilpotent fixed point) and Z = TᴴY, and applies C −= V·Z to its own
// rows. T sees only the micro-block's own columns, as in
// hopper_ops.qr_panel_base_wide_plain.
//
// What bounds it: the w serial column steps (a grid barrier and a few
// block barriers each) and, for K4, the 2·(w/32 − 1) barriers of the
// updates; the panel crosses HBM once each way (16 MiB at 32768 × 128
// f32, 4 MiB at 32768 × 32), and its 2·H·w² flops at 67 TFLOP/s set
// 16.0 µs at 32768 × 128 f32. Measured by chip_smoke.py on an H100 80GB
// HBM3 at 700 W: K4 about 1 ms at 32768 × 128 f32 (132 resident slabs of
// 249 rows), against 62.5 ms for the one-block version before it; K3 at
// 32768 × 32 f32 took 13.1 ms as one block re-reading the panel through
// one SM twice per column. PERF.md keeps the times of each run. FMA loops
// in the element type (four real multiply-adds to a complex one); tensor
// cores come later. Its own shared memory beside a resident slab is
// kFixed elements (91,776 B in complex128), which the plan reserves
// (hopper_ops.QR_PANEL_FIXED_ELEMS, held to kFixed by a CPU test).
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE sqrt, division
// and NaN propagation are part of the contract).

#include <cuda_runtime.h>

#include "cx.cuh"
#include "grid_panel.cuh"

namespace {

constexpr int kMaxW = 128;              // widest (K4) panel
constexpr int kMB = 32;                 // K3's widest panel, K4's micro-block
constexpr int kMaxTrail = kMaxW - kMB;  // lanes right of a micro-block
constexpr int kTS = kMB + 1;            // padded row stride of T

constexpr int kThreads = grid_panel::kThreads;
constexpr int kWarps = grid_panel::kWarps;
constexpr int kE = kMB * kMaxW;  // one block's partial E = Vᵀ·[V | C], 32 × 128
constexpr int kZPer = kMB * kMaxTrail / kThreads;  // Z entries per thread
static_assert(kThreads == 4 * kMaxW, "E's thread map: 4 groups of 8 k");

// shared memory beside the slab, in elements of T
constexpr int kFixed = kMB                // w_row
                       + kMB              // the micro-block's taus
                       + kWarps * kMB     // per-warp partial sums
                       + 8                // tau, scale, beta_out
                       + kMB * kMB        // G = VᵀV
                       + kMB * kTS        // T
                       + kMB * kMaxTrail; // Y, then Z

// the global scratch, in elements of T: two parities of G + 1 column
// slots of 32 (block partials, then row j's micro lanes), then, for a
// panel wider than one micro-block, G partial E's and the reduced E
__host__ __device__ inline size_t scratch_elems(int G, int w) {
  return 2 * (size_t)(G + 1) * kMB + (w > kMB ? (size_t)(G + 1) * kE : 0);
}

// V[i, m0 + k] of the unit-lower micro-block from the packed row value x
template <typename T>
__device__ __forceinline__ T vmask(T x, int i, int col) {
  return i > col ? x : (i == col ? T(1) : T(0));
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
qr_panel_kernel(const T* __restrict__ a, T* vr, T* taus, int H, int w, int R,
                T* scratch, unsigned int* bar) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = b * R, r1 = min(H, r0 + R);
  T* wrow = reinterpret_cast<T*>(smem_raw);
  T* mtau = wrow + kMB;
  T* red = mtau + kMB;
  T* scal = red + kWarps * kMB;
  T* gm = scal + 8;
  T* tm = gm + kMB * kMB;
  T* yz = tm + kMB * kTS;
  T* slab = kResident ? yz + kMB * kMaxTrail : vr + (size_t)r0 * w;
  T* part = scratch + 2 * (size_t)(G + 1) * kMB;
  T* redE = part + (size_t)G * kE;
  unsigned int n_bar = 0;

  const size_t cells = (size_t)(r1 - r0) * w;
  for (size_t k = tid; k < cells; k += kThreads) slab[k] = a[(size_t)r0 * w + k];
  __syncthreads();

  for (int m0 = 0; m0 < w; m0 += kMB) {
    const int hi = min(m0 + kMB, w);
    for (int j = m0; j < hi; ++j) {
      T* cp = scratch + (size_t)(j & 1) * (G + 1) * kMB;
      const int c = j + lane;  // this lane's column
      const bool in = c < hi;
      // (A) this block's sigma (lane 0) and p[c] over its rows i > j
      T acc = T(0);
#pragma unroll 4
      for (int i = max(j + 1, r0) + warp; i < r1; i += kWarps) {
        const T r = in ? slab[(size_t)(i - r0) * w + c] : T(0);
        acc = cx::fma_conj(r, cx::shfl(r, 0), acc);  // acc + conj(x)·r
      }
      red[warp * kMB + lane] = acc;
      __syncthreads();
      if (warp == 0) {
        T s = T(0);
        for (int k = 0; k < kWarps; ++k) s += red[k * kMB + lane];
        cp[b * kMB + lane] = s;
      } else if (warp == 1 && r0 <= j && j < r1) {
        cp[G * kMB + lane] = in ? slab[(size_t)(j - r0) * w + c] : T(0);
      }
      grid_panel::grid_barrier(bar, ++n_bar * G);
      // (B) every block sums the G partials in the same order and takes
      // the same larfg scalars and w_row
      {
        T s = T(0);
        for (int g = warp; g < G; g += kWarps) s += cx::ldcg(cp + g * kMB + lane);
        red[warp * kMB + lane] = s;
      }
      __syncthreads();
      if (warp == 0) {
        T t = T(0);
        for (int k = 0; k < kWarps; ++k) t += red[k * kMB + lane];
        const T arow = cx::ldcg(cp + G * kMB + lane);  // a[j, c]
        T scale = T(0);
        if (lane == 0) {
          using R = real_t<T>;
          const T alpha = arow;
          const R sig = cx::real_part(t);
          const R anorm = cx::sqrt_rn(cx::add_rn(cx::abs2_rn(alpha), sig));
          const R beta = cx::real_part(alpha) <= R(0) ? anorm : -anorm;
          const bool degen = sig == R(0) && cx::imag_part(alpha) == R(0);
          const R beta_safe = (degen || beta == R(0)) ? R(1) : beta;
          const T denom_safe = degen ? T(1) : cx::sub_rn(alpha, T(beta));
          const T tau = degen ? T(0)
                              : cx::div_real_rn(cx::sub_rn(T(beta), alpha),
                                                beta_safe);
          scale = degen ? T(0) : cx::div(T(1), denom_safe);
          scal[0] = tau;
          scal[1] = scale;
          scal[2] = degen ? alpha : T(beta);
          mtau[j - m0] = tau;
        }
        scale = cx::shfl(scale, 0);
        if (lane > 0 && in) wrow[lane] = arow + cx::conj(scale) * t;
      }
      __syncthreads();
      const T ctau = cx::conj(scal[0]), scale = scal[1], beta_out = scal[2];
      // (C) the reflector on this block's rows i >= j, v into column j
      for (int i = max(j, r0) + warp; i < r1; i += kWarps) {
        T* row = slab + (size_t)(i - r0) * w;
        const T r = in ? row[c] : T(0);
        const T x = cx::shfl(r, 0);
        const T v = i == j ? T(1) : cx::mul_rn(x, scale);
        const T tv = cx::mul_rn(ctau, v);
        if (lane > 0 && in)
          row[c] = cx::sub_rn(r, cx::mul_rn(tv, wrow[lane]));
        else if (lane == 0)
          row[j] = i == j ? beta_out : v;
      }
      if (b == 0 && tid == 0) taus[j] = scal[0];
      __syncthreads();
    }
    if (hi >= w) break;

    // compact-WY update of the lanes right of the micro-block:
    // C ← C − V·(Tᴴ·(Vᴴ·C)) on the rows >= m0
    const int wm = w - m0, nc = w - hi;
    {  // this block's partial E[k][cc] = Σ conj(V[i, k])·[V | C][i, cc]
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
          acc[q] = cx::fma_conj(x, vmask(row[k0 + q], i, m0 + k0 + q), acc[q]);
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
          for (int g = warp; g < G; g += kWarps) s += cx::ldcg(part + (size_t)g * kE + off);
        red[warp * kMB + lane] = s;
        __syncthreads();
        if (warp == 0 && e < e_hi) {
          T t = T(0);
          for (int k = 0; k < kWarps; ++k) t += red[k * kMB + lane];
          redE[off] = t;
        }
        __syncthreads();
      }
    }
    grid_panel::grid_barrier(bar, ++n_bar * G);
    for (int e = tid; e < kMB * kMB; e += kThreads)
      gm[e] = cx::ldcg(redE + (e / kMB) * kMaxW + e % kMB);
    for (int e = tid; e < kMB * nc; e += kThreads)
      yz[e] = cx::ldcg(redE + (e / nc) * kMaxW + kMB + e % nc);
    for (int e = tid; e < kMB * kTS; e += kThreads) tm[e] = T(0);
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
    {  // Z = TᴴY, in place of Y
      T z[kZPer];
#pragma unroll
      for (int q = 0; q < kZPer; ++q) {
        const int e = tid + q * kThreads;
        z[q] = T(0);
        if (e < kMB * nc) {
          const int k = e / nc, cz = e - k * nc;
          for (int l = 0; l < kMB; ++l)
            z[q] = cx::fma_conj(yz[l * nc + cz], tm[l * kTS + k], z[q]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kZPer; ++q) {
        const int e = tid + q * kThreads;
        if (e < kMB * nc) yz[e] = z[q];
      }
      __syncthreads();
    }
    // C −= V·Z on this block's rows >= m0, one warp per row, lane k holds V[i, k]
    for (int i = max(m0, r0) + warp; i < r1; i += kWarps) {
      T* row = slab + (size_t)(i - r0) * w;
      const T vk = vmask(row[m0 + lane], i, m0 + lane);
      for (int cz = lane; cz < nc; cz += 32) {
        T d = T(0);
#pragma unroll
        for (int k = 0; k < kMB; ++k) d += cx::shfl(vk, k) * yz[k * nc + cz];
        row[hi + cz] = cx::sub_rn(row[hi + cz], d);
      }
    }
    __syncthreads();
  }
  if (kResident)
    for (size_t k = tid; k < cells; k += kThreads) vr[(size_t)r0 * w + k] = slab[k];
}

template <typename T>
int qr_panel(const void* a, void* vr, void* taus, int H, int w, int G, int R,
             int resident, void* scratch, void* bar, void* stream) {
  if (w <= 0 || H < w || w > kMaxW || (w > kMB && w % kMB != 0) ||
      !grid_panel::plan_covers(H, G, R))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (kFixed + (resident ? (size_t)R * w : 0)) * sizeof(T);
  void* args[] = {&a, &vr, &taus, &H, &w, &R, &scratch, &bar};
  return resident
             ? grid_panel::launch_cooperative(qr_panel_kernel<T, true>, G,
                                              smem, args, stream)
             : grid_panel::launch_cooperative(qr_panel_kernel<T, false>, G,
                                              smem, args, stream);
}

}  // namespace

extern "C" {

// bytes of global scratch one launch of G blocks on a w-wide panel needs
long long slate_qr_panel_scratch_bytes(int G, int w, int itemsize) {
  return (long long)(scratch_elems(G, w) * (size_t)itemsize);
}

// K3 (w <= 32) and K4 (32 < w <= 128, w % 32 == 0) alike
int slate_qr_panel_f32(const void* a, void* vr, void* taus, int H, int w,
                       int G, int R, int resident, void* scratch, void* bar,
                       void* stream) {
  return qr_panel<float>(a, vr, taus, H, w, G, R, resident, scratch, bar,
                         stream);
}

int slate_qr_panel_f64(const void* a, void* vr, void* taus, int H, int w,
                       int G, int R, int resident, void* scratch, void* bar,
                       void* stream) {
  return qr_panel<double>(a, vr, taus, H, w, G, R, resident, scratch, bar,
                          stream);
}

int slate_qr_panel_c64(const void* a, void* vr, void* taus, int H, int w,
                       int G, int R, int resident, void* scratch, void* bar,
                       void* stream) {
  return qr_panel<Cx<float>>(a, vr, taus, H, w, G, R, resident, scratch, bar,
                             stream);
}

int slate_qr_panel_c128(const void* a, void* vr, void* taus, int H, int w,
                        int G, int R, int resident, void* scratch, void* bar,
                        void* stream) {
  return qr_panel<Cx<double>>(a, vr, taus, H, w, G, R, resident, scratch,
                              bar, stream);
}

const char* slate_qr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
