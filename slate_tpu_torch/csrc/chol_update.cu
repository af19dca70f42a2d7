// P6: rank-k update or downdate of lower Cholesky factors, in place, in
// float32, float64, complex64 and complex128: for A' = A + sign·W·Wᴴ,
// per column j < n and vector i (kb ≤ 16 of them, zero lanes allowed),
//     ljj = re(L[j][j]),  r² = ljj² ± |w[j][i]|²,
//     (downdate: r² ≤ 0 sets info = j + 1 and freezes the sweep: no
//      entry changes from that rotation on),
//     r = sqrt(max(r², tiny)),  c = ljj / r,  s = w[j][i] / r,
//     for every row r ≥ j:
//       L[r][j] ← c·L[r][j] ± conj(s)·w[r][i],  w[r][i] ← c·w[r][i] − s·L[r][j].
// Only the lower triangle of the first n rows and columns is written; W is
// read into registers and never written back.
//
// No Pallas kernel: this replaces the reference's lax.scan over the n
// columns, slate_tpu/linalg/update.py::chol_update_dense (:70-137), and
// its vmap over a stack (_k_chol_update, :158-169), with the contract of
// the plain version hopper_ops.chol_update_sweep_plain: every product, sum
// and quotient rounded apart, complex products part by part (csrc/cx.cuh),
// so a zero vector lane (c = 1 and s = 0 exactly, as sqrt(x·x) == |x|)
// changes no bit.
//
// What bounds it. The update reads and writes the lower triangle of L once
// (n²·itemsize bytes) and does about 2·n²·kb multiply-adds; both are far
// below what the card could do in the time the sweep takes, which is the
// chain of dependent steps: column j's kb rotations need row j after the
// columns before it, so n·kb scalar steps (a square root and two
// divisions each) run one after another.
//
// Design: one thread per row, the row's kb entries of W in registers.
// Rotations are row-local once column j's (c, s) pairs are known, so the
// only thing passed between threads is those pairs.
// - CTA b of an item owns rows [b·R, (b+1)·R) (plan
//   hopper_ops.chol_update_plan: one CTA of up to 256 threads for a small
//   item, else R = 128). It first applies, 32 columns at a time, the pairs
//   that the CTAs above it publish (spinning on their progress counters),
//   staging its rows of those columns as a 32-column tile in shared
//   memory (coalesced loads and stores, one row per thread inside);
// - then it sweeps its own diagonal block: for each column j, the thread
//   owning row j makes the kb pairs (and row j's new diagonal) alone,
//   writes them to shared memory, and after one barrier every thread below
//   applies them to its row; after each 32 columns the tile is stored and
//   the pairs are published in global memory (written, fenced, then the
//   CTA's progress counter raised).
// L's column j changes only at step j and a CTA needs the pairs of the
// columns left of its last row only, so the CTAs form a forward pipeline
// in one launch. A multi-CTA item is launched cooperatively: every CTA is
// resident, so a spinning CTA cannot keep the CTA it waits on off the
// card. A failed downdate publishes fewer live rotations for its column
// and none after it; a CTA that reads such a column freezes too.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE square root and
// division are part of the contract).

#include <cuda_runtime.h>

#include "cx.cuh"

namespace {

constexpr int kTw = 32;        // columns of a staged tile
constexpr int kMaxThreads = 256;

using cx::add_rn;
using cx::conj;
using cx::div_real_rn;
using cx::mul_rn;
using cx::sqrt_rn;
using cx::sub_rn;

template <typename R>
__device__ __forceinline__ R scale_rn(R a, R c) { return mul_rn(a, c); }
template <typename R>
__device__ __forceinline__ Cx<R> scale_rn(Cx<R> a, R c) {
  return {mul_rn(a.re, c), mul_rn(a.im, c)};
}

// (l, x) ← (c·l ± conj(s)·x, c·x − s·l), in the plain version's order
template <typename T>
__device__ __forceinline__ void rotate(T& l, T& x, real_t<T> c, T s,
                                       bool down) {
  const T lo = l;
  const T t = mul_rn(conj(s), x);
  const T cl = scale_rn(lo, c);
  l = down ? sub_rn(cl, t) : add_rn(cl, t);
  x = sub_rn(scale_rn(x, c), mul_rn(s, lo));
}

template <typename R> __device__ __forceinline__ R tiny_of();
template <> __device__ __forceinline__ float tiny_of<float>() {
  return 1.17549435e-38f;
}
template <> __device__ __forceinline__ double tiny_of<double>() {
  return 2.2250738585072014e-308;
}

template <typename T>
size_t smem_bytes(int rows, int kb) {
  return (size_t)rows * (kTw + 1) * sizeof(T) +
         (size_t)kTw * kb * (sizeof(T) + sizeof(real_t<T>)) +
         (size_t)kTw * sizeof(int);
}

template <typename T, int KB>
__global__ void __launch_bounds__(kMaxThreads) chol_update_kernel(
    T* __restrict__ L, long long bsl, long long rsl, const T* __restrict__ W,
    long long bsw, int n, int down, int* __restrict__ info,
    real_t<T>* __restrict__ g_c, T* __restrict__ g_s,
    int* __restrict__ g_live, int* __restrict__ progress, int ctas,
    int rows) {
  using R = real_t<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);              // rows × (kTw + 1)
  T* s_s = tile + (size_t)rows * (kTw + 1);          // kTw × KB
  R* s_c = reinterpret_cast<R*>(s_s + kTw * KB);     // kTw × KB
  int* s_live = reinterpret_cast<int*>(s_c + kTw * KB);  // kTw
  __shared__ int s_frozen;

  const int z = blockIdx.y, b = blockIdx.x, tid = threadIdx.x;
  const int nth = blockDim.x;
  T* Lz = L + (size_t)z * bsl;
  const T* Wz = W + (size_t)z * bsw;
  R* cz = g_c + (size_t)z * n * KB;
  T* sz = g_s + (size_t)z * n * KB;
  int* livez = g_live + (size_t)z * n;
  int* prog = progress + (size_t)z * ctas;
  const int r0 = b * rows, r1 = min(n, r0 + rows);
  const int row = r0 + tid;
  const bool valid = row < r1;
  const bool dn = down != 0;

  T x[KB];
#pragma unroll
  for (int i = 0; i < KB; ++i) x[i] = valid ? Wz[(size_t)row * KB + i] : T(0);
  if (tid == 0) s_frozen = 0;

  // tile ↔ L for rows [r0, r1) and columns [j0, j0 + w)
  auto load_tile = [&](int j0, int w) {
    for (int idx = tid; idx < rows * kTw; idx += nth) {
      const int rr = idx / kTw, cc = idx % kTw;
      if (r0 + rr < r1 && cc < w)
        tile[rr * (kTw + 1) + cc] = Lz[(size_t)(r0 + rr) * rsl + j0 + cc];
    }
  };
  auto store_tile = [&](int j0, int w) {
    for (int idx = tid; idx < rows * kTw; idx += nth) {
      const int rr = idx / kTw, cc = idx % kTw;
      if (r0 + rr < r1 && cc < w && j0 + cc <= r0 + rr)
        Lz[(size_t)(r0 + rr) * rsl + j0 + cc] = tile[rr * (kTw + 1) + cc];
    }
  };
  auto apply_column = [&](int cc) {
    T l = tile[tid * (kTw + 1) + cc];
    const int lv = s_live[cc];
#pragma unroll
    for (int i = 0; i < KB; ++i)
      if (i < lv) rotate(l, x[i], s_c[cc * KB + i], s_s[cc * KB + i], dn);
    tile[tid * (kTw + 1) + cc] = l;
  };

  // 1. the columns of the CTAs above, as they publish them
  for (int j0 = 0; j0 < r0; j0 += kTw) {
    const int src = j0 / rows, need = (j0 - src * rows) / kTw + 1;
    if (tid == 0) {
      while (*reinterpret_cast<volatile int*>(prog + src) < need) {
      }
      __threadfence();
    }
    __syncthreads();
    for (int idx = tid; idx < kTw * KB; idx += nth) {
      s_c[idx] = cx::ldcg(cz + (size_t)j0 * KB + idx);
      s_s[idx] = cx::ldcg(sz + (size_t)j0 * KB + idx);
    }
    for (int idx = tid; idx < kTw; idx += nth)
      s_live[idx] = __ldcg(livez + j0 + idx);
    load_tile(j0, kTw);
    __syncthreads();
    if (valid)
      for (int cc = 0; cc < kTw; ++cc) apply_column(cc);
    if (tid == 0)
      for (int cc = 0; cc < kTw; ++cc)
        if (s_live[cc] < KB) s_frozen = 1;
    __syncthreads();
    store_tile(j0, kTw);
  }

  // 2. this CTA's diagonal block, published 32 columns at a time
  int published = 0;
  for (int j0 = r0; j0 < r1; j0 += kTw) {
    const int w = min(kTw, r1 - j0);
    __syncthreads();
    load_tile(j0, w);
    __syncthreads();
    for (int cc = 0; cc < w; ++cc) {
      const int owner = j0 + cc - r0;
      if (tid == owner) {
        T d = tile[owner * (kTw + 1) + cc];
        int lv = 0;
        if (!s_frozen) {
          bool ok = true;
#pragma unroll
          for (int i = 0; i < KB; ++i) {
            if (!ok) continue;
            const R ljj = cx::real_part(d);
            const R ax2 = cx::abs2_rn(x[i]);
            const R l2 = mul_rn(ljj, ljj);
            const R r2 = dn ? sub_rn(l2, ax2) : add_rn(l2, ax2);
            if (dn && r2 <= R(0)) {
              ok = false;
              info[z] = j0 + cc + 1;
              s_frozen = 1;
              continue;
            }
            const R r = sqrt_rn(r2 < tiny_of<R>() ? tiny_of<R>() : r2);
            const R c = cx::div_rn(ljj, r);
            const T s = div_real_rn(x[i], r);
            rotate(d, x[i], c, s, dn);
            s_c[cc * KB + i] = c;
            s_s[cc * KB + i] = s;
            lv = i + 1;
          }
        }
        s_live[cc] = lv;
        tile[owner * (kTw + 1) + cc] = d;
      }
      __syncthreads();
      if (valid && tid > owner) apply_column(cc);
    }
    __syncthreads();
    store_tile(j0, w);
    if (ctas > 1) {
      for (int idx = tid; idx < w * KB; idx += nth) {
        cz[(size_t)j0 * KB + idx] = s_c[idx];
        sz[(size_t)j0 * KB + idx] = s_s[idx];
      }
      for (int idx = tid; idx < w; idx += nth) livez[j0 + idx] = s_live[idx];
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicExch(prog + b, ++published);
    }
  }
}

// One launch: a plain one for single-CTA items, a cooperative one (every
// CTA resident) when an item's CTAs wait on each other.
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, void** args,
           void* stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (grid.x == 1) {
    e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                         dim3(threads), args, smem,
                         static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  int coop = 0, n_sm = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)grid.x * grid.y > (long long)per_sm * n_sm)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                  dim3(threads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int KB>
int run(void* l, long long bsl, long long rsl, const void* w, long long bsw,
        int n, int down, int B, int ctas, int rows, void* info, void* g_c,
        void* g_s, void* g_live, void* progress, void* stream) {
  T* L = static_cast<T*>(l);
  const T* W = static_cast<const T*>(w);
  int* inf = static_cast<int*>(info);
  real_t<T>* gc = static_cast<real_t<T>*>(g_c);
  T* gs = static_cast<T*>(g_s);
  int* gl = static_cast<int*>(g_live);
  int* pr = static_cast<int*>(progress);
  void* args[] = {&L, &bsl, &rsl, &W, &bsw, &n, &down, &inf, &gc, &gs, &gl,
                  &pr, &ctas, &rows};
  return launch(chol_update_kernel<T, KB>, dim3(ctas, B), rows,
                smem_bytes<T>(rows, KB), args, stream);
}

template <typename T>
int chol_update(void* l, long long bsl, long long rsl, const void* w,
                long long bsw, int n, int kb, int down, int B, int ctas,
                int rows, void* info, void* g_c, void* g_s, void* g_live,
                void* progress, void* stream) {
  if (n < 1 || B < 1 || ctas < 1 || rows < 32 || rows > kMaxThreads ||
      rows % kTw != 0 || (long long)(ctas - 1) * rows >= n ||
      (long long)ctas * rows < n)
    return (int)cudaErrorInvalidValue;
  switch (kb) {
    case 1: return run<T, 1>(l, bsl, rsl, w, bsw, n, down, B, ctas, rows,
                             info, g_c, g_s, g_live, progress, stream);
    case 2: return run<T, 2>(l, bsl, rsl, w, bsw, n, down, B, ctas, rows,
                             info, g_c, g_s, g_live, progress, stream);
    case 4: return run<T, 4>(l, bsl, rsl, w, bsw, n, down, B, ctas, rows,
                             info, g_c, g_s, g_live, progress, stream);
    case 8: return run<T, 8>(l, bsl, rsl, w, bsw, n, down, B, ctas, rows,
                             info, g_c, g_s, g_live, progress, stream);
    case 16: return run<T, 16>(l, bsl, rsl, w, bsw, n, down, B, ctas, rows,
                               info, g_c, g_s, g_live, progress, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

#define SLATE_CHOL_UPDATE(SFX, T)                                            \
  int slate_chol_update_##SFX(void* l, long long bsl, long long rsl,         \
                              const void* w, long long bsw, int n, int kb,   \
                              int down, int B, int ctas, int rows,           \
                              void* info, void* g_c, void* g_s,              \
                              void* g_live, void* progress, void* stream) {  \
    return chol_update<T>(l, bsl, rsl, w, bsw, n, kb, down, B, ctas, rows,   \
                          info, g_c, g_s, g_live, progress, stream);         \
  }

SLATE_CHOL_UPDATE(f32, float)
SLATE_CHOL_UPDATE(f64, double)
SLATE_CHOL_UPDATE(c64, Cx<float>)
SLATE_CHOL_UPDATE(c128, Cx<double>)

#undef SLATE_CHOL_UPDATE

const char* slate_chol_update_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
