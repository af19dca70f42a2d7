// Cholesky factor of one diagonal tile: K1 chol_tile, one launch of a
// thread-block cluster of C <= 8 CTAs.
//
// Replaces the TPU kernel slate_tpu/ops/pallas_ops.py::chol_tile (body
// _chol_tile_kernel, the pallas_call in chol_tile): out = L with
// A = L·Lᴴ, strict upper triangle zeroed, in float32, float64, complex64
// and complex128 (the complex arm is the reference's _chol_unrolled /
// chol_tile_blocked, slate_tpu/ops/blocked.py:464-545). Only the LOWER
// triangle of the input is read (potrf hands over raw lower storage; the
// upper may be garbage). The pivot is the real part of the diagonal entry
// (its imaginary part is ignored), so L's diagonal is real. A non-positive
// or NaN pivot puts NaN on the diagonal from that column on: potrf reads
// failure off isnan(diag(L)).
//
// What bounds it on this card: not bytes (1 MiB at b = 512 f32) and not
// the b³/3 flops (0.7 µs on the whole card, about 0.1 ms on one SM), but
// the serial chain of b/32 steps, each a 32 × 32 factorization, a
// triangular solve and a trailing update that the next step waits for,
// and the barriers between them. The one-block kernel before this one
// took three block barriers and a serial sqrt per column, 1,536 barriers
// at b = 512, with about one row of work per thread between them.
//
// Design: right-looking, blocked by 32. The tile's 32-row blocks are
// dealt cyclically to the C CTAs (block g to CTA g mod C), so each CTA
// keeps rows all the way down the shrinking trailing triangle. The plan
// (hopper_ops.chol_tile_plan, pure Python) picks C and the mode, and the
// launcher only checks it:
//  - whole (C = 1): the whole tile is held in the CTA's shared memory
//    (b = 128 and b = 200 f32);
//  - resident (C > 1): each CTA holds its own row blocks in shared
//    memory, with a copy of the step's panel beside them (b = 512 f32);
//  - streaming: the rows stay in place in `out` and are read through L2
//    with __ldcg, published by a __threadfence before each cluster
//    barrier (b = 1024 f32, b >= 512 f64).
// Per step k (columns k0 .. k0 + 32):
//  1. every CTA reads the factored 32 × 32 diagonal block L11 from its
//     owner (over distributed shared memory, or global memory when
//     streaming); at k = 0 every CTA factors A11 itself, redundantly, in
//     one warp (row t in lane t's registers, the pivot and multipliers
//     passed by shuffles): the same inputs and code everywhere give
//     bitwise the same L11 with no barrier;
//  2. each CTA solves its own rows below the diagonal, L21 = A21·L11⁻ᵀ,
//     one row per thread in registers, multiplying by the reciprocals of
//     L11's diagonal (one IEEE division per column and step, off the
//     rows' dependency chains);
//  3. a cluster barrier;
//  4. (resident) each CTA copies the panel rows L21 it needs from the
//     other CTAs' shared memory into its own, one warp per row;
//  5. each CTA applies A22 −= L21·L21ᵀ to its own rows of the lower
//     trailing triangle, 32 × 32 tiles, a 4 × 4 register tile per thread,
//     FMA in the element type (no tensor cores yet). Lookahead: the owner
//     of block k + 1 updates that block's diagonal tile first, in one
//     group of 64 threads, and one warp factors it into place (the next
//     step's L11) while the other groups finish the trailing update, so
//     the serial 32-column factorization leaves the critical path where
//     the update is longer;
//  6. a cluster barrier.
// Two cluster barriers per step: 32 at b = 512, against the 1,536 block
// barriers before. Measured by chip_smoke.py and profile_factors.py on an
// H100 80GB HBM3 at 700 W (PERF.md keeps each run): about 0.29 ms a
// launch at b = 512 f32 (8 CTAs) and 0.05 ms at b = 128 (one CTA),
// against 1.99 and 0.17 ms for the one-block kernel; still above
// cuSOLVER's potrf at b = 512. What is left is latency: the one-warp
// factorization of each diagonal block, the copy over distributed shared
// memory and the waits at the barriers.
//
// Complex types run the same steps in csrc/cx.cuh's arithmetic: the
// products take conj of the second factor (L21 = A21·L11⁻ᴴ,
// A22 −= L21·L21ᴴ) and a row divides by the real diagonal part by part.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math: the NaN contract
// needs IEEE sqrt and division.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 32;            // step width and row-block height
constexpr int kLD = kNB + 1;       // padded row of L11 (column kNB: 1/L11[c][c])
                                   // and of the panel copy
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kTileThreads = 64;   // threads per 32 × 32 update tile (4 × 4 each)
constexpr int kCopy = 8;           // loads in flight per thread in a copy

enum Mode { kWhole = 0, kResident = 1, kStream = 2 };

template <typename R> __device__ __forceinline__ R quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// a read of the tile's storage: through L2 when streaming (other CTAs'
// writes), else a plain load (own or distributed shared memory)
template <int M, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if (M == kStream) return cx::ldcg(p);
  return *p;
}

// Cholesky of the identity-padded 32 × 32 block in d11 (row stride kLD),
// in place, by one warp: lane t keeps row t in registers and the real
// part of its own diagonal entry apart, so the pivot chain from column to
// column is one shuffle, a sqrt, a division and an FMA; the multipliers
// reach the other lanes by shuffles.
template <typename T>
__device__ void factor_diag(T* d11, int t) {
  using R = real_t<T>;
  T r[kNB];
#pragma unroll
  for (int c = 0; c < kNB; ++c) r[c] = d11[t * kLD + c];
  R diag = cx::real_part(d11[t * kLD + t]);
#pragma unroll
  for (int c = 0; c < kNB; ++c) {
    const R d = __shfl_sync(0xffffffffu, diag, c);
    const R s = d > R(0) ? sqrt(d) : quiet_nan<R>();
    const T l = t > c ? cx::div_real_rn(r[c], s) : (t == c ? T(s) : T(0));
    r[c] = l;
    if (t > c) diag -= cx::abs2(l);
#pragma unroll
    for (int c2 = c + 1; c2 < kNB; ++c2) {
      const T lc = cx::shfl(l, c2);
      if (t > c2) r[c2] -= l * cx::conj(lc);
    }
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c) d11[t * kLD + c] = r[c];
}

// shared memory of one CTA, in elements of T (hopper_ops.chol_tile_smem_bytes)
__host__ __device__ inline size_t smem_elems(int b, int C, int M) {
  const size_t nblk = (b + kNB - 1) / kNB, ldr = b + 1;
  const size_t fixed = kNB * kLD;  // L11 and the reciprocals of its diagonal
  if (M == kStream) return fixed;
  if (M == kWhole) return nblk * kNB * ldr + fixed;
  const size_t nq = (nblk + C - 1) / C;
  return nq * kNB * ldr + (nblk - 1) * kNB * kLD + fixed;
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads, 1)
chol_tile_kernel(const T* __restrict__ a, T* __restrict__ out, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nblk = (b + kNB - 1) / kNB;
  const int nq = (nblk - r + C - 1) / C;  // row blocks r, r + C, ...
  const int ldr = b + 1;
  T* d11 = reinterpret_cast<T*>(smem_raw);
  T* pbuf = d11 + kNB * kLD;  // resident: panel rows k1.., row stride kLD
  T* rows = pbuf + (M == kResident ? (size_t)(nblk - 1) * kNB * kLD : 0);

  // row i of the tile in its owner's storage (this CTA's for its own rows)
  auto store = [&](int i) -> T* {
    if (M == kStream) return out + (size_t)i * b;
    const int lr = M == kWhole ? i : (i / kNB / C) * kNB + i % kNB;
    return rows + (size_t)lr * ldr;
  };

  // load this CTA's rows, lower triangle only, zero above it; kCopy
  // loads in flight per thread
  for (int q = 0; q < nq; ++q) {
    const int i0 = (r + q * C) * kNB, n = kNB * b;
    for (int e0 = tid; e0 < n; e0 += kThreads * kCopy) {
      T v[kCopy];
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const int e = e0 + u * kThreads, i = i0 + e / b, j = e % b;
        v[u] = (e < n && i < b && j <= i) ? a[(size_t)i * b + j] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const int e = e0 + u * kThreads, i = i0 + e / b;
        if (e < n && (M != kStream || i < b)) store(i)[e % b] = v[u];
      }
    }
  }
  if (M == kStream) __threadfence();
  cluster.sync();

  for (int k = 0; k < nblk; ++k) {
    const int k0 = k * kNB, kw = min(kNB, b - k0), k1 = k0 + kw;
    const int owner = k % C;
    const bool below = k + 1 < nblk;  // rows below: then kw == 32
    if (k > 0 && !below) break;  // the last block was factored ahead
    // own row blocks after k: q0, q0 + 1, ... < nq
    const int q0 = k < r ? 0 : (k - r) / C + 1;

    // 1. L11 from its owner, identity-padded: factored here at k = 0, in
    // the owner during step k − 1 after that
    {
      const T* src = store(k0) + k0;
      if (M == kResident) src = cluster.map_shared_rank(src, owner);
      const int lds = M == kStream ? b : ldr;
      for (int e = tid; e < kNB * kNB; e += kThreads) {
        const int t = e / kNB, c = e % kNB;
        d11[t * kLD + c] = (t < kw && c <= t) ? ld<M>(src + (size_t)t * lds + c)
                                              : (t == c ? T(1) : T(0));
      }
    }
    __syncthreads();
    if (k == 0) {
      if (tid < 32) factor_diag(d11, tid);
      __syncthreads();
    }

    // 2. L21 = A21·L11⁻ᵀ on this CTA's rows below the diagonal block, by
    // the reciprocals of L11's diagonal
    if (below) {
      if (tid < kNB)
        d11[tid * kLD + kNB] =
            T(real_t<T>(1) / cx::real_part(d11[tid * kLD + tid]));
      __syncthreads();
      for (int e = tid; e < (nq - q0) * kNB; e += kThreads) {
        const int i = (r + (q0 + e / kNB) * C) * kNB + e % kNB;
        if (i >= b) continue;
        T* p = store(i) + k0;
        T x[kNB];
#pragma unroll
        for (int c = 0; c < kNB; ++c) x[c] = ld<M>(p + c);
#pragma unroll
        for (int c = 0; c < kNB; ++c) {
          x[c] = cx::scale(x[c], cx::real_part(d11[c * kLD + kNB]));
#pragma unroll
          for (int c2 = c + 1; c2 < kNB; ++c2)
            x[c2] -= x[c] * cx::conj(d11[c2 * kLD + c]);
        }
#pragma unroll
        for (int c = 0; c < kNB; ++c) p[c] = x[c];
      }
    }

    // 3. every CTA has read L11 and written its L21 rows
    if (M == kStream) __threadfence();
    cluster.sync();
    if (k == 0 && r == owner)
      for (int e = tid; e < kw * kw; e += kThreads) {
        const int t = e / kw, c = e % kw;
        store(k0 + t)[k0 + c] = c <= t ? d11[t * kLD + c] : T(0);
      }
    if (!below) continue;  // nothing is read remotely after barrier 3

    // 4. resident: the panel rows k1 .. (last own block + 1)·32 from
    // their owners, one warp per row, kCopy rows in flight
    const int gmax = r + (nq - 1) * C;  // this CTA's last row block
    if (M == kResident && gmax > k) {
      const int rhi = min(b, (gmax + 1) * kNB);
      for (int i0 = k1 + warp; i0 < rhi; i0 += kWarps * kCopy) {
        T v[kCopy];
#pragma unroll
        for (int u = 0; u < kCopy; ++u) {
          const int i = i0 + u * kWarps;
          if (i < rhi)
            v[u] = *cluster.map_shared_rank(store(i) + k0 + lane, (i / kNB) % C);
        }
#pragma unroll
        for (int u = 0; u < kCopy; ++u) {
          const int i = i0 + u * kWarps;
          if (i < rhi) pbuf[(size_t)(i - k1) * kLD + lane] = v[u];
        }
      }
    }
    __syncthreads();

    // 5. A22 −= L21·L21ᵀ on this CTA's tiles (g, h), g own, k < h <= g.
    // Lookahead: the owner of block k + 1 gives its tile 0, (k + 1, k + 1),
    // to its first group of threads alone, whose first warp then factors
    // it into place (the next step's L11) while the other groups update
    // the rest.
    {
      auto pan = [&](int i, int c) -> T {
        if (M == kResident) return pbuf[(size_t)(i - k1) * kLD + c];
        return ld<M>(store(i) + k0 + c);
      };
      const bool ahead = (k + 1) % C == r;
      const int grp = tid / kTileThreads;
      // tiles grp, grp + step, ...; ahead, group 0 stops after tile 0
      const int e_step = kThreads / kTileThreads - (ahead ? 1 : 0);
      int ntiles = 0;
      for (int q = q0; q < nq; ++q) ntiles += r + q * C - k;
      const int tt = tid % kTileThreads, ti = tt / 8, tj = tt % 8;
      for (int e = grp; e < ntiles; e += e_step) {
        int g = 0, h = 0;
        for (int q = q0, e2 = e;; ++q) {
          g = r + q * C;
          if (e2 < g - k) { h = k + 1 + e2; break; }
          e2 -= g - k;
        }
        const int ib = g * kNB + ti * 4, jb = h * kNB + tj * 4;
        int ia[4], ja[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          ia[m] = min(ib + m, b - 1);  // rows past b feed only masked outputs
          ja[m] = min(jb + m, b - 1);
        }
        T acc[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[m][n] = T(0);
#pragma unroll 4
        for (int c = 0; c < kNB; ++c) {
          T av[4], bv[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            av[m] = pan(ia[m], c);
            bv[m] = pan(ja[m], c);
          }
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              acc[m][n] = cx::fma_conj(av[m], bv[n], acc[m][n]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = ib + m;
          if (i >= b) break;
          T* p = store(i);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            if (jb + n <= i) p[jb + n] = ld<M>(p + jb + n) - acc[m][n];
        }
        if (ahead && grp == 0) break;
      }
      if (ahead && grp == 0) {
        const int kw1 = min(kNB, b - k1);  // the next block's width
        if (M == kStream) __threadfence();
        asm volatile("bar.sync 1, %0;" ::"n"(kTileThreads) : "memory");
        if (warp == 0) {  // lane t: row t of the tile, d11 as scratch
          T* row = store(k1 + min(lane, kw1 - 1)) + k1;
#pragma unroll
          for (int c = 0; c < kNB; ++c)
            d11[lane * kLD + c] = (lane < kw1 && c <= lane) ? ld<M>(row + c)
                                                            : T(lane == c);
          factor_diag(d11, lane);
          if (lane < kw1)
            for (int c = 0; c <= lane; ++c) row[c] = d11[lane * kLD + c];
        }
      }
    }

    // 6. the trailing rows are updated before the next step reads them
    if (M == kStream) __threadfence();
    cluster.sync();
  }
  __syncthreads();  // the last L11 is in place

  if (M != kStream)  // own rows back to out, zero above the diagonal
    for (int q = 0; q < nq; ++q) {
      const int i0 = (r + q * C) * kNB;
      for (int e = tid; e < kNB * b; e += kThreads) {
        const int i = i0 + e / b, j = e % b;
        if (i >= b) break;
        out[(size_t)i * b + j] = j <= i ? store(i)[j] : T(0);
      }
    }
}

// One cluster launch of C CTAs; refused when the card cannot schedule
// one such cluster.
template <typename T, int M>
int launch(const void* a, void* out, int b, int C, size_t smem,
           cudaStream_t stream) {
  auto kernel = chol_tile_kernel<T, M>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a),
                         static_cast<T*>(out), b);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

inline int plan_mode(int C, int resident) {
  return !resident ? kStream : (C == 1 ? kWhole : kResident);
}

// Checks the plan (C CTAs, resident or streaming) and launches it.
template <typename T>
int chol_tile(const void* a, void* out, int b, int C, int resident,
              void* stream) {
  const int nblk = (b + kNB - 1) / kNB;
  if (b <= 0 || C < 1 || C > kMaxCluster || C > nblk)
    return (int)cudaErrorInvalidValue;
  const int mode = plan_mode(C, resident);
  const size_t smem = smem_elems(b, C, mode) * sizeof(T);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kWhole: return launch<T, kWhole>(a, out, b, C, smem, s);
    case kResident: return launch<T, kResident>(a, out, b, C, smem, s);
    default: return launch<T, kStream>(a, out, b, C, smem, s);
  }
}

}  // namespace

extern "C" {

int slate_chol_tile_f32(const void* a, void* out, int b, int C, int resident,
                        void* stream) {
  return chol_tile<float>(a, out, b, C, resident, stream);
}

int slate_chol_tile_f64(const void* a, void* out, int b, int C, int resident,
                        void* stream) {
  return chol_tile<double>(a, out, b, C, resident, stream);
}

int slate_chol_tile_c64(const void* a, void* out, int b, int C, int resident,
                        void* stream) {
  return chol_tile<Cx<float>>(a, out, b, C, resident, stream);
}

int slate_chol_tile_c128(const void* a, void* out, int b, int C, int resident,
                         void* stream) {
  return chol_tile<Cx<double>>(a, out, b, C, resident, stream);
}

// the shared memory per CTA that the launcher sizes a plan with, so the
// plan's copy of the formula (hopper_ops.chol_tile_smem_bytes) can be
// held against it
long long slate_chol_tile_smem_bytes(int b, int C, int resident,
                                     int itemsize) {
  return (long long)(smem_elems(b, C, plan_mode(C, resident)) * itemsize);
}

const char* slate_chol_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
