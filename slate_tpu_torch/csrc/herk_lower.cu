// Lower-triangle rank-k update C ← C − A·Aᵀ, in place, one thread block
// per lower tile pair, on Hopper's tensor cores through warp-level
// mma.sync, in float64, float32 and bfloat16.
//
// Replaces the TPU kernel slate_tpu/ops/pallas_ops.py::herk_lower_update
// (body in _herk_lower_call): the Pallas grid walks only the
// nt·(nt+1)/2 tile pairs (i ≥ j) from a scalar-prefetched pair list and
// aliases the strictly-upper tiles through. Here blockIdx.x is the
// linear index of a pair in row-major lower order, mapped to (i, j) in
// closed form, so no pair list is needed. One tightening over the TPU
// kernel: the diagonal tiles are masked to row ≥ col in the epilogue,
// so the WHOLE strict upper triangle of C is left bitwise unchanged
// (the recursive potrf hands over a view of its working copy and reads
// only the lower triangle, but the port's herk_lower_rec promises an
// untouched strict upper). C and A are row-major with unit column
// stride and any row stride (ldc, lda), so C may be a view such as
// a[h:, h:] of a larger matrix. Any n ≥ 1 and k ≥ 1: ragged tiles are
// zero-filled on load and bounds-checked on store. The TPU kernel's
// k-chunking at 1024 (a VMEM limit) does not carry over: one launch
// streams the whole k.
//
// What bounds it: n(n+1)·k flops against n(n+1) + n·k elements moved,
// so at the sizes the recursive potrf gives it (n = k ≥ 2048) it is
// bound by the tensor cores. The design:
// - one block body for the three element types, templated on the tile
//   edge and on a warp-level mma.sync atom (struct Mma): the two row
//   panels Aᵢ (the atom's row-major A) and Aⱼ (its column-major B) are
//   staged as [row][k-chunk] in shared memory, k contiguous, each row
//   padded by 4 elements or 16 bytes, whichever is more (kPadOf), so
//   the fragment reads hit 32 different banks and a row stays 16-byte
//   aligned, with no transpose;
// - global → shared by cp.async in a ring of `stages` 128-byte-deep
//   chunks (16-byte copies where A's pointer and row stride are
//   16-byte aligned, one element per copy otherwise; the ragged edge
//   zero-filled by the copy's source size), one cp.async.wait_group
//   and one __syncthreads per chunk;
// - the tile plan (herk_plan_of, hopper_ops.herk_plan): 128 × 128 tiles
//   with 8 warps of 64 × 32 and 3 stages, one block per SM, where the
//   128-tile pairs fill at least 4 waves of the SMs; else 64 × 64 with
//   4 warps of 32 × 32 and 2 stages, 4 blocks per SM (n = 2048 gives
//   528 = 4 · 132 pairs, one full wave on an H100);
// - float64: mma.sync m16n8k8 .f64 (FP64 DMMA), accumulated straight
//   over the whole k;
// - float32: 3×TF32 on mma.sync m16n8k8 .tf32: each element is split
//   as its fragment is read (once per fragment, never per atom) into
//   big = tf32_rna(x) and small = tf32_rna(x − big), and the three
//   products a_small·b_big, a_big·b_small, a_big·b_big of each 8-deep
//   half of a 16-deep k-step run in that order into one fresh
//   float32 partial, which is then added to the running float32
//   accumulator (Mma<float>::mma_k16 says why). There is no 1×TF32
//   path: the precision contract is full f32 (the reference's HIGHEST,
//   six bf16 passes);
// - bfloat16: mma.sync m16n8k16 .bf16 with float32 accumulation, its
//   own fragment layout (two k-adjacent elements per 32-bit register,
//   lane t at k = 2t), one atom per 16-deep k-step into a fresh float32
//   partial added to the running float32 accumulator; the epilogue
//   rounds the k-long product to bfloat16 and subtracts it from C in
//   bfloat16, the TPU kernel's own rounding (pallas_ops.py:113,
//   cin − prod.astype(out dtype)). A stage holds 64 k of bfloat16 in
//   the 128 bytes a float32 stage holds 32 k in.
// A NaN in row r of A poisons row r and column r of the lower result
// only, as NaN. An Inf in row r poisons the same entries, not as ±Inf
// alone: in float32 its small part is Inf − Inf = NaN, so that row and
// column hold NaN and ±Inf; float64 gives ±Inf, or NaN where Inf·0 or
// Inf − Inf arises. Every other lower entry stays finite.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math: NaN and Inf
// propagate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunkBytes = 128;  // k-depth of one staged chunk, in bytes
// shared row padding, in elements: 4, or 16 bytes where that is more
__host__ __device__ constexpr int kPadOf(int size) {
  return 16 / size > 4 ? 16 / size : 4;
}

// the warp-level atoms. Each Mma<T> reads the fragments of one 16-deep
// k-step (AK, BK) from the [row][k] panels at p = the lane's row g and
// k offset kLaneK·t (lane = 4·g + t), runs them (mma_k16) into Acc
// accumulators of 4 elements per atom, rows g, g + 8 × columns 2t,
// 2t + 1, and subtracts an accumulator from C in C's type (sub).
//
// float64 and float32: m16n8k8 atoms, two per k-step; a fragment holds
// rows g and g + 8, k columns t and t + 4 of A; row (output column) g,
// k columns t and t + 4 of B
template <typename T> struct Mma;

template <> struct Mma<double> {
  using Acc = double;
  static constexpr int kLaneK = 1;
  struct A { double x[4]; };
  struct B { double x[2]; };
  struct AK { A h[2]; };
  struct BK { B h[2]; };
  __device__ static A load_a(const double* p, int ld) {
    return {{p[0], p[8 * ld], p[4], p[8 * ld + 4]}};
  }
  __device__ static B load_b(const double* p) { return {{p[0], p[4]}}; }
  __device__ static AK load_a16(const double* p, int ld) {
    return {{load_a(p, ld), load_a(p + 8, ld)}};
  }
  __device__ static BK load_b16(const double* p) {
    return {{load_b(p), load_b(p + 8)}};
  }
  __device__ static void sub(double& c, double v) { c -= v; }
  __device__ static void atom(double (&d)[4], const A& a, const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a.x[0]), "d"(a.x[1]), "d"(a.x[2]), "d"(a.x[3]), "d"(b.x[0]),
          "d"(b.x[1]));
  }
  // one A row fragment per 8-deep half of a 16-deep k-step against NT
  // B fragments each: NT independent atoms per half, accumulated
  // straight into d (a fresh partial per step, as in float32, would cut
  // DMMA's accumulation error but needs registers that the 64-wide
  // tile's 4 blocks per SM do not leave)
  template <int NT>
  __device__ static void mma_k16(double (&d)[NT][4], const AK& a,
                                 const BK (&b)[NT]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) atom(d[ni], a.h[h], b[ni].h[h]);
  }
};

template <> struct Mma<float> {
  using Acc = float;
  static constexpr int kLaneK = 1;
  struct A { uint32_t big[4], small[4]; };
  struct B { uint32_t big[2], small[2]; };
  struct AK { A h[2]; };
  struct BK { B h[2]; };
  // x rounded to TF32, to nearest with ties away, by its bits (what
  // cvt.rna.tf32.f32 computes, in two integer operations, fewer than
  // that instruction compiles to); NaN and ±Inf stay NaN and ±Inf
  __device__ static uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  }
  // x = big + small to about 2⁻²² of |x|; an Inf gives a NaN small part
  __device__ static void split(float x, uint32_t& big, uint32_t& small) {
    big = tf32_rna(x);
    small = tf32_rna(x - __uint_as_float(big));
  }
  __device__ static A load_a(const float* p, int ld) {
    A f;
    const float v[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
#pragma unroll
    for (int e = 0; e < 4; ++e) split(v[e], f.big[e], f.small[e]);
    return f;
  }
  __device__ static B load_b(const float* p) {
    B f;
    split(p[0], f.big[0], f.small[0]);
    split(p[4], f.big[1], f.small[1]);
    return f;
  }
  __device__ static AK load_a16(const float* p, int ld) {
    return {{load_a(p, ld), load_a(p + 8, ld)}};
  }
  __device__ static BK load_b16(const float* p) {
    return {{load_b(p), load_b(p + 8)}};
  }
  __device__ static void sub(float& c, float v) { c -= v; }
  template <bool kFresh>
  __device__ static void atom(float (&d)[4], const uint32_t (&a)[4],
                              const uint32_t (&b)[2]) {
    if (kFresh)  // d = a·b
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
          : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
            "f"(0.f));
    else  // d += a·b
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // the same in 3×TF32, the small terms first, into fresh partials
  // over the 16-deep step that are then added to d in float32: the
  // tensor cores align and truncate each product to the accumulator's
  // exponent, so an accumulator that ran over the whole k would gather
  // an error that grows with k. Each pass runs over the NT partials
  // before the next, so consecutive atoms are independent.
  template <int NT>
  __device__ static void mma_k16(float (&d)[NT][4], const AK& a,
                                 const BK (&b)[NT]) {
    float p[NT][4];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      atom<true>(p[ni], a.h[0].small, b[ni].h[0].big);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h) {
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
          atom<false>(p[ni], a.h[1].small, b[ni].h[1].big);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        atom<false>(p[ni], a.h[h].big, b[ni].h[h].small);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        atom<false>(p[ni], a.h[h].big, b[ni].h[h].big);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[ni][e] += p[ni][e];
  }
};

// bfloat16: one m16n8k16 atom per k-step, float32 accumulation. A
// 32-bit register holds two k-adjacent elements, the lower k in the low
// half: A's four are rows g, g + 8 at k = 2t and 2t + 8; B's two are
// row (output column) g at k = 2t and 2t + 8
template <> struct Mma<bf16> {
  using Acc = float;
  static constexpr int kLaneK = 2;
  struct AK { uint32_t x[4]; };
  struct BK { uint32_t x[2]; };
  __device__ static uint32_t pair(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ static AK load_a16(const bf16* p, int ld) {
    return {{pair(p), pair(p + 8 * ld), pair(p + 8), pair(p + 8 * ld + 8)}};
  }
  __device__ static BK load_b16(const bf16* p) {
    return {{pair(p), pair(p + 8)}};
  }
  // each k-step into a fresh float32 partial, then added to d in float32
  // (as Mma<float>: a tensor-core accumulator over the whole k would
  // align and truncate every product to its exponent)
  template <int NT>
  __device__ static void mma_k16(float (&d)[NT][4], const AK& a,
                                 const BK (&b)[NT]) {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      float p[4];
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
          : "=f"(p[0]), "=f"(p[1]), "=f"(p[2]), "=f"(p[3])
          : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]),
            "r"(b[ni].x[0]), "r"(b[ni].x[1]), "f"(0.f));
#pragma unroll
      for (int e = 0; e < 4; ++e) d[ni][e] += p[e];
    }
  }
  // C −= the product rounded to bfloat16, in bfloat16
  __device__ static void sub(bf16& c, float v) {
    c = __float2bfloat16_rn(__bfloat162float(c) -
                            __bfloat162float(__float2bfloat16_rn(v)));
  }
};

// the block shape of a tile edge: warps as WARPS_M × WARPS_N, the
// pipeline depth, and the blocks per SM the registers are bounded for
template <int TILE> struct Shape;
template <> struct Shape<128> {
  static constexpr int kWarpsM = 2, kWarpsN = 4, kStages = 3, kMinBlocks = 1;
};
template <> struct Shape<64> {
  static constexpr int kWarpsM = 2, kWarpsN = 2, kStages = 2, kMinBlocks = 4;
};

struct Plan {
  int tile, warps, stages, blocks_per_sm, smem_bytes;
};

// the tile plan (hopper_ops.herk_plan, held against it by chip_smoke.py):
// 128-wide tiles where their pairs fill at least 4 waves of n_sm SMs,
// else 64-wide ones
Plan herk_plan_of(int n, int itemsize, int n_sm) {
  const long long nt = (n + 127) / 128;
  const bool wide = nt * (nt + 1) / 2 >= 4LL * n_sm;
  Plan p;
  p.tile = wide ? 128 : 64;
  p.warps = wide ? Shape<128>::kWarpsM * Shape<128>::kWarpsN
                 : Shape<64>::kWarpsM * Shape<64>::kWarpsN;
  p.stages = wide ? Shape<128>::kStages : Shape<64>::kStages;
  p.blocks_per_sm = wide ? Shape<128>::kMinBlocks : Shape<64>::kMinBlocks;
  const int kc = kChunkBytes / itemsize;
  p.smem_bytes = p.stages * 2 * p.tile * (kc + kPadOf(itemsize)) * itemsize;
  return p;
}

// the tile pair (i, j), i ≥ j, at linear index t of the row-major lower
// order (0,0), (1,0), (1,1), (2,0), ...
__device__ __forceinline__ void pair_of(long long t, int& i, int& j) {
  long long r = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  i = (int)r;
  j = (int)(t - r * (r + 1) / 2);
}

// cp.async of `bytes` (≤ size) bytes from global to shared, the rest of
// the `size` bytes zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
template <int SIZE>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(SIZE), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int TILE>
__global__ void __launch_bounds__(Shape<TILE>::kWarpsM *Shape<TILE>::kWarpsN
                                      * 32,
                                  Shape<TILE>::kMinBlocks)
herk_lower_kernel(T* __restrict__ c, const T* __restrict__ a, int n, int k,
                  long long ldc, long long lda, int vec) {
  using S = Shape<TILE>;
  using M = Mma<T>;
  using Acc = typename M::Acc;
  constexpr int kThreads = S::kWarpsM * S::kWarpsN * 32;
  constexpr int kKC = kChunkBytes / (int)sizeof(T);  // k-chunk, elements
  constexpr int kLD = kKC + kPadOf(sizeof(T));        // shared row stride
  constexpr int kPanel = TILE * kLD;                  // one row panel
  constexpr int kWM = TILE / S::kWarpsM, kWN = TILE / S::kWarpsN;
  constexpr int kMT = kWM / 16, kNT = kWN / 8;        // atoms per warp
  constexpr int kEPP = 16 / (int)sizeof(T);           // elements per 16 B

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);  // [stage][panel][row][kLD]

  int ti, tj;
  pair_of(blockIdx.x, ti, tj);
  const int r0 = ti * TILE, c0 = tj * TILE;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  // on a diagonal tile a warp whose sub-tile lies strictly above the
  // diagonal only stages
  const bool active = ti != tj || wn * kWN <= wm * kWM + kWM - 1;

  // stage chunk kc0 of both row panels into ring slot `slot`
  auto load_chunk = [&](int slot, int kc0) {
    T* dst = smem + slot * 2 * kPanel;
    if (vec) {
      constexpr int kPieces = 2 * TILE * (kKC / kEPP);
      for (int idx = tid; idx < kPieces; idx += kThreads) {
        const int p = idx / (TILE * (kKC / kEPP));
        const int rem = idx % (TILE * (kKC / kEPP));
        const int r = rem / (kKC / kEPP), q = rem % (kKC / kEPP);
        const int row = (p ? c0 : r0) + r, kq = kc0 + q * kEPP;
        const T* src = a;
        int bytes = 0;
        if (row < n && kq < k) {
          src = a + row * lda + kq;
          bytes = min(kEPP, k - kq) * (int)sizeof(T);
        }
        cp_async16(dst + p * kPanel + r * kLD + q * kEPP, src, bytes);
      }
    } else {
      constexpr int kElems = 2 * TILE * kKC;
      for (int idx = tid; idx < kElems; idx += kThreads) {
        const int p = idx / (TILE * kKC), rem = idx % (TILE * kKC);
        const int r = rem / kKC, q = rem % kKC;
        const int row = (p ? c0 : r0) + r, kq = kc0 + q;
        const bool in = row < n && kq < k;
        if constexpr (sizeof(T) >= 4) {
          cp_async_elem<(int)sizeof(T)>(dst + p * kPanel + r * kLD + q,
                                        in ? a + row * lda + kq : a,
                                        in ? (int)sizeof(T) : 0);
        } else {  // cp.async copies 4 bytes or more: a plain 2-byte store
          const uint16_t* src = reinterpret_cast<const uint16_t*>(a);
          reinterpret_cast<uint16_t*>(dst)[p * kPanel + r * kLD + q] =
              in ? src[row * lda + kq] : uint16_t(0);
        }
      }
    }
  };

  Acc acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);

  const int nk = (k + kKC - 1) / kKC;
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < nk) load_chunk(s, s * kKC);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S::kStages - 2>();  // chunk kt has landed (this thread)
    __syncthreads();                  // ... for every thread; slot of kt−1 free
    const int kn = kt + S::kStages - 1;
    if (kn < nk) load_chunk(kn % S::kStages, kn * kKC);
    cp_async_commit();
    if (!active) continue;
    const T* si = smem + (kt % S::kStages) * 2 * kPanel;
    const T* sj = si + kPanel;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {  // 16-deep k-steps
      typename M::BK fb[kNT];
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
        fb[ni] = M::load_b16(sj + (wn * kWN + ni * 8 + g) * kLD + kk +
                             M::kLaneK * t);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const T* pa =
            si + (wm * kWM + mi * 16 + g) * kLD + kk + M::kLaneK * t;
        M::mma_k16(acc[mi], M::load_a16(pa, kLD), fb);
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  // C −= acc on the lower triangle only (col ≤ row also keeps col < n),
  // in C's type
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm * kWM + mi * 16 + g + 8 * h;
      if (row >= n) continue;
      T* crow = c + row * ldc;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + wn * kWN + ni * 8 + 2 * t + e;
          if (col <= row) M::sub(crow[col], acc[mi][ni][2 * h + e]);
        }
    }
}

template <typename T, int TILE>
int launch(T* c, const T* a, int n, int k, long long ldc, long long lda,
           const Plan& p, cudaStream_t stream) {
  const long long nt = (n + TILE - 1) / TILE;
  const long long pairs = nt * (nt + 1) / 2;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto kernel = herk_lower_kernel<T, TILE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies need A's pointer and row stride 16-byte aligned
  const int vec = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                  ((lda * (long long)sizeof(T)) % 16 == 0);
  kernel<<<(unsigned)pairs, p.warps * 32, p.smem_bytes, stream>>>(
      c, a, n, k, ldc, lda, vec);
  return (int)cudaGetLastError();
}

int sm_count(int* n_sm) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

template <typename T>
int herk_lower(void* c, const void* a, int n, int k, long long ldc,
               long long lda, void* stream) {
  if (n <= 0 || k <= 0 || ldc < n || lda < k) return (int)cudaErrorInvalidValue;
  int n_sm;
  if (int e = sm_count(&n_sm)) return e;
  const Plan p = herk_plan_of(n, (int)sizeof(T), n_sm);
  auto s = static_cast<cudaStream_t>(stream);
  auto cc = static_cast<T*>(c);
  auto aa = static_cast<const T*>(a);
  return p.tile == 128 ? launch<T, 128>(cc, aa, n, k, ldc, lda, p, s)
                       : launch<T, 64>(cc, aa, n, k, ldc, lda, p, s);
}

template <typename T, int TILE>
int occupancy(int smem_bytes, int* blocks) {
  auto kernel = herk_lower_kernel<T, TILE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, (Shape<TILE>::kWarpsM * Shape<TILE>::kWarpsN) * 32,
        smem_bytes);
  return (int)e;
}

}  // namespace

extern "C" {

int slate_herk_lower_f32(void* c, const void* a, int n, int k, long long ldc,
                         long long lda, void* stream) {
  return herk_lower<float>(c, a, n, k, ldc, lda, stream);
}

int slate_herk_lower_f64(void* c, const void* a, int n, int k, long long ldc,
                         long long lda, void* stream) {
  return herk_lower<double>(c, a, n, k, ldc, lda, stream);
}

int slate_herk_lower_bf16(void* c, const void* a, int n, int k,
                          long long ldc, long long lda, void* stream) {
  return herk_lower<bf16>(c, a, n, k, ldc, lda, stream);
}

// the plan the launcher takes for (n, itemsize) on this device, and the
// blocks per SM the card schedules for it, written to out[0..5] as
// (tile, warps, stages, blocks_per_sm, smem_bytes, resident blocks per
// SM), so that hopper_ops.herk_plan can be held against it
int slate_herk_plan(int n, int itemsize, int* out) {
  if (n <= 0 || (itemsize != 2 && itemsize != 4 && itemsize != 8))
    return (int)cudaErrorInvalidValue;
  int n_sm;
  if (int e = sm_count(&n_sm)) return e;
  const Plan p = herk_plan_of(n, itemsize, n_sm);
  int blocks = 0, e;
  if (itemsize == 2)
    e = p.tile == 128 ? occupancy<bf16, 128>(p.smem_bytes, &blocks)
                      : occupancy<bf16, 64>(p.smem_bytes, &blocks);
  else if (itemsize == 4)
    e = p.tile == 128 ? occupancy<float, 128>(p.smem_bytes, &blocks)
                      : occupancy<float, 64>(p.smem_bytes, &blocks);
  else
    e = p.tile == 128 ? occupancy<double, 128>(p.smem_bytes, &blocks)
                      : occupancy<double, 64>(p.smem_bytes, &blocks);
  const int v[6] = {p.tile, p.warps, p.stages, p.blocks_per_sm, p.smem_bytes,
                    blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return e;
}

const char* slate_herk_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
