// Householder QR of every (H, w) panel of a (B, H, w) stack, w ≤ H and
// w ≤ 128, in float32, float64, complex64 and complex128 (cx.cuh's Cx<R>)
// → the packed V\R of each item (R on and
// above the diagonal, the reflectors' tails below it, their unit heads
// implied) in a contiguous (B, H, w) stack, and the taus in a (B, w) one.
// The input is read through its batch, row and column strides.
//
// No Pallas kernel: this is the port's counterpart of the reference's
// batched panel, slate_tpu/ops/blocked.py::_panel_geqrf_batched (a
// fori_loop of w Householder steps over the whole stack), with the
// contract of the plain version hopper_ops.qr_panel_batched_plain. Column
// j of each item takes LAPACK's larfg of [alpha; x] = its entries on and
// below the diagonal, sig = ‖x‖² (real),
//     beta  = real(alpha) ≤ 0 ? +sqrt(|alpha|² + sig) : −sqrt(|alpha|² + sig),
//     tau   = (beta − alpha) / beta,   v = [1; x·scale],
//     scale = 1 / (alpha − beta),
// a degenerate column (sig = 0 and imag(alpha) = 0) keeping alpha with
// tau = 0 and v = [1; 0], then the columns right of j take the reflector
// Hᴴ = I − conj(tau)·v·vᴴ:
//     w_row[c] = Σ_{r ≥ j} conj(v[r])·a[r][c],
//     a[r][c] −= (conj(tau)·v[r])·w_row[c].
// Items never mix, so a NaN stays in its item (its columns from the NaN
// on turn NaN, as in the plain version).
//
// What bounds it. An item is 2Hw² − 2w³/3 operations on H·w entries: at
// the engine's shapes (B = 1000 panels of 512 × 32, B = 10000 of 64 × 32)
// the bytes bound it; each item alone is a chain of w dependent steps,
// each a reduction over the panel's height and a rank-1 update.
//
// Design: rows owned by threads, one fused reduction per column. A team
// works each item (hopper_ops.qr_panel_batched_plan): one warp (four items
// a CTA) or one CTA; thread t of a team of n threads owns rows t, t + n,
// …, and reads them along their columns, never down a column. With x the
// column below the diagonal, unscaled, one pass over a thread's own rows
// accumulates p[c] = Σ conj(x_r)·a[r][c] for every c ≥ j (real(p[j]) =
// sig). The partials are reduced in one fixed order: a transposing
// butterfly inside the warp (lane c ends with column c), then the warps'
// partials in warp order through shared memory. The owner of row j
// publishes the row beside them. Every thread then takes the same larfg
// scalars from sig and alpha, w_row[c] = a[j][c] + conj(scale)·p[c] (lane
// c's, shuffled to the warp), and updates its own rows. This is the plain version's column
// step, reassociated; products and sums may contract to FMAs, so the
// kernel is held to its plain version within a tolerance, not bitwise.
// Nothing depends on B, so an item's bits do not depend on its neighbours.
// Storage (the plan):
// - registers (w ≤ 32, H ≤ 256·kR, kR = 2 rows a thread in float32, 1 in
//   float64 and complex64; never complex128, whose row of 32 entries and
//   32 partials would fill a thread's registers): the rows in registers,
//   every index fixed at compile time. A
//   warp team (H ≤ 32·kR) shuffles its partials and needs no block
//   barrier; a CTA team takes one barrier a column, the partials and row j
//   double-buffered;
// - shared / streaming (any other shape; a CTA team of 32·⌈H/32⌉ threads,
//   at most 256, so that no warp of a short item is idle): the item in shared
//   memory (rows of an odd length, so a warp reading its 32 rows' same
//   column hits 32 banks) or worked in place in the output stack in global
//   memory. One pass over a thread's rows a column both applies column j's
//   reflector and accumulates column j + 1's partials, so a streamed item
//   is read and written once a column (16-byte vectors where the row
//   length allows); one barrier a column. A row goes through in chunks of
//   32 columns (16 in complex128, so that a chunk, its w_row and its
//   partials stay in registers), each chunk's partials reduced by the
//   butterfly over its lanes and then across the two half-warps.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE square root and
// division, NaN propagation).

#include <cuda_runtime.h>

#include <climits>

#include "cx.cuh"

namespace {

constexpr int kMemThreads = 256;  // the largest team of the memory plans
constexpr int kMemWarps = kMemThreads / 32;
constexpr int kWarpItems = 4;     // items (warps) a CTA of warp teams
constexpr int kMaxW = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;
enum Storage { kRegisters = 0, kShared = 1, kStreaming = 2 };

// shared memory per CTA (hopper_ops.qr_panel_batched_smem_bytes): a warp
// team's double-buffered row j per warp; a CTA team's double-buffered
// partials of every warp and row j (32 columns in registers, w rounded up
// to 32 otherwise), then, shared, the item in rows of an odd length
long long smem_bytes(int H, int w, int storage, int threads, int itemsize) {
  if (storage == kRegisters) {
    if (threads == 32) return (long long)kWarpItems * 2 * 32 * itemsize;
    return (2LL * (threads / 32) * 32 + 2 * 32) * itemsize;
  }
  const long long wp = (w + 31) / 32 * 32;
  const long long item = storage == kShared ? (long long)H * (w | 1) : 0;
  return (2LL * (threads / 32) * wp + 2 * wp + item) * itemsize;
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<Cx<float>> { using type = float4; };
template <> struct Vec16<Cx<double>> { using type = double2; };
// entry k of a 16-byte vector of T
template <typename T>
__device__ __forceinline__ T get(const typename Vec16<T>::type& v, int k);
template <>
__device__ __forceinline__ float get<float>(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
template <>
__device__ __forceinline__ double get<double>(const double2& v, int k) {
  return k == 0 ? v.x : v.y;
}
template <>
__device__ __forceinline__ Cx<float> get<Cx<float>>(const float4& v, int k) {
  return k == 0 ? Cx<float>(v.x, v.y) : Cx<float>(v.z, v.w);
}
template <>
__device__ __forceinline__ Cx<double> get<Cx<double>>(const double2& v,
                                                      int) {
  return {v.x, v.y};
}
// 16 bytes from 16 / sizeof(T) consecutive values (one vector store)
__device__ __forceinline__ float4 pack(const float* x) {
  return make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ double2 pack(const double* x) {
  return make_double2(x[0], x[1]);
}
__device__ __forceinline__ float4 pack(const Cx<float>* x) {
  return make_float4(x[0].re, x[0].im, x[1].re, x[1].im);
}
__device__ __forceinline__ double2 pack(const Cx<double>* x) {
  return make_double2(x[0].re, x[0].im);
}

// The N partials p[i] of columns c0 + i of every lane → lane l returns
// the warp's sum for column c0 + l % N: at offset O, the lane whose bit O
// is set keeps the upper half of its O-wide block and adds its partner's
// copy (its own value first); then, for N < 32, the N-lane groups' sums
// are added across the warp. One fixed order per column, 31 shuffles at
// N = 32. (One template instance a stage, so every index into p is a
// constant and p stays in registers.)
template <int O, int N, typename T>
__device__ __forceinline__ void reduce_stage(T (&p)[N], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const T send = up ? p[i] : p[i + O];
    const T keep = up ? p[i + O] : p[i];
    p[i] = keep + cx::shfl_xor(send, O);
  }
  if constexpr (O > 1) reduce_stage<O / 2>(p, lane);
}

template <int N, typename T>
__device__ __forceinline__ T reduce_scatter(T (&p)[N], int lane) {
  reduce_stage<N / 2>(p, lane);
  T s = p[0];
#pragma unroll
  for (int o = N; o < 32; o *= 2) s += cx::shfl_xor(s, o);
  return s;
}

// larfg's scalars of [alpha; x] with the real sig = ‖x‖² (hopper_ops.larfg)
template <typename T>
__device__ __forceinline__ void larfg(T alpha, real_t<T> sig, T& beta_out,
                                      T& tau, T& scale) {
  using R = real_t<T>;
  const R anorm = sqrt(cx::abs2(alpha) + sig);
  const R beta = cx::real_part(alpha) <= R(0) ? anorm : -anorm;
  const bool degen = sig == R(0) && cx::imag_part(alpha) == R(0);
  const R beta_safe = degen || beta == R(0) ? R(1) : beta;
  const T denom_safe = degen ? T(1) : alpha - T(beta);
  tau = degen ? T(0) : cx::div_real_rn(T(beta) - alpha, beta_safe);
  scale = degen ? T(0) : cx::div(T(1), denom_safe);
  beta_out = degen ? alpha : T(beta);
}

// rows a thread holds in registers: two float32 rows or one float64 or
// complex64 row (more rows a thread measured slower or spilled, PERF.md
// PR 14); none in complex128 (the plan never gives it registers)
template <typename T> constexpr int kRows = 8 / sizeof(T);
// columns of a row chunk the shared and streaming plans hold in registers
template <typename T> constexpr int kChunk = sizeof(T) > 8 ? 16 : 32;

// ---------------------------------------------------------------------------
// registers: w ≤ 32, kR rows a thread; kWarp: a warp per item
// ---------------------------------------------------------------------------

template <typename T, bool kWarp>
__global__ void __launch_bounds__(256)
qr_reg_kernel(const T* __restrict__ a, T* __restrict__ vr,
              T* __restrict__ taus, int B, int H, int w, long long bs,
              long long rs, long long cs) {
  constexpr int kR = kRows<T>;
  constexpr int kV = 16 / sizeof(T);
  using V = typename Vec16<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = kWarp ? 32 : blockDim.x;  // the team
  const int t = kWarp ? lane : tid;       // this thread's place in it
  const int nw = n / 32;
  const long long item =
      kWarp ? (long long)blockIdx.x * kWarpItems + warp : blockIdx.x;
  if (item >= B) return;  // a warp team leaves whole; a CTA team never
  T* part = sh;                                       // [2][nw][32]
  T* rowj = kWarp ? sh + warp * 64 : sh + 2 * nw * 32;  // [2][32]
  const T* src = a + item * bs;
  T* out = vr + item * H * w;
  // 16-byte vectors: whole rows of 32 entries, each row's start aligned
  const bool vec = cs == 1 && w == 32 && rs % kV == 0 && bs % kV == 0 &&
                   reinterpret_cast<size_t>(a) % 16 == 0;

  T m[kR][32];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = t + k * n;
    if (r < H && vec) {
      const V* row = reinterpret_cast<const V*>(src + r * rs);
#pragma unroll
      for (int g = 0; g < 32 / kV; ++g) {
        const V v = row[g];
#pragma unroll
        for (int e = 0; e < kV; ++e) m[k][g * kV + e] = get<T>(v, e);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c)
        m[k][c] = r < H && c < w ? src[r * rs + c * cs] : T(0);
    }
  }

  if (w > 0) {  // the column steps
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j >= w) break;
      T* rj = rowj + (j & 1) * 32;
      // the partials of column j's reflector over this thread's rows, and
      // row j from its owner
      T p[32];
#pragma unroll
      for (int c = 0; c < 32; ++c) p[c] = T(0);
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int r = t + k * n;
        if (r > j && r < H) {
          const T x = cx::conj(m[k][j]);
#pragma unroll
          for (int c = j; c < 32; ++c) p[c] += x * m[k][c];
        }
        if (r == j)
#pragma unroll
          for (int c = j; c < 32; ++c) rj[c] = m[k][c];
      }
      T pc = reduce_scatter(p, lane);  // column lane, this warp's rows
      if (kWarp) {
        __syncwarp();
      } else {
        T* pb = part + (j & 1) * nw * 32;
        pb[warp * 32 + lane] = pc;
        __syncthreads();
        T pq[8];  // every warp's partial in flight at once, then in order
#pragma unroll
        for (int q = 0; q < 8; ++q) pq[q] = q < nw ? pb[q * 32 + lane] : T(0);
        pc = T(0);
#pragma unroll
        for (int q = 0; q < 8; ++q) pc += pq[q];
      }
      const real_t<T> sig = cx::real_part(cx::shfl(pc, j));
      const T alpha = rj[j];
      T beta_out, tau, scale;
      larfg(alpha, sig, beta_out, tau, scale);
      if (t == 0) taus[item * w + j] = tau;
      const T wl = rj[lane] + cx::conj(scale) * pc;  // w_row[lane]
      // the reflector acts on rows j ≤ r < H only: a row above j or a
      // padded row never takes 0·w_row (a NaN there stays out of them)
      bool live[kR];
      T tv[kR];
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int r = t + k * n;
        const T v = r == j ? T(1) : m[k][j] * scale;
        live[k] = r >= j && r < H;
        tv[k] = cx::conj(tau) * v;
        if (r == j) m[k][j] = beta_out;
        else if (live[k]) m[k][j] = v;
      }
      // (columns w … 31 are zero padding: w_row is 0 there, they stay 0)
#pragma unroll
      for (int c = j + 1; c < 32; ++c) {
        const T wc = cx::shfl(wl, c);
#pragma unroll
        for (int k = 0; k < kR; ++k)
          m[k][c] = live[k] ? m[k][c] - tv[k] * wc : m[k][c];
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = t + k * n;
    if (r >= H) continue;
    if (vec) {
      V* row = reinterpret_cast<V*>(out + r * 32);
#pragma unroll
      for (int g = 0; g < 32 / kV; ++g) row[g] = pack(&m[k][g * kV]);
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c < w) out[r * w + c] = m[k][c];
    }
  }
}

// ---------------------------------------------------------------------------
// shared / streaming: a CTA of n ≤ 256 threads an item, the item in shared
// memory or in the output stack, one fused pass over a thread's rows a
// column
// ---------------------------------------------------------------------------

// N entries of a row from `row`, n of them real (zeros past them); and
// back, the n real ones
template <int N, typename T>
__device__ __forceinline__ void load_chunk(const T* row, int n,
                                           T (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = i < n ? row[i] : T(0);
}

template <int N, typename T>
__device__ __forceinline__ void store_chunk(T* row, int n,
                                            const T (&in)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) row[i] = in[i];
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kMemThreads)
qr_mem_kernel(const T* __restrict__ a, T* __restrict__ vr,
              T* __restrict__ taus, int H, int w, long long bs, long long rs,
              long long cs) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kC = kChunk<T>;  // a row chunk's columns
  using V = typename Vec16<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockDim.x, nw = n >> 5;  // the team
  const long long item = blockIdx.x;
  const int wp = (w + 31) / 32 * 32;
  T* part = sh;                 // [2][nw][wp]
  T* rowj = sh + 2 * nw * wp;   // [2][wp]
  const T* src = a + item * bs;
  T* out = vr + item * H * w;
  const int ld = kShared ? (w | 1) : w;
  T* m = kShared ? rowj + 2 * wp : out;  // the item being factored
  // 16-byte vectors over a row's chunks (the streamed stack's rows)
  const bool vec = !kShared && w % 32 == 0;

  // the load, 32 columns × 8 rows of the warp in flight (coalesced), then
  // column 0's partials
  for (int c0 = 0; c0 < w; c0 += 32) {
    const int c = c0 + lane;
#pragma unroll 8
    for (int r = warp; r < H; r += nw)
      if (c < w) m[r * ld + c] = src[r * rs + c * cs];
  }
  __syncthreads();
  for (int c0 = 0; c0 < w; c0 += kC) {
    T p[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) p[i] = T(0);
    for (int r = tid; r < H; r += n) {
      if (r == 0) continue;
      T row[kC];
      load_chunk(m + r * ld + c0, w - c0, row);
      const T x = cx::conj(m[r * ld]);
#pragma unroll
      for (int i = 0; i < kC; ++i) p[i] += x * row[i];
    }
    const T pc = reduce_scatter(p, lane);
    if (lane < kC) part[warp * wp + c0 + lane] = pc;
  }
  if (tid == 0)
    for (int c = 0; c < w; ++c) rowj[c] = m[c];
  __syncthreads();

  if (w > 0) {  // the column steps
    for (int j = 0; j < w; ++j) {
      const T* pb = part + (j & 1) * nw * wp;
      const T* rj = rowj + (j & 1) * wp;
      T* pn = part + ((j + 1) & 1) * nw * wp;
      T* rn = rowj + ((j + 1) & 1) * wp;
      T pj = T(0);
#pragma unroll
      for (int q = 0; q < kMemWarps; ++q)
        if (q < nw) pj += pb[q * wp + j];
      const real_t<T> sig = cx::real_part(pj);
      const T alpha = rj[j];
      T beta_out, tau, scale;
      larfg(alpha, sig, beta_out, tau, scale);
      if (tid == 0) taus[item * w + j] = tau;
      const int j1 = j + 1;
      if (j1 == w) {  // the last column: no trailing columns
        for (int r = tid; r < H; r += n)
          if (r >= j) m[r * ld + j] = r == j ? beta_out : m[r * ld + j] * scale;
        break;
      }
      // w_row[c] = a[j][c] + conj(scale)·p[c] of a chunk: lane l's column
      // c0 + l, then in every lane's registers by shuffles
      const T cscale = cx::conj(scale), ctau = cx::conj(tau);
      auto w_chunk = [&](int c0, T (&wr)[kC]) {
        const int c = c0 + lane;
        T pc = T(0);
#pragma unroll
        for (int q = 0; q < kMemWarps; ++q)
          if (q < nw && c < w) pc += pb[q * wp + c];
        const T wl = c < w ? rj[c] + cscale * pc : T(0);
#pragma unroll
        for (int i = 0; i < kC; ++i) wr[i] = cx::shfl(wl, i);
        return wl;
      };
      T wr[kC];
      const T w1 = cx::shfl(w_chunk(j1 / kC * kC, wr), j1 % kC);
      // v into column j and column j + 1 updated, on every own row ≥ j
      for (int r = tid; r < H; r += n) {
        if (r < j) continue;
        T* row = m + r * ld;
        T v = T(1);
        if (r == j) {
          row[j] = beta_out;
        } else {
          v = row[j] * scale;
          row[j] = v;
        }
        row[j1] -= (ctau * v) * w1;
      }
      // the rest of the update, fused with column j + 1's partials: a
      // chunk of a row in registers, selects instead of branches
      for (int c0 = j1 / kC * kC; c0 < w; c0 += kC) {
        if (c0 != j1 / kC * kC) w_chunk(c0, wr);
        T p[kC];
#pragma unroll
        for (int i = 0; i < kC; ++i) p[i] = T(0);
        for (int r = tid; r < H; r += n) {
          if (r < j) continue;
          T* at = m + r * ld + c0;
          const T tv = ctau * (r == j ? T(1) : m[r * ld + j]);
          const T x = cx::conj(m[r * ld + j1]);  // column j + 1, updated
          // one entry: column j's reflector, column j + 1's partial, and
          // row j + 1 published by its owner
          auto entry = [&](int i, T val) {
            val = c0 + i > j1 ? val - tv * wr[i] : val;
            if (r > j1) p[i] += x * val;
            if (r == j1 && c0 + i >= j1 && c0 + i < w) rn[c0 + i] = val;
            return val;
          };
          if (vec) {  // a 16-byte group at a time, in and out
#pragma unroll
            for (int g = 0; g < kC / kV; ++g) {
              const V u = reinterpret_cast<const V*>(at)[g];
              T val[kV];
#pragma unroll
              for (int e = 0; e < kV; ++e)
                val[e] = entry(g * kV + e, get<T>(u, e));
              reinterpret_cast<V*>(at)[g] = pack(val);
            }
          } else {
            T row[kC];
            load_chunk(at, w - c0, row);
#pragma unroll
            for (int i = 0; i < kC; ++i) row[i] = entry(i, row[i]);
            store_chunk(at, w - c0, row);
          }
        }
        const T pc = reduce_scatter(p, lane);
        if (lane < kC) pn[warp * wp + c0 + lane] = pc;
      }
      __syncthreads();
    }
  }

  if (kShared) {
    __syncthreads();
    for (int r = warp; r < H; r += nw)
      for (int c = lane; c < w; c += 32) out[r * w + c] = m[r * ld + c];
  }
}

template <typename T>
int qr_panel_batched(const void* a, void* vr, void* taus, int B, int H, int w,
                     long long bs, long long rs, long long cs, int storage,
                     int threads, void* stream) {
  if (B < 1 || w < 1 || w > kMaxW || H < w || (long long)H * w > INT_MAX)
    return (int)cudaErrorInvalidValue;  // rows and columns index as int
  if (storage == kRegisters
          ? w > 32 || threads < 32 || threads > 256 || threads % 32 ||
                H > threads * kRows<T>
          : (storage != kShared && storage != kStreaming) ||
                threads != (H < kMemThreads ? (H + 31) / 32 * 32
                                            : kMemThreads))
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(H, w, storage, threads, sizeof(T));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(a);
  T* y = static_cast<T*>(vr);
  T* tt = static_cast<T*>(taus);
  if (storage == kRegisters) {
    if constexpr (kRows<T> > 0) {
      if (threads == 32)  // a few KB: no opt-in
        qr_reg_kernel<T, true>
            <<<(unsigned)((B + kWarpItems - 1) / kWarpItems),
               32 * kWarpItems, (size_t)smem, st>>>(x, y, tt, B, H, w, bs,
                                                    rs, cs);
      else
        qr_reg_kernel<T, false><<<(unsigned)B, threads, (size_t)smem, st>>>(
            x, y, tt, B, H, w, bs, rs, cs);
    }
  } else {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (smem > optin) return (int)cudaErrorInvalidValue;
    auto kernel = storage == kShared ? qr_mem_kernel<T, true>
                                     : qr_mem_kernel<T, false>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)B, threads, (size_t)smem, st>>>(x, y, tt, H, w, bs,
                                                       rs, cs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_qr_panel_batched_f32(const void* a, void* vr, void* taus, int B,
                               int H, int w, long long bs, long long rs,
                               long long cs, int storage, int threads,
                               void* stream) {
  return qr_panel_batched<float>(a, vr, taus, B, H, w, bs, rs, cs, storage,
                                 threads, stream);
}

int slate_qr_panel_batched_f64(const void* a, void* vr, void* taus, int B,
                               int H, int w, long long bs, long long rs,
                               long long cs, int storage, int threads,
                               void* stream) {
  return qr_panel_batched<double>(a, vr, taus, B, H, w, bs, rs, cs, storage,
                                  threads, stream);
}

int slate_qr_panel_batched_c64(const void* a, void* vr, void* taus, int B,
                               int H, int w, long long bs, long long rs,
                               long long cs, int storage, int threads,
                               void* stream) {
  return qr_panel_batched<Cx<float>>(a, vr, taus, B, H, w, bs, rs, cs,
                                     storage, threads, stream);
}

int slate_qr_panel_batched_c128(const void* a, void* vr, void* taus, int B,
                                int H, int w, long long bs, long long rs,
                                long long cs, int storage, int threads,
                                void* stream) {
  return qr_panel_batched<Cx<double>>(a, vr, taus, B, H, w, bs, rs, cs,
                                      storage, threads, stream);
}

// the shared memory per CTA that the launcher sizes a plan with, so the
// plan's copy of the formula can be held against it
long long slate_qr_panel_batched_smem_bytes(int H, int w, int storage,
                                            int threads, int itemsize) {
  return smem_bytes(H, w, storage, threads, itemsize);
}

const char* slate_qr_panel_batched_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
