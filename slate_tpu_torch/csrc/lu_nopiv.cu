// LU without pivoting of one square s × s leaf, s ≤ 64, in float32,
// float64, complex64 and complex128, IN PLACE: the leaf is read through
// its row and column strides and L\U (unit lower L implied) is written
// back into the same view. info: the 1-based first step whose pivot is
// bad (isnan(|d|) or |d| == 0, the reference's test; in complex types |d|
// is cx.cuh's modulus: hypot, NaN with a NaN part); that step goes on with
// the pivot taken as 1. The kernel writes offset + that step into a 0-d
// int32 slot only if the slot still reads 0, so the leaves of a factor,
// launched in diagonal order on one stream, leave the first bad pivot of
// the whole factor there.
//
// No Pallas kernel: this is the port's counterpart of the reference's
// unblocked leaf, slate_tpu/linalg/lu.py::_lu_nopiv_unblocked (one
// fori_loop program), with the contract of the plain version
// hopper_ops.lu_nopiv_base_plain. Step i computes
//     col = a[:, i] / dsafe on the rows below i (0 elsewhere),
//     a[r, i] = col[r] below i,
//     urow = a[i, :] right of i (0 elsewhere),
//     a = a − col ⊗ urow
// over the WHOLE leaf, as the reference does, so a non-finite entry
// spreads to the same places (0·Inf = NaN) and a zero keeps the same sign.
// The kernel replays exactly that formula for every entry at every step,
// the 0·x terms included (throughput, off the chain): products and
// differences are rounded separately (no FMA contraction) and the scale is
// an IEEE division (in complex types csrc/cx.cuh's products and Smith
// quotient, the pivot's ratio and scale made once per step), so the result
// is bitwise the plain version's.
//
// What bounds it. A leaf is 16–32 KB and 2s³/3 operations: neither bytes
// nor the operation rate. Step i + 1 needs column i + 1 and row i + 1 after
// step i, so a launch costs s dependent steps plus its launch, load and
// store, and each step's latency is what the kernel is made of. The first
// kernel held the leaf in shared memory and ended every step with a
// barrier of all 32 warps. Publishing rows instead (rows dealt to warps,
// one mbarrier per row) crossed warps at every step, and every warp ran
// the division for its rows: slower than this design in float64.
//
// Design: the leaf in registers, columns dealt to warps in blocks, the
// multipliers published.
// - 8 warps; warp w holds the 8 columns 8w … 8w + 7, lane l the rows l and
//   l + 32 of them (16 entries). Row i, which every warp needs for its own
//   columns, is in the warp's own registers: one shuffle per column; a
//   warp whose columns are all left of i needs none (its urow is 0).
// - The multipliers col of step k (k ≥ 1) are made in step k − 1 by the
//   warp holding column k (lookahead): it first gives column k its step-
//   (k − 1) update, reads the pivot by a shuffle, divides (two divisions
//   per lane while k < 33, one after: rows 0 … 31 are then above the
//   pivot; none in the other warps), stores col to shared memory and
//   every lane arrives on step k's mbarrier (count 32, release); only
//   then does it update its other columns. A warp that does not hold
//   column i waits on step i's mbarrier alone (try_wait, acquire) and
//   reads col from shared memory. Every col is written once: no double
//   buffer, no write-after-read hazard.
// - So for 7 of 8 steps the warp that makes col needs nothing from another
//   warp: the chain of a step is in one warp (a multiply-subtract, a
//   shuffle, the divisions, the next step's shuffles), and only every 8th
//   step crosses warps. The other warps trail behind, off the chain. The
//   steps run in two halves, so the register set (m0 or m1) that holds
//   row i is known at compile time.
// - The tile lives in dynamic shared memory (64 × 65 entries: 66,560 bytes
//   in complex128, above the 48 KB of static shared memory), its limit
//   raised once per element type and device.
// - Loads and stores go through a shared tile with lanes along the unit
//   stride, so a row-major or a transposed view is read and written
//   coalesced, every load in flight before the first store; the block
//   barriers are two at the start and two at the end. info's slot is read
//   at the start and written at the end by one thread.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE division and
// NaN handling are part of the contract).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "cx.cuh"

namespace {

constexpr int kMaxLeaf = 64;
constexpr int kCols = 8;                     // columns per warp
constexpr int kWarps = kMaxLeaf / kCols;     // 8
constexpr int kThreads = 32 * kWarps;        // 256
constexpr int kLoads = kMaxLeaf * kMaxLeaf / kThreads;  // per thread
constexpr int kTile = kMaxLeaf + 1;          // the load/store tile's row stride
constexpr int kLd = kMaxLeaf;                // col of step k at sh + k·kLd

using cx::mul_rn;
using cx::sub_rn;

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * kMaxLeaf * kTile;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers by shared-window address, computed once per thread
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

// release at CTA scope: this thread's earlier stores are seen by whoever
// acquires the completed phase
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(bar)
               : "memory");
}

// acquire at CTA scope; each barrier completes one phase (parity 0) only
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(bar) : "memory");
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_nopiv_kernel(T* __restrict__ a, long long rs, long long cs, int s,
                int* __restrict__ info, int offset) {
  // the load/store tile (stride kTile), then col of step k at k·kLd
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  __shared__ uint64_t bar[kMaxLeaf];  // col of step k published
  __shared__ int bad_w[kWarps];       // each warp's first bad step
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int cw = w * kCols;           // this warp's first column
  const int r0 = lane, r1 = lane + 32;
  const uint32_t bar0 = smem_addr(bar);  // mbarrier k at bar0 + 8k

  const int slot = threadIdx.x == 0 ? *info : 0;  // read early, used last
  if (threadIdx.x < s) mbar_init(bar0 + 8 * threadIdx.x, 32);
  // load: lanes along the unit stride (rows of a row-major view), every
  // load in flight before the first store to the tile
  const bool by_rows = cs <= rs;
  T v[kLoads];
#pragma unroll
  for (int t = 0; t < kLoads; ++t) {
    const int e = threadIdx.x + t * kThreads;
    const int hi = e / kMaxLeaf, lo = e % kMaxLeaf;
    const int r = by_rows ? hi : lo, c = by_rows ? lo : hi;
    v[t] = r < s && c < s ? a[r * rs + c * cs] : T(0);
  }
#pragma unroll
  for (int t = 0; t < kLoads; ++t) {
    const int e = threadIdx.x + t * kThreads;
    const int hi = e / kMaxLeaf, lo = e % kMaxLeaf;
    sh[(by_rows ? hi : lo) * kTile + (by_rows ? lo : hi)] = v[t];
  }
  __syncthreads();
  T m0[kCols], m1[kCols];  // rows r0 and r1 of columns cw …
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = cw + j;
    m0[j] = r0 < s && c < s ? sh[r0 * kTile + c] : T(0);
    m1[j] = r1 < s && c < s ? sh[r1 * kTile + c] : T(0);
  }
  __syncthreads();  // the tile is read: its memory now holds the cols

  int first_bad = 0;
  T nxt0 = T(0), nxt1 = T(0);  // the col this warp made last
  // col of step k from column k (register jk), after step k − 1
  auto make_col = [&](int k, int jk, bool low) {
    const T d = cx::shfl(k & 32 ? m1[jk] : m0[jk], k & 31);
    const bool bad = cx::bad_pivot(d);
    if (bad && first_bad == 0) first_bad = k + 1;
    const cx::Divisor<T> ds = cx::make_divisor(bad ? T(1) : d);
    const T q1 = cx::divide(m1[jk], ds);
    nxt0 = T(0);
    if (low) {  // rows r0 < 32 lie below the pivot only while k < 31
      const T q0 = cx::divide(m0[jk], ds);
      nxt0 = r0 > k ? q0 : T(0);
    }
    nxt1 = r1 > k ? q1 : T(0);
    sh[k * kLd + r0] = nxt0;
    sh[k * kLd + r1] = nxt1;
    mbar_arrive(bar0 + 8 * k);  // every lane, after its own stores
  };
  if (w == 0) make_col(0, 0, true);

  // the two halves of the rows unrolled: row i is in m0 (h = 0) or m1
#pragma unroll
  for (int h = 0; h < 2; ++h)
  for (int ib = 32 * h; ib < min(s, 32 * h + 32); ib += kCols) {
    const int wi = ib / kCols;  // the warp holding columns ib …
#pragma unroll
    for (int ii = 0; ii < kCols; ++ii) {
      const int i = ib + ii;
      if (i >= s) break;
      const int jn = (ii + 1) % kCols;  // column i + 1's register
      const bool own = w == wi;
      const bool own_next = i + 1 < s && w == (ii + 1 < kCols ? wi : wi + 1);
      // urow on this warp's columns: row i before step i, 0 at and left of i
      T ur[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) ur[j] = T(0);
      if (w >= wi) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const T u = cx::shfl(h ? m1[j] : m0[j], i - 32 * h);
          ur[j] = w > wi || j > ii ? u : T(0);
        }
      }
      T col0 = nxt0, col1 = nxt1;
      if (!own) {
        mbar_wait0(bar0 + 8 * i);
        col0 = sh[i * kLd + r0];
        col1 = sh[i * kLd + r1];
      }
      auto update = [&](int j) {
        const bool at_i = own && j == ii;  // column i: col below the pivot
        m0[j] = sub_rn(at_i && r0 > i ? col0 : m0[j], mul_rn(col0, ur[j]));
        m1[j] = sub_rn(at_i && r1 > i ? col1 : m1[j], mul_rn(col1, ur[j]));
      };
      update(jn);  // column i + 1 first: the next col is made from it
      if (own_next) make_col(i + 1, jn, h == 0);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j != jn) update(j);
    }
  }

  if (lane == 0) bad_w[w] = first_bad;
  __syncthreads();  // every col is read: the memory is the tile again
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    sh[r0 * kTile + cw + j] = m0[j];
    sh[r1 * kTile + cw + j] = m1[j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kMaxLeaf * kMaxLeaf; e += kThreads) {
    const int hi = e / kMaxLeaf, lo = e % kMaxLeaf;
    const int r = by_rows ? hi : lo, c = by_rows ? lo : hi;
    if (r < s && c < s) a[r * rs + c * cs] = sh[r * kTile + c];
  }
  if (threadIdx.x == 0 && slot == 0) {
    // the warps' columns are in order: the first nonzero is the first step
    for (int v = 0; v < kWarps; ++v)
      if (bad_w[v] != 0) {
        *info = offset + bad_w[v];
        break;
      }
  }
}

// The dynamic shared memory limit, raised once per element type and
// device to the tile's size.
template <typename T>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(lu_nopiv_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<T>());
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <typename T>
int lu_nopiv(void* a, long long rs, long long cs, int s, void* info, int offset,
             void* stream) {
  if (s < 1 || s > kMaxLeaf) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<T>();
  if (e != cudaSuccess) return (int)e;
  lu_nopiv_kernel<T><<<1, kThreads, smem_bytes<T>(), (cudaStream_t)stream>>>(
      static_cast<T*>(a), rs, cs, s, static_cast<int*>(info), offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_lu_nopiv_f32(void* a, long long rs, long long cs, int s, void* info,
                       int offset, void* stream) {
  return lu_nopiv<float>(a, rs, cs, s, info, offset, stream);
}

int slate_lu_nopiv_f64(void* a, long long rs, long long cs, int s, void* info,
                       int offset, void* stream) {
  return lu_nopiv<double>(a, rs, cs, s, info, offset, stream);
}

int slate_lu_nopiv_c64(void* a, long long rs, long long cs, int s, void* info,
                       int offset, void* stream) {
  return lu_nopiv<Cx<float>>(a, rs, cs, s, info, offset, stream);
}

int slate_lu_nopiv_c128(void* a, long long rs, long long cs, int s, void* info,
                        int offset, void* stream) {
  return lu_nopiv<Cx<double>>(a, rs, cs, s, info, offset, stream);
}

const char* slate_lu_nopiv_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
