// Partial-pivot LU of every (H × w) chunk of a contiguous row-major
// (B, H, w) stack, w ≤ H, in float32, float64, complex64 and complex128:
// P3 lu_panel_batched, one thread-block cluster
// of C CTAs per chunk and every chunk in one launch, so one launch is one
// round of the CALU tournament.
//
// No Pallas kernel: replaces the reference's one batched program per
// tournament round, slate_tpu/ops/blocked.py::panel_getrf_batched (body
// _panel_getrf_batched_impl, a fori_loop of w column steps over every
// chunk at once), with its contract per chunk, which is
// _panel_getrf_base's: lu (L below the diagonal with unit diagonal
// implied, U on and above), a gather perm with chunk[perm] = L·U, and
// info = 1-based index of the first zero or NaN pivot (0 if none; that
// column divides by 1 instead). The pivot and the bad-pivot test are
// lu_panel.cu's: the first argmax of the modulus (hypot for a complex
// entry), bad when isnan(|d|) or |d| == 0.
//
// What bounds it: not the card's operations or HBM bytes (a round's
// stack is at most 32 MB in f32 at nb = 512) but the w serial column
// steps of each chunk, each a pivot search over the whole chunk, a row
// swap and a rank-1 update of the trailing block. One block per chunk
// would push every update through one SM's path to L2, and a round of
// few chunks (most rounds have 1 to 4) would use few of the 132 SMs.
//
// Design. The C CTAs of a cluster share one chunk (the plan,
// hopper_ops.lu_panel_batched_plan, pure Python, picks C ∈ {1, 2, 4, 8,
// 16} and the mode; the launcher only checks it). Row i of the chunk is
// CTA i mod C's slot i / C, cyclically, so the active rows stay spread
// over the CTAs as j grows. A CTA holds its slots in shared memory
// ("resident") or, when they do not fit, in a global scratch row block of
// its own ("streaming", read back through L1/L2).
//
// Slots never move. The plain version swaps rows j and p; here only the
// two slots' positions are exchanged: the slot at position p becomes
// position j (the U row, never written again), the slot at position j
// becomes position p and stays active. Each slot's position lives with
// the lane and warp that own the slot (slot l is warp l mod 8's,
// always), so the swap needs no message: every CTA derives the same p.
// At the end each slot is written to lu[position], and perm[position] =
// its slot's row.
//
// Per column j, one cluster barrier, split into its arrive (release) and
// its wait (acquire):
//  (1) after the wait, warp 0 reduces the C·8 warps' candidates for
//      column j, which every warp pushed into every CTA's shared memory
//      before it arrived (one 16-byte store per CTA), under jnp.argmax's
//      rule on (|value|, position): NaN is the maximum, ties go to the
//      lowest position, and beats() is a total order, so every CTA gets
//      the same pivot p and its slot;
//  (2) warp 0 copies the U row, columns j.. of p's slot, from its owner
//      into its own shared memory in 16-byte pieces (two buffers, by the
//      parity of j); a block barrier hands p and the row to the warps;
//  (3a) one lane per slot of each warp: the swap of positions, the
//      multiplier l = x[j] / pivot (the pivot taken as 1 when it is zero
//      or NaN), and column j + 1, x[j + 1] −= l·u[j + 1], with the slot's
//      candidate for column j + 1; a shuffle reduction gives the warp's;
//  (3b) the warp finishes its candidate row, columns j + 2.., pushes the
//      candidate into every CTA, and arrives: a row another CTA may read
//      as the next U row is complete before the barrier can let it;
//  (3c) the warp updates its other active slots, columns j + 2.., four
//      slots at a time (one load of u[c] for the four), while the
//      barrier fills. The pivot row is retired at step j + 1 and its
//      owner never writes it again, and the last wait keeps every CTA
//      alive until the others have read its slots.
// Products and differences are rounded separately (mul_rn/sub_rn, no FMA
// contraction) and the scale is an IEEE division (in complex types
// csrc/cx.cuh's products and Smith quotient), so lu, perm and info
// are bitwise the plain PyTorch version's
// (hopper_ops.lu_panel_batched_plain) on the same input: every entry
// takes the same operations in the same order, only at other times.
//
// Measured on an H100 (tools/p3_ablation.py; PERF.md keeps each run):
// about 3.5 µs per column at C = 16 resident, of which about 0.6 µs is
// the exchange with the other CTAs (the candidates, then the U row),
// 0.6 µs the cluster barrier left after the overlap, 0.75 µs the update
// of (3c); the rest is the chain of (1)–(3b) itself. Rounds of more
// chunks than one wave of clusters holds (7 of 16 CTAs at 136 KB of
// shared memory each) take several waves.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE division and
// NaN handling are part of the contract).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstring>

#include "cx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;  // non-portable above 8
constexpr int kGroup = 4;        // slots a warp updates together
constexpr int kCopy = 4;         // loads in flight per lane in a row copy
// candidates a lane of warp 0 compares: the cluster's kWarps · C at most
constexpr int kCandLoads = kMaxCluster * kWarps / 32;

enum Mode { kResident = 0, kStream = 1 };

using cx::mul_rn;
using cx::sub_rn;

// a read of another CTA's slot: through L2 when streaming, else a plain
// load (distributed shared memory)
template <int M, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if (M == kStream) return cx::ldcg(p);
  return *p;
}

// a pivot candidate: |value| (real) at its row's position and that row's
// slot (the chunk's row index, which the row keeps for good)
template <typename T>
struct __align__(16) Cand {
  T v;
  int pos;
  int slot;
};

template <typename T>
__device__ __forceinline__ Cand<T> no_cand() {
  return {T(-1), INT_MAX, 0};
}

// does candidate (va, ia) beat (vb, ib) under jnp.argmax's rule?
template <typename T>
__device__ __forceinline__ bool beats(T va, int ia, T vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

// every lane ends with the warp's best candidate (a butterfly: the order
// is total, so all lanes agree)
template <typename T>
__device__ __forceinline__ void warp_argmax(Cand<T>& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, c.v, off);
    const int op = __shfl_xor_sync(0xffffffffu, c.pos, off);
    const int os = __shfl_xor_sync(0xffffffffu, c.slot, off);
    if (beats(ov, op, c.v, c.pos)) c = Cand<T>{ov, op, os};
  }
}

// the cluster barrier in two halves: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// one candidate in one 16-byte store (into another CTA's shared memory)
template <typename T>
__device__ __forceinline__ void store_cand(Cand<T>* p, const Cand<T>& c) {
  int4 x;
  memcpy(&x, &c, sizeof(c));
  *reinterpret_cast<int4*>(p) = x;
}

// 16 bytes of another CTA's slot: through L2 when streaming
template <int M>
__device__ __forceinline__ uint4 ld16(const uint4* p) {
  if (M == kStream) return __ldcg(p);
  return *p;
}

// one warp copies columns j.. of a row into dst (shared memory), in
// 16-byte pieces when the rows are 16-byte aligned, kCopy in flight
template <int M, typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int j, int w,
                                         int lane) {
  constexpr int V = 16 / sizeof(T);
  if (w % V == 0) {
    for (int c0 = j - j % V + lane * V; c0 < w; c0 += kCopy * 32 * V) {
      uint4 v[kCopy];
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const int c = c0 + u * 32 * V;
        if (c < w) v[u] = ld16<M>(reinterpret_cast<const uint4*>(src + c));
      }
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const int c = c0 + u * 32 * V;
        if (c < w) *reinterpret_cast<uint4*>(dst + c) = v[u];
      }
    }
  } else {
    for (int c0 = j + lane; c0 < w; c0 += kCopy * 32) {
      T v[kCopy];
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const int c = c0 + u * 32;
        if (c < w) v[u] = ld<M>(src + c);
      }
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const int c = c0 + u * 32;
        if (c < w) dst[c] = v[u];
      }
    }
  }
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// shared memory of one CTA (hopper_ops.lu_panel_batched_smem_bytes): the
// cluster's C·kWarps candidates of two columns and the pivot (16 bytes
// each), each slot's position, the U rows of two columns, and, resident,
// the CTA's slots
__host__ __device__ inline size_t smem_bytes(int H, int w, int C, int M,
                                             int itemsize) {
  const size_t rows = (H + C - 1) / C;
  size_t b = (2 * C * kWarps + 1) * 16 + align16(rows * sizeof(int)) +
             2 * align16((size_t)w * itemsize);
  if (M == kResident) b += rows * w * itemsize;
  return b;
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads, 2)
lu_panel_batched_kernel(const T* __restrict__ a, T* __restrict__ lu_all,
                        int* __restrict__ perm_all, int* __restrict__ info,
                        T* __restrict__ scratch, int H, int w) {
  using R = real_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x / C;
  const int rmax = (H + C - 1) / C;
  const int nrows = (H - r + C - 1) / C;  // slots r, r + C, ... < H
  // every warp's best candidate for column j, pushed by that warp into
  // every CTA: [((j & 1) * C + rank) * kWarps + warp]
  Cand<R>* cand = reinterpret_cast<Cand<R>*>(smem_raw);
  int2* piv = reinterpret_cast<int2*>(cand + 2 * C * kWarps);  // (p, its slot)
  int* slot_pos = reinterpret_cast<int*>(cand + 2 * C * kWarps + 1);
  // the U rows of columns j (even and odd), each ulen elements
  const size_t ulen = align16((size_t)w * sizeof(T)) / sizeof(T);
  T* ubuf = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(slot_pos) +
                                 align16((size_t)rmax * sizeof(int)));
  T* const base = M == kResident ? ubuf + 2 * ulen
                                 : scratch + (size_t)chunk * C * rmax * w;
  // this CTA's slots (the same offsets in every CTA's shared memory)
  T* const store = M == kResident ? base : base + (size_t)r * rmax * w;
  const T* src = a + (size_t)chunk * H * w;

  // lane d < C stores this warp's candidate into CTA d's shared memory
  // (posted stores; the next cluster barrier's release orders them)
  auto push = [&](const Cand<R>& c, int buf) {
    if (lane < C)
      store_cand(cluster.map_shared_rank(
                     cand + ((size_t)buf * C + r) * kWarps + warp, lane),
                 c);
  };

  // load: one warp per slot, lanes along the row; column 0's candidates
  Cand<R> best = no_cand<R>();
  for (int l = warp; l < nrows; l += kWarps) {
    const int s = r + l * C;
    const T* in = src + (size_t)s * w;
    T* row = store + (size_t)l * w;
    for (int c = lane; c < w; c += 32) row[c] = in[c];
    if (lane == 0) {
      slot_pos[l] = s;
      const R v = cx::modulus(in[0]);
      if (beats(v, s, best.v, best.pos)) best = Cand<R>{v, s, s};
    }
  }
  warp_argmax(best);
  push(best, 0);
  if (M == kStream) __threadfence();
  cluster_arrive();

  int first_bad = 0;
  for (int j = 0; j < w; ++j) {
    T* const ub = ubuf + (size_t)(j & 1) * ulen;
    // every warp's candidate for column j and that candidate's row,
    // complete through step j − 1, published in every CTA
    cluster_wait();

    // (1) warp 0: the pivot from the C·kWarps candidates (pushed here),
    // then (2) the U row, columns j.. of its slot, from its owner
    if (warp == 0) {
      Cand<R> got[kCandLoads];
#pragma unroll
      for (int i = 0; i < kCandLoads; ++i) {
        const int q = lane + 32 * i;
        got[i] = q < C * kWarps ? cand[(j & 1) * C * kWarps + q]
                                : no_cand<R>();
      }
      Cand<R> pc = got[0];
#pragma unroll
      for (int i = 1; i < kCandLoads; ++i)
        if (beats(got[i].v, got[i].pos, pc.v, pc.pos)) pc = got[i];
      warp_argmax(pc);
      const int owner = pc.slot % C, lp = pc.slot / C;
      const T* urow =
          M == kResident ? cluster.map_shared_rank(base + (size_t)lp * w, owner)
                         : base + ((size_t)owner * rmax + lp) * w;
      copy_row<M>(ub, urow, j, w, lane);
      if (lane == 0) *piv = make_int2(pc.pos, pc.slot);
    }
    __syncthreads();
    const int p = piv->x, sp = piv->y;
    const T d = ub[j];
    const bool bad = cx::bad_pivot(d);
    if (bad && first_bad == 0) first_bad = j + 1;
    const cx::Divisor<T> dsafe = cx::make_divisor(bad ? T(1) : d);

    // (3a) one lane per slot of this warp: the swap of positions, the
    // multiplier, and column j + 1 with the slot's candidate for it
    best = no_cand<R>();
    for (int i0 = 0; warp + i0 * kWarps < nrows; i0 += 32) {
      const int l = warp + (i0 + lane) * kWarps;
      if (l >= nrows) continue;
      const int s = r + l * C, pos = slot_pos[l];
      const int np = s == sp ? j : (pos == j ? p : pos);
      slot_pos[l] = np;
      if (np <= j) continue;  // a U row, or the new one
      T* row = store + (size_t)l * w;
      const T lj = cx::divide(row[j], dsafe);
      row[j] = lj;
      if (j + 1 < w) {
        const T x = sub_rn(row[j + 1], mul_rn(lj, ub[j + 1]));
        row[j + 1] = x;
        const R v = cx::modulus(x);
        if (beats(v, np, best.v, best.pos)) best = Cand<R>{v, np, s};
      }
    }
    warp_argmax(best);
    __syncwarp();
    // (3b) the warp's candidate row, columns j + 2.., then publish it: the
    // row is complete when the next column's barrier lets others read it
    const int cl = best.pos == INT_MAX ? -1 : (best.slot - r) / C;
    if (cl >= 0) {
      T* row = store + (size_t)cl * w;
      const T lj = row[j];
#pragma unroll 4
      for (int c = j + 2 + lane; c < w; c += 32)
        row[c] = sub_rn(row[c], mul_rn(lj, ub[c]));
    }
    push(best, (j + 1) & 1);
    if (M == kStream) __threadfence();
    cluster_arrive();

    // (3c) the warp's other active slots, columns j + 2.., kGroup at a
    // time (one load of u[c] for all of them), while the barrier fills
    for (int l0 = warp; l0 < nrows; l0 += kGroup * kWarps) {
      T* rp[kGroup];
      T lm[kGroup];
      bool act[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int l = l0 + k * kWarps;
        rp[k] = store + (size_t)min(l, nrows - 1) * w;
        act[k] = l < nrows && l != cl && slot_pos[l] > j;
        lm[k] = act[k] ? rp[k][j] : T(0);
      }
      // two columns per lane and pass; every load before any store, so
      // the loads of the kGroup rows overlap
      for (int c = j + 2 + lane; c < w; c += 64) {
        const bool two = c + 32 < w;
        const T u0 = ub[c], u1 = two ? ub[c + 32] : T(0);
        T x0[kGroup], x1[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          x0[k] = act[k] ? rp[k][c] : T(0);
          x1[k] = act[k] && two ? rp[k][c + 32] : T(0);
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (act[k]) rp[k][c] = sub_rn(x0[k], mul_rn(lm[k], u0));
          if (act[k] && two) rp[k][c + 32] = sub_rn(x1[k], mul_rn(lm[k], u1));
        }
      }
    }
  }
  // the last arrive: no CTA leaves while another may still read its slots
  cluster_wait();

  // each slot to lu[position]; perm[position] = the slot's row
  for (int l = warp; l < nrows; l += kWarps) {
    const int s = r + l * C, pos = slot_pos[l];
    const T* row = store + (size_t)l * w;
    T* out = lu_all + ((size_t)chunk * H + pos) * w;
    for (int c = lane; c < w; c += 32) out[c] = row[c];
    if (lane == 0) perm_all[(size_t)chunk * H + pos] = s;
  }
  if (r == 0 && tid == 0) info[chunk] = first_bad;
}

// the launch configuration of B clusters of C CTAs
template <typename T, int M>
cudaError_t configure(int B, int C, size_t smem, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  auto kernel = lu_panel_batched_kernel<T, M>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(B * C);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// the most clusters of this plan the card can hold at once
template <typename T, int M>
cudaError_t max_clusters(int B, int C, size_t smem, cudaStream_t stream,
                         int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<T, M>(B, C, smem, stream, &cfg, attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(clusters, lu_panel_batched_kernel<T, M>,
                                        &cfg);
}

// one launch; refused when the card cannot hold one such cluster
template <typename T, int M>
int launch(const void* a, void* lu, void* perm, void* info, void* scratch,
           int B, int H, int w, int C, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<T, M>(B, C, smem, stream, &cfg, attr);
  if (e != cudaSuccess) return (int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, lu_panel_batched_kernel<T, M>,
                                     &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, lu_panel_batched_kernel<T, M>,
                         static_cast<const T*>(a), static_cast<T*>(lu),
                         static_cast<int*>(perm), static_cast<int*>(info),
                         static_cast<T*>(scratch), H, w);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the plan's arguments and its shared memory against the card's limit
template <typename T>
cudaError_t check_plan(int B, int H, int w, int C, int resident,
                       size_t* smem) {
  if (B <= 0 || w <= 0 || H < w || C < 1 || C > kMaxCluster ||
      (C & (C - 1)) != 0 || C > H || (long long)B * C > INT_MAX)
    return cudaErrorInvalidValue;
  *smem = smem_bytes(H, w, C, resident ? kResident : kStream, sizeof(T));
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  return *smem > (size_t)optin ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename T>
int lu_panel_batched(const void* a, void* lu, void* perm, void* info,
                     void* scratch, int B, int H, int w, int C, int resident,
                     void* stream) {
  size_t smem = 0;
  const cudaError_t e = check_plan<T>(B, H, w, C, resident, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident)
    return launch<T, kResident>(a, lu, perm, info, scratch, B, H, w, C, smem,
                                s);
  return launch<T, kStream>(a, lu, perm, info, scratch, B, H, w, C, smem, s);
}

template <typename T>
int lu_panel_batched_clusters(int B, int H, int w, int C, int resident,
                              int* clusters) {
  size_t smem = 0;
  const cudaError_t e = check_plan<T>(B, H, w, C, resident, &smem);
  if (e != cudaSuccess) return (int)e;
  if (resident)
    return (int)max_clusters<T, kResident>(B, C, smem, 0, clusters);
  return (int)max_clusters<T, kStream>(B, C, smem, 0, clusters);
}

}  // namespace

extern "C" {

int slate_lu_panel_batched_f32(const void* a, void* lu, void* perm, void* info,
                               void* scratch, int B, int H, int w, int C,
                               int resident, void* stream) {
  return lu_panel_batched<float>(a, lu, perm, info, scratch, B, H, w, C,
                                 resident, stream);
}

int slate_lu_panel_batched_f64(const void* a, void* lu, void* perm, void* info,
                               void* scratch, int B, int H, int w, int C,
                               int resident, void* stream) {
  return lu_panel_batched<double>(a, lu, perm, info, scratch, B, H, w, C,
                                  resident, stream);
}

int slate_lu_panel_batched_c64(const void* a, void* lu, void* perm, void* info,
                               void* scratch, int B, int H, int w, int C,
                               int resident, void* stream) {
  return lu_panel_batched<Cx<float>>(a, lu, perm, info, scratch, B, H, w, C,
                                     resident, stream);
}

int slate_lu_panel_batched_c128(const void* a, void* lu, void* perm,
                                void* info, void* scratch, int B, int H, int w,
                                int C, int resident, void* stream) {
  return lu_panel_batched<Cx<double>>(a, lu, perm, info, scratch, B, H, w, C,
                                      resident, stream);
}

// the shared memory per CTA that the launcher sizes a plan with, so the
// plan's copy of the formula (hopper_ops.lu_panel_batched_smem_bytes) can
// be held against it
long long slate_lu_panel_batched_smem_bytes(int H, int w, int C, int resident,
                                            int itemsize) {
  return (long long)smem_bytes(H, w, C, resident ? kResident : kStream,
                               itemsize);
}

// how many clusters of the plan the card holds at once
// (cudaOccupancyMaxActiveClusters), for timing the plans against each other
int slate_lu_panel_batched_f32_clusters(int B, int H, int w, int C,
                                        int resident, int* clusters) {
  return lu_panel_batched_clusters<float>(B, H, w, C, resident, clusters);
}

int slate_lu_panel_batched_f64_clusters(int B, int H, int w, int C,
                                        int resident, int* clusters) {
  return lu_panel_batched_clusters<double>(B, H, w, C, resident, clusters);
}

int slate_lu_panel_batched_c64_clusters(int B, int H, int w, int C,
                                        int resident, int* clusters) {
  return lu_panel_batched_clusters<Cx<float>>(B, H, w, C, resident, clusters);
}

int slate_lu_panel_batched_c128_clusters(int B, int H, int w, int C,
                                         int resident, int* clusters) {
  return lu_panel_batched_clusters<Cx<double>>(B, H, w, C, resident,
                                               clusters);
}

const char* slate_lu_panel_batched_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
