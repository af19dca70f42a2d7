// Partial-pivot LU of one tall (H × w) row-major panel, w ≤ 128, as one
// cooperative launch of G blocks with the panel spread over the SMs, in
// float32, float64, complex64 and complex128.
//
// Replaces the TPU kernel slate_tpu/ops/pallas_ops.py::lu_panel_base
// (body _lu_panel_kernel) with the contract of
// slate_tpu/ops/blocked.py::_panel_getrf_base: returns lu (L below the
// diagonal with unit diagonal implied, U on and above), a gather perm
// with a[perm] = L·U, and info = 1-based index of the first zero or NaN
// pivot (0 if none; that column divides by 1 instead). A pivot is the
// first argmax of the modulus |a| (hypot for a complex entry, as jnp.abs)
// and it is bad when isnan(|d|) or |d| == 0, the reference's test.
//
// Design. Block b owns the row slab [b·R, min(H, (b+1)·R)) (grid_panel.cuh;
// the host plans G and R). In the resident mode the slab is loaded once
// into shared memory and written once to lu at the end; in the streaming
// mode (a slab too large for shared memory) it stays in lu and the block
// reads its own rows through L1/L2. Per column j, one grid barrier:
//  (1) each block finds its first argmax of |a[i, j]| over its rows
//      i ≥ j, under jnp.argmax's rule (NaN is the maximum, ties go to the
//      lowest index; beats() is a total order on (value, index), so any
//      reduction order gives the same p);
//  (2) it publishes (value, index, the candidate's whole row, its perm
//      entry) to its slot of the scratch, and the owner of row j publishes
//      row j as it stands with its perm entry; the scratch is double
//      buffered by the parity of j, so one barrier per column is enough;
//  (3) grid barrier;
//  (4) every block reduces the G candidates to the same p and copies the
//      winning row (the U row) into shared memory;
//  (5) the owner of row j writes the U row there, the owner of row p
//      writes the old row j there, and both swap the perm entries (p == j
//      and a swap inside one slab fall out of the same code);
//  (6) each block scales its rows below j and applies their rank-1
//      update, one warp per row.
// Products and differences are rounded separately (mul_rn/sub_rn, no FMA
// contraction) and the scale is an IEEE division (in complex types
// csrc/cx.cuh's products and Smith quotient, the divisor's ratio and scale
// made once per column), so the result is bitwise the plain PyTorch
// version's (hopper_ops.lu_panel_base_plain). Every block computes each
// candidate's modulus with the same function, so all take the same pivot.
//
// What bounds it: the w serial steps, each a grid barrier and a handful
// of block barriers, and not the panel's bytes, which cross HBM once each
// way (8 MiB at 16384 × 128 f32: a 5.0 µs bound). Measured by
// chip_smoke.py on an H100 80GB HBM3 at 700 W: about 0.9 ms at
// 16384 × 128 f32 (132 resident slabs of 125 rows, about 7 µs per
// column), against 44.7 ms for the one-block version before it, which
// re-read the whole panel through one SM per column; about 4.5 ms at
// 65536 × 128 f32 (streaming). PERF.md keeps the times of each run.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE division and
// NaN handling are part of the contract).

#include <cuda_runtime.h>
#include <climits>

#include "cx.cuh"
#include "grid_panel.cuh"

namespace {

using grid_panel::grid_barrier;
using grid_panel::kThreads;
using grid_panel::kWarps;

using cx::mul_rn;
using cx::sub_rn;

// does candidate (va, ia) beat (vb, ib) under jnp.argmax's rule?
template <typename T>
__device__ __forceinline__ bool beats(T va, int ia, T vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

template <typename T>
__device__ __forceinline__ void warp_argmax(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// One scratch slot: w row entries, then the value (a modulus, real), the
// row index and the perm entry. Slots 0..G−1 hold the blocks' candidates,
// slot G row j.
__host__ __device__ inline size_t slot_bytes(int w, int itemsize) {
  return ((size_t)w * itemsize + 16 + 15) / 16 * 16;
}

template <typename T>
struct Slot {
  using R = real_t<T>;
  unsigned char* p;
  int w;
  __device__ T* row() const { return reinterpret_cast<T*>(p); }
  __device__ R* value() const { return reinterpret_cast<R*>(p + w * sizeof(T)); }
  __device__ int* index() const { return reinterpret_cast<int*>(p + w * sizeof(T) + 8); }
  __device__ int* perm() const { return reinterpret_cast<int*>(p + w * sizeof(T) + 12); }
};

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
lu_panel_kernel(const T* __restrict__ a, T* lu, int* perm, int* info, int H,
                int w, int R, unsigned char* scratch, unsigned int* bar) {
  using RT = real_t<T>;  // a modulus (R is the rows per block)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ RT red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_p;
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = b * R, r1 = min(H, r0 + R);
  T* urow = reinterpret_cast<T*>(smem_raw);  // the U row of column j
  T* slab = kResident ? urow + w : lu + (size_t)r0 * w;
  const size_t sb = slot_bytes(w, sizeof(T));
  int first_bad = 0;

  const size_t cells = (size_t)(r1 - r0) * w;
  for (size_t k = tid; k < cells; k += kThreads) slab[k] = a[(size_t)r0 * w + k];
  for (int i = r0 + tid; i < r1; i += kThreads) perm[i] = i;
  __syncthreads();

  for (int j = 0; j < w; ++j) {
    unsigned char* base = scratch + (size_t)(j & 1) * (G + 1) * sb;
    const Slot<T> mine{base + b * sb, w}, jslot{base + G * sb, w};
    // (1) this block's candidate
    RT bv = RT(-1);
    int bi = INT_MAX;
    for (int i = max(j, r0) + tid; i < r1; i += kThreads) {
      const RT v = cx::modulus(slab[(size_t)(i - r0) * w + j]);
      if (beats(v, i, bv, bi)) { bv = v; bi = i; }
    }
    warp_argmax(bv, bi);
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : RT(-1);
      bi = lane < kWarps ? red_i[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) {
        *mine.value() = bv;
        *mine.index() = bi;
        *mine.perm() = bi != INT_MAX ? perm[bi] : -1;
        s_p = bi;
      }
    }
    __syncthreads();
    // (2) publish the candidate row and, from row j's owner, row j
    const int li = s_p;
    if (li != INT_MAX)
      for (int c = tid; c < w; c += kThreads)
        mine.row()[c] = slab[(size_t)(li - r0) * w + c];
    const bool own_j = r0 <= j && j < r1;
    if (own_j) {
      for (int c = tid; c < w; c += kThreads)
        jslot.row()[c] = slab[(size_t)(j - r0) * w + c];
      if (tid == 0) *jslot.perm() = perm[j];
    }
    // (3)
    grid_barrier(bar, (unsigned int)(j + 1) * G);
    // (4) the same p in every block
    if (warp == 0) {
      RT v = RT(-1);
      int i = INT_MAX;
      for (int g = lane; g < G; g += 32) {
        const Slot<T> s{base + g * sb, w};
        const RT gv = __ldcg(s.value());
        const int gi = __ldcg(s.index());
        if (beats(gv, gi, v, i)) { v = gv; i = gi; }
      }
      warp_argmax(v, i);
      if (lane == 0) s_p = i;
    }
    __syncthreads();
    const int p = s_p;
    const Slot<T> win{base + (p / R) * sb, w};
    for (int c = tid; c < w; c += kThreads) {
      const T u = cx::ldcg(win.row() + c);
      urow[c] = u;
      // (5) the swap: U row to j, old row j to p
      if (own_j) slab[(size_t)(j - r0) * w + c] = u;
      if (r0 <= p && p < r1)
        slab[(size_t)(p - r0) * w + c] = cx::ldcg(jslot.row() + c);
    }
    if (tid == 0) {
      if (own_j) perm[j] = __ldcg(win.perm());
      if (r0 <= p && p < r1) perm[p] = __ldcg(jslot.perm());
    }
    __syncthreads();
    // (6) info, the safe divisor, scale and rank-1 update of the rows below j
    const T d = urow[j];
    const bool bad = cx::bad_pivot(d);
    if (bad && first_bad == 0) first_bad = j + 1;
    const cx::Divisor<T> dsafe = cx::make_divisor(bad ? T(1) : d);
    for (int i = max(j + 1, r0) + warp; i < r1; i += kWarps) {
      T* row = slab + (size_t)(i - r0) * w;
      const T l = cx::divide(row[j], dsafe);
      for (int c = j + 1 + lane; c < w; c += 32)
        row[c] = sub_rn(row[c], mul_rn(l, urow[c]));
      __syncwarp();
      if (lane == 0) row[j] = l;
    }
    __syncthreads();
  }
  if (kResident)
    for (size_t k = tid; k < cells; k += kThreads) lu[(size_t)r0 * w + k] = slab[k];
  if (b == 0 && tid == 0) *info = first_bad;
}

template <typename T>
int lu_panel(const void* a, void* lu, void* perm, void* info, int H, int w,
             int G, int R, int resident, void* scratch, void* bar,
             void* stream) {
  if (w <= 0 || w > 128 || H < w || !grid_panel::plan_covers(H, G, R))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)w * sizeof(T) +
                      (resident ? (size_t)R * w * sizeof(T) : 0);
  void* args[] = {&a, &lu, &perm, &info, &H, &w, &R, &scratch, &bar};
  return resident
             ? grid_panel::launch_cooperative(lu_panel_kernel<T, true>, G, smem,
                                              args, stream)
             : grid_panel::launch_cooperative(lu_panel_kernel<T, false>, G,
                                              smem, args, stream);
}

}  // namespace

extern "C" {

// bytes of global scratch one launch needs (two parities of G + 1 slots)
long long slate_lu_panel_scratch_bytes(int G, int w, int itemsize) {
  return (long long)(2 * (size_t)(G + 1) * slot_bytes(w, itemsize));
}

int slate_lu_panel_f32(const void* a, void* lu, void* perm, void* info, int H,
                       int w, int G, int R, int resident, void* scratch,
                       void* bar, void* stream) {
  return lu_panel<float>(a, lu, perm, info, H, w, G, R, resident, scratch, bar,
                         stream);
}

int slate_lu_panel_f64(const void* a, void* lu, void* perm, void* info, int H,
                       int w, int G, int R, int resident, void* scratch,
                       void* bar, void* stream) {
  return lu_panel<double>(a, lu, perm, info, H, w, G, R, resident, scratch,
                          bar, stream);
}

int slate_lu_panel_c64(const void* a, void* lu, void* perm, void* info, int H,
                       int w, int G, int R, int resident, void* scratch,
                       void* bar, void* stream) {
  return lu_panel<Cx<float>>(a, lu, perm, info, H, w, G, R, resident, scratch,
                             bar, stream);
}

int slate_lu_panel_c128(const void* a, void* lu, void* perm, void* info, int H,
                        int w, int G, int R, int resident, void* scratch,
                        void* bar, void* stream) {
  return lu_panel<Cx<double>>(a, lu, perm, info, H, w, G, R, resident,
                              scratch, bar, stream);
}

const char* slate_lu_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
