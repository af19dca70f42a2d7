// LU without pivoting of one square s × s leaf, s ≤ 64, in float32 and
// float64: L\U packed (unit lower L implied) and info, the 1-based first
// step whose pivot is 0 or NaN (0 if none); that step goes on with the
// pivot taken as 1.
//
// No Pallas kernel: this is the port's counterpart of the reference's
// unblocked leaf, slate_tpu/linalg/lu.py::_lu_nopiv_unblocked (one
// fori_loop program), with the contract of the plain version
// hopper_ops.lu_nopiv_base_plain. Step i computes
//     col = a[:, i] / dsafe on the rows below i (0 elsewhere),
//     a[r, i] = col[r] below i,
//     a = a − col ⊗ urow, urow = a[i, :] right of i (0 elsewhere),
// over the WHOLE leaf, as the reference does, so a non-finite entry
// spreads to the same places (0·Inf = NaN) as in the plain version.
// Products and differences are rounded separately (no FMA contraction) and
// the scale is an IEEE division, so the result is bitwise the plain
// version's.
//
// Design. One block, the leaf in shared memory, s serial steps with one
// __syncthreads each. Row r belongs to a group of 16 lanes of one warp
// (the block rounded up to whole warps, so every shuffle has 32 lanes),
// lane g owning the columns g, g + 16, …; the lane that owns column i
// computes the row's multiplier and hands it to the group by a shuffle.
// Row i itself is read by the other rows from a copy (urow) that its own
// group wrote during step i − 1, double buffered by the parity of i, so no
// row reads another row's entries while they are written. info stays on
// the device.
//
// What bounds it: the s serial steps (a barrier and about s/16 dependent
// update pairs each per thread), not the leaf's bytes nor its 2s³/3
// operations. A first, simple kernel; PERF.md keeps its times.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE division and
// NaN handling are part of the contract).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaf = 64;
constexpr int kGroup = 16;        // lanes per row
constexpr int kPad = 16;          // shared row padding, in elements

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }

template <typename T>
__global__ void lu_nopiv_kernel(const T* __restrict__ a, T* __restrict__ lu,
                                int* __restrict__ info, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = s + kPad;
  T* m = reinterpret_cast<T*>(smem_raw);  // s rows of ld
  T* urow = m + s * ld;                   // 2 × s: row i at step i
  const int tid = threadIdx.x;
  const int r = tid / kGroup, g = tid % kGroup;
  const bool row_ok = r < s;  // the block is rounded up to whole warps
  for (int e = tid; e < s * s; e += blockDim.x) {
    const int i = e / s, c = e - i * s;
    m[i * ld + c] = a[e];
    if (i == 0) urow[c] = a[e];
  }
  __syncthreads();
  int first_bad = 0;
  for (int i = 0; i < s; ++i) {
    const T* u = urow + (i & 1) * s;
    const T d = u[i];
    const bool bad = isnan(d) || d == T(0);
    if (bad && first_bad == 0) first_bad = i + 1;
    const T dsafe = bad ? T(1) : d;
    // the row's multiplier, computed by the lane owning column i
    T col = T(0);
    if (row_ok && r > i && g == i % kGroup) col = div_rn(m[r * ld + i], dsafe);
    col = __shfl_sync(0xFFFFFFFFu, col, i % kGroup, kGroup);
    if (row_ok && r > i) {
      for (int c = g; c < s; c += kGroup) {
        const T ur = c > i ? u[c] : T(0);
        const T base = c == i ? col : m[r * ld + c];
        m[r * ld + c] = sub_rn(base, mul_rn(col, ur));
      }
      if (r == i + 1)
        for (int c = g; c < s; c += kGroup) urow[((i + 1) & 1) * s + c] = m[r * ld + c];
    } else if (row_ok) {
      // col is 0 on this row: only 0·urow right of i can change it (NaN
      // from a non-finite urow entry, or a zero's sign)
      for (int c = g; c < s; c += kGroup)
        if (c > i) m[r * ld + c] = sub_rn(m[r * ld + c], mul_rn(T(0), u[c]));
    }
    __syncthreads();
  }
  for (int e = tid; e < s * s; e += blockDim.x) {
    const int i = e / s, c = e - i * s;
    lu[e] = m[i * ld + c];
  }
  if (tid == 0) *info = first_bad;
}

template <typename T>
int lu_nopiv(const void* a, void* lu, void* info, int s, void* stream) {
  if (s < 1 || s > kMaxLeaf) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)s * (s + kPad) + 2 * (size_t)s) * sizeof(T);
  const int threads = (s * kGroup + 31) / 32 * 32;
  lu_nopiv_kernel<T><<<1, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(a), static_cast<T*>(lu), static_cast<int*>(info), s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slate_lu_nopiv_f32(const void* a, void* lu, void* info, int s,
                       void* stream) {
  return lu_nopiv<float>(a, lu, info, s, stream);
}

int slate_lu_nopiv_f64(const void* a, void* lu, void* info, int s,
                       void* stream) {
  return lu_nopiv<double>(a, lu, info, s, stream);
}

const char* slate_lu_nopiv_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
