// Cholesky factor of one diagonal tile, one thread block per tile.
//
// Replaces the TPU kernel slate_tpu/ops/pallas_ops.py::chol_tile
// (body _chol_tile_kernel): out = L with A = L·Lᵀ, strict upper
// triangle zeroed. Only the LOWER triangle of the input is read
// (potrf hands over raw lower storage; the upper may be garbage).
// A non-positive or NaN pivot puts NaN on the diagonal from that column
// on: potrf reads failure off isnan(diag(L)).
//
// What bounds it: b³/3 flops along one serial chain of b pivots, so it
// is latency-bound, not bound by bytes or flop rate (at b = 512 the
// tile is 1 MiB and fits L2 many times over). The design keeps the
// chain inside one block: the tile is walked in MB-wide column panels,
// left-looking. Each panel (rows j0..b, MB columns) is staged in shared
// memory, receives the update from all columns to its left in one pass
// (each thread owns a row and keeps MB accumulators in registers; the
// MB×KC slice of those columns' pivot rows is broadcast from shared
// memory), and is then factored column by column in shared memory with
// three barriers per column. The factored panel goes back to global
// memory, where the next panels read it (L2-resident). No tensor cores,
// no cluster: a right first kernel; wgmma and TMA are later work.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math: the NaN contract
// needs IEEE sqrt and division.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kKC = 64;                      // k-chunk of the left update
constexpr size_t kSmemBudget = 200 * 1024;   // of the 227 KB a block may use

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T, int MB>
__global__ void __launch_bounds__(kThreads)
chol_tile_kernel(const T* __restrict__ a, T* __restrict__ out, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = MB + 1;                 // padded row: no bank conflicts
  T* P = reinterpret_cast<T*>(smem_raw);     // panel, (b - j0) x LD
  T* top = P + (size_t)b * LD;               // MB x kKC pivot-row chunk
  __shared__ T piv;
  const int tid = threadIdx.x;

  // strict upper triangle of the result is zero
  for (int r = 0; r < b; ++r)
    for (int c = r + 1 + tid; c < b; c += kThreads) out[(size_t)r * b + c] = T(0);

  for (int j0 = 0; j0 < b; j0 += MB) {
    const int w = min(MB, b - j0);
    const int rows = b - j0;
    // 1. stage the panel; entries above the diagonal are never read
    for (int idx = tid; idx < rows * MB; idx += kThreads) {
      const int r = idx / MB, c = idx % MB;
      P[r * LD + c] = (c < w && r >= c) ? a[(size_t)(j0 + r) * b + j0 + c] : T(0);
    }
    // 2. left-looking update: P -= L[j0:, :j0] · L[j0:j0+w, :j0]ᵀ
    for (int k0 = 0; k0 < j0; k0 += kKC) {
      const int kc = min(kKC, j0 - k0);
      __syncthreads();
      for (int idx = tid; idx < MB * kKC; idx += kThreads) {
        const int c = idx / kKC, k = idx % kKC;
        top[idx] = (c < w && k < kc) ? out[(size_t)(j0 + c) * b + k0 + k] : T(0);
      }
      __syncthreads();
      for (int r = tid; r < rows; r += kThreads) {
        T acc[MB];
#pragma unroll
        for (int c = 0; c < MB; ++c) acc[c] = T(0);
        const T* lrow = out + (size_t)(j0 + r) * b + k0;
        for (int k = 0; k < kc; ++k) {
          const T l = lrow[k];
#pragma unroll
          for (int c = 0; c < MB; ++c) acc[c] += l * top[c * kKC + k];
        }
#pragma unroll
        for (int c = 0; c < MB; ++c) P[r * LD + c] -= acc[c];
      }
    }
    __syncthreads();
    // 3. right-looking factor of the staged panel
    for (int c = 0; c < w; ++c) {
      if (tid == 0) {
        const T d = P[c * LD + c];
        const T s = (d > T(0)) ? sqrt(d) : quiet_nan<T>();
        P[c * LD + c] = s;
        piv = s;
      }
      __syncthreads();
      const T s = piv;
      for (int r = c + 1 + tid; r < rows; r += kThreads) P[r * LD + c] /= s;
      __syncthreads();
      for (int r = c + 1 + tid; r < rows; r += kThreads) {
        const T lr = P[r * LD + c];
        for (int c2 = c + 1; c2 < w; ++c2) P[r * LD + c2] -= lr * P[c2 * LD + c];
      }
      __syncthreads();
    }
    // 4. write the factored panel back (zeros above the diagonal)
    for (int idx = tid; idx < rows * w; idx += kThreads) {
      const int r = idx / w, c = idx % w;
      out[(size_t)(j0 + r) * b + j0 + c] = (r >= c) ? P[r * LD + c] : T(0);
    }
    __syncthreads();
  }
}

template <typename T, int MB>
size_t smem_bytes(int b) {
  return ((size_t)b * (MB + 1) + (size_t)MB * kKC) * sizeof(T);
}

template <typename T, int MB>
int launch(const void* a, void* out, int b, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, MB>(b);
  cudaError_t e = cudaFuncSetAttribute(
      chol_tile_kernel<T, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  chol_tile_kernel<T, MB><<<1, kThreads, bytes, stream>>>(
      static_cast<const T*>(a), static_cast<T*>(out), b);
  return (int)cudaGetLastError();
}

// widest panel whose staging fits the shared-memory budget
template <typename T>
int chol_tile(const void* a, void* out, int b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0) return (int)cudaErrorInvalidValue;
  if (smem_bytes<T, 32>(b) <= kSmemBudget) return launch<T, 32>(a, out, b, s);
  if (smem_bytes<T, 16>(b) <= kSmemBudget) return launch<T, 16>(a, out, b, s);
  if (smem_bytes<T, 8>(b) <= kSmemBudget) return launch<T, 8>(a, out, b, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int slate_chol_tile_f32(const void* a, void* out, int b, void* stream) {
  return chol_tile<float>(a, out, b, stream);
}

int slate_chol_tile_f64(const void* a, void* out, int b, void* stream) {
  return chol_tile<double>(a, out, b, stream);
}

// largest tile the kernel takes (the 8-wide panel must fit shared memory)
int slate_chol_tile_max_b(int elem_bytes) {
  return (int)((kSmemBudget / elem_bytes - 8 * kKC) / 9);
}

const char* slate_chol_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
