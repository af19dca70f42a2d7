// Shared pieces of the multi-block panel kernels (K2 lu_panel.cu, K4 in
// qr_panel.cu): one cooperative launch of G blocks, block b owning the
// contiguous row slab [b·R, min(H, (b+1)·R)) of an (H × w) row-major
// panel, with one grid-wide barrier per step.
//
// The plan (G, R, resident) is computed on the host from the shape, the
// type and the card's SM count (hopper_ops.panel_grid_plan); the C
// launchers only check it: every block owns at least one row, a resident
// slab fits the block's shared memory, and all G blocks can be resident
// at once (a cooperative launch refuses a grid that cannot be).
//
// Data that one block publishes for the others lives in a global scratch
// buffer. It is written with plain stores before the barrier and read
// after it with __ldcg (through L2, never from a stale L1 line).

#pragma once

#include <cuda_runtime.h>

namespace grid_panel {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Grid-wide barrier on a counter that starts at 0 (the wrapper zeroes
// it) and grows by G per barrier: the k-th barrier (k = 1, 2, ...) waits
// for the count k·G. Every block passes the same sequence of barriers.
// The fence before the arrival publishes the block's global writes
// (ordered before it by __syncthreads); the fence after the wait orders
// the block's later reads after the other blocks' writes.
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// One cooperative launch of `kernel` with G blocks of kThreads threads
// and `smem` bytes of dynamic shared memory. Returns a cudaError_t: the
// attribute, the co-residency check (G ≤ SMs × resident blocks per SM)
// or the launch itself.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int G, size_t smem, void** args,
                       void* stream) {
  int dev = 0, coop = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (G < 1 || G > per_sm * n_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(G), dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Does (G, R) cover [0, H) with no empty block?
inline bool plan_covers(int H, int G, int R) {
  return H > 0 && G >= 1 && R >= 1 && (long long)(G - 1) * R < H &&
         (long long)G * R >= H;
}

}  // namespace grid_panel
