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
// chain of dependent steps. Pair (j, i) needs L[j][j] after pairs
// (j, 0..i−1) and w[j][i] after the rotations (c < j, i) of row j, so it
// waits on pair (j, i−1) and on pair (j−1, i) through one rotation of row
// j: the chain is n + kb − 1 pair steps, not n·kb.
//
// Design: one thread per row, the row's kb entries of W in registers; the
// rows' entries of L in 32-column blocks of shared memory, one block per
// warp (a warp owns 32 consecutive rows), double-buffered where two fit
// (plan hopper_ops.chol_update_plan), each next block fetched by cp.async
// while the current one is worked, so no global load sits on the chain.
// - CTA b of an item owns rows [b·R, (b+1)·R). It first applies, 32
//   columns at a time, the pairs that the CTAs above it publish (spinning
//   on their progress counters), every thread its own row, in the
//   wavefront order below (in column order once a downdate has failed);
// - then its diagonal block, one 32-column panel per warp: warp p's rows
//   are panel p's rows and columns. Warp p makes the panel's pairs as a
//   (column, vector) wavefront: at step t its lane l makes pair
//   (j0 + l, t − l), keeping its diagonal in a register, and every lane
//   then applies the step's pairs (c, t − c) of the columns left of its
//   row, so the panel takes w + kb − 1 warp-synchronous steps with no
//   block-wide barrier. A row keeps the kb entries a step touches in
//   registers (a window shifted by one column a step; not in the largest
//   instance, complex128 at kb = 16, where it would spill). The pairs go to
//   shared memory, a step's side by side (read 16 bytes at a time), and
//   each step is released through the panel's step counter there
//   (release and acquire at CTA scope); the warps below follow the front
//   step by step, each row applying the step's pairs to its own entries,
//   so the next warp is one step behind when the panel ends and makes the
//   next panel at once. Pair buffers alternate by panel; a front waits
//   until the warps below have left the panel two back before it reuses
//   its buffer.
// - The order of the operations on every entry is the plain version's:
//   L[r][c] sees vectors 0..kb−1 in order, w[r][i] sees columns in order,
//   each rotation on the values the plain version has at that point.
// - A failed downdate. The front computes pairs past a failure before it
//   sees it, so a panel in which any r² ≤ 0 appears is replayed: every
//   row that followed it restores its entry state (its block from L in
//   global memory, not yet written back, and its W entries from a scratch
//   copy made at the panel's entry) and the front warp redoes the panel in
//   the plain version's order (column by column, vector by vector),
//   stopping at the first failure (info = its column + 1); the rows below
//   then apply the live pairs. Pairs leave the CTA only when their panel
//   is final, with the live count of each column, so the CTAs below
//   freeze exactly; a frozen CTA makes no more pairs.
// - Each panel's pairs are published for the CTAs below (written, fenced,
//   then the CTA's progress counter raised, in panel order). L's column j
//   changes only at step j and a CTA needs the pairs of the columns left
//   of its last row only, so the CTAs form a forward pipeline in one
//   launch. A multi-CTA item is launched cooperatively: every CTA is
//   resident, so a spinning CTA cannot keep the CTA it waits on off the
//   card.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE square root and
// division are part of the contract).

#include <cuda_runtime.h>

#include "cx.cuh"
#include "pipeline.cuh"

namespace {

constexpr int kTw = 32;        // columns of a block and of a panel
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSmemMax = 232448;  // a CTA's shared memory (227 KB)
constexpr unsigned kFull = 0xffffffffu;
// a panel's state for the warps that follow it
constexpr int kRunning = 0, kClean = 1, kReplayed = 2, kFrozen = 3;

using cx::add_rn;
using cx::conj;
using cx::div_real_rn;
using cx::mul_rn;
using cx::sqrt_rn;
using cx::sub_rn;
using pipe::cp_async;
using pipe::cp_commit;
using pipe::cp_wait;
using pipe::fence_release_gpu;
using pipe::ld_acquire;
using pipe::ld_acquire_gpu;
using pipe::lds_row;
using pipe::st_release;

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

// pair (c, s) of the diagonal d and the vector entry x; false where a
// downdate fails (r² ≤ 0: the pair is then not to be used)
template <typename T>
__device__ __forceinline__ bool make_pair(T d, T x, bool dn, real_t<T>& c,
                                          T& s) {
  using R = real_t<T>;
  const R ljj = cx::real_part(d);
  const R ax2 = cx::abs2_rn(x);
  const R l2 = mul_rn(ljj, ljj);
  const R r2 = dn ? sub_rn(l2, ax2) : add_rn(l2, ax2);
  const R r = sqrt_rn(r2 < tiny_of<R>() ? tiny_of<R>() : r2);
  c = cx::div_rn(ljj, r);
  s = div_real_rn(x, r);
  return !(dn && r2 <= R(0));
}

// the blocks, two pair buffers (one per panel in flight, kTw + kb steps
// of kb pairs each, a step's pairs side by side), two panels' live counts
template <typename T>
size_t smem_bytes(int rows, int kb, int bufs) {
  return (size_t)bufs * rows * (kTw + 1) * sizeof(T) +
         (size_t)2 * (kTw + kb) * kb * (sizeof(T) + sizeof(real_t<T>)) +
         (size_t)2 * kTw * sizeof(int);
}

template <typename T, int KB>
__global__ void __launch_bounds__(kMaxThreads) chol_update_kernel(
    T* __restrict__ L, long long bsl, long long rsl, const T* __restrict__ W,
    long long bsw, int n, int down, int* __restrict__ info,
    real_t<T>* __restrict__ g_c, T* __restrict__ g_s,
    int* __restrict__ g_live, T* __restrict__ g_x, int* __restrict__ progress,
    int ctas, int rows, int bufs) {
  using R = real_t<T>;
  constexpr int kSlots = (kTw + KB) * KB;  // a pair buffer: step-major
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);                 // bufs × rows × 33
  T* s_s = tile + (size_t)bufs * rows * (kTw + 1);      // 2 × kSlots
  R* s_c = reinterpret_cast<R*>(s_s + 2 * kSlots);      // 2 × kSlots
  int* s_live = reinterpret_cast<int*>(s_c + 2 * kSlots);  // 2 × kTw
  // the panels' released steps (panel p: p·steps_max + t + 1, then
  // p·steps_max + steps_max when final) and each panel's state (by parity)
  __shared__ int s_front, s_status[2];
  __shared__ int s_frozen, s_pub, s_wdone[kMaxWarps];

  const int z = blockIdx.y, b = blockIdx.x, tid = threadIdx.x;
  const int nth = blockDim.x, warp = tid / 32, lane = tid % 32;
  T* Lz = L + (size_t)z * bsl;
  const T* Wz = W + (size_t)z * bsw;
  R* cz = g_c + (size_t)z * n * KB;
  T* sz = g_s + (size_t)z * n * KB;
  T* xz = g_x + (size_t)z * n * KB;
  int* livez = g_live + (size_t)z * n;
  int* prog = progress + (size_t)z * ctas;
  const int r0 = b * rows, r1 = min(n, r0 + rows);
  const int row = r0 + tid;
  const bool valid = row < r1;
  const int w0 = r0 + warp * 32;  // this warp's first row
  const bool dn = down != 0;
  const int steps_max = kTw + KB;  // step values a panel takes (≥ steps + 1)

  T x[KB];
#pragma unroll
  for (int i = 0; i < KB; ++i) x[i] = valid ? Wz[(size_t)row * KB + i] : T(0);
  if (tid == 0) {
    s_front = 0;
    s_frozen = 0;
    s_pub = 0;
  }
  if (tid < kMaxWarps) s_wdone[tid] = 0;

  // this warp's rows of L's columns [j0, j0 + 32) ↔ its block of buffer
  // tb (one row per instruction, the lanes along it)
  auto block = [&](int tb) {
    return tile + ((size_t)tb * rows + warp * 32) * (kTw + 1);
  };
  auto fetch_block = [&](int tb, int j0) {
    T* blk = block(tb);
    const int col = j0 + lane;
    if (col < n)
      for (int rr = 0; rr < 32 && w0 + rr < r1; ++rr)
        cp_async<sizeof(T)>(blk + rr * (kTw + 1) + lane,
                            Lz + (size_t)(w0 + rr) * rsl + col);
  };
  auto store_block = [&](int tb, int j0) {
    const T* blk = block(tb);
    const int col = j0 + lane;
    if (col < n)
      for (int rr = 0; rr < 32 && w0 + rr < r1; ++rr)
        if (col <= w0 + rr)
          Lz[(size_t)(w0 + rr) * rsl + col] = blk[rr * (kTw + 1) + lane];
  };
  auto reload_block = [&](int tb, int j0) {  // the entry state, on a replay
    T* blk = block(tb);
    const int col = j0 + lane;
    if (col < n)
      for (int rr = 0; rr < 32 && w0 + rr < r1; ++rr)
        blk[rr * (kTw + 1) + lane] = Lz[(size_t)(w0 + rr) * rsl + col];
  };
  auto tbuf = [&](int j0) { return bufs == 2 ? (j0 / kTw) & 1 : 0; };
  // the pairs of a panel in column order (pair (c, i) at slot
  // (c + i)·KB + i), the live ones only: a replay's and a frozen panel's
  // slow path
  auto apply_columns = [&](T* mine, int ncols, const R* pc, const T* ps,
                           const int* pl) {
    for (int cc = 0; cc < ncols; ++cc) {
      const int lv = pl[cc];
      T l = mine[cc];
#pragma unroll
      for (int i = 0; i < KB; ++i)
        if (i < lv)
          rotate(l, x[i], pc[(cc + i) * KB + i], ps[(cc + i) * KB + i], dn);
      mine[cc] = l;
    }
  };
  // One step t of a panel's wavefront on this thread's row: the pairs
  // (t − k, k) of the columns c = t − k in [0, w) left of ``lim``. A
  // step's pairs lie side by side. Where they fit (kb·itemsize ≤ 128
  // bytes) the step's pairs are read into registers at once, and the
  // row's entries of the KB columns a step touches stay in registers
  // (column t − k in win[k], shifted by one a step), each read from and
  // written to the block once (with steps = w + KB − 1 the last column in
  // range leaves the window at the last step); else each rotation reads
  // its pair and entry (a window would not fit the registers).
  constexpr bool kWindow = KB * sizeof(T) <= 128;
  auto shift_in = [&](T (&win)[KB], const T* mine, int t) {
    if constexpr (kWindow) {
#pragma unroll
      for (int k = KB - 1; k > 0; --k) win[k] = win[k - 1];
      win[0] = mine[t];  // past the row for t ≥ 32: never used
    }
  };
  auto apply_step = [&](T (&win)[KB], T* mine, int t, int w, int lim,
                        const R* pc, const T* ps) {
    if constexpr (kWindow) {
      R cv[KB];
      T sv[KB];
      lds_row(cv, pc + t * KB);
      lds_row(sv, ps + t * KB);
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int cc = t - k;
        if (cc >= 0 && cc < w && cc < lim)
          rotate(win[k], x[k], cv[k], sv[k], dn);
      }
      const int out = t - KB + 1;  // this column has had every vector
      if (out >= 0 && out < w) mine[out] = win[KB - 1];
    } else {
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int cc = t - k;
        if (cc >= 0 && cc < w && cc < lim) {
          T l = mine[cc];
          rotate(l, x[k], pc[t * KB + k], ps[t * KB + k], dn);
          mine[cc] = l;
        }
      }
    }
  };
  auto wait_front = [&](int need) {
    while (ld_acquire(&s_front) < need) {
    }
  };

  // 1. the columns of the CTAs above, as they publish them
  fetch_block(tbuf(0), 0);
  cp_commit();
  for (int j0 = 0; j0 < r0; j0 += kTw) {
    const int tb = tbuf(j0);
    if (bufs == 2) {  // the next block: a later tile or the first panel
      fetch_block(tb ^ 1, j0 + kTw);
      cp_commit();
    }
    const int src = j0 / rows, need = (j0 - src * rows) / kTw + 1;
    if (tid == 0) {
      while (ld_acquire_gpu(prog + src) < need) {
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kTw * KB; idx += nth) {
      const int slot = (idx / KB + idx % KB) * KB + idx % KB;
      s_c[slot] = cx::ldcg(cz + (size_t)j0 * KB + idx);
      s_s[slot] = cx::ldcg(sz + (size_t)j0 * KB + idx);
    }
    for (int idx = tid; idx < kTw; idx += nth) {
      const int lv = __ldcg(livez + j0 + idx);
      s_live[idx] = lv;
      if (lv < KB) s_frozen = 1;  // a failed downdate above: freeze
    }
    if (bufs == 2)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    T* mine = block(tb) + lane * (kTw + 1);
    if (valid) {
      if (s_frozen) {
        apply_columns(mine, kTw, s_c, s_s, s_live);
      } else {
        T win[KB];
        for (int t = 0; t < kTw + KB - 1; ++t) {
          shift_in(win, mine, t);
          apply_step(win, mine, t, kTw, kTw, s_c, s_s);
        }
      }
    }
    __syncwarp();
    store_block(tb, j0);
    if (bufs == 1) {
      __syncwarp();
      fetch_block(0, j0 + kTw);
      cp_commit();
    }
  }
  __syncthreads();
  if (w0 >= r1) return;  // a warp with no rows

  // 2. the diagonal block: panel p is warp p's rows and columns; a warp
  // follows the panels above its own, then makes its own
  struct Panel {
    int j0, w, tb, pb, base, steps;
    R* pc;
    T* ps;
    int* pl;
    T* mine;
  };
  auto panel = [&](int p) {
    Panel q;
    q.j0 = r0 + p * kTw;
    q.w = min(kTw, r1 - q.j0);
    q.tb = tbuf(q.j0);
    q.pb = p & 1;
    q.base = p * steps_max;
    q.steps = q.w + KB - 1;
    q.pc = s_c + q.pb * kSlots;
    q.ps = s_s + q.pb * kSlots;
    q.pl = s_live + q.pb * kTw;
    q.mine = block(q.tb) + lane * (kTw + 1);
    return q;
  };
  // this row's W entries at a panel's entry: a replay's restart
  auto save_x = [&]() {
    if (dn && valid)
#pragma unroll
      for (int i = 0; i < KB; ++i) xz[(size_t)row * KB + i] = x[i];
  };
  auto load_x = [&]() {
#pragma unroll
    for (int i = 0; i < KB; ++i) x[i] = xz[(size_t)row * KB + i];
  };
  // a followed panel that was replayed: this row back to its entry state,
  // then the replayed live pairs
  auto restore_followed = [&](Panel q) {
    __syncwarp();
    reload_block(q.tb, q.j0);
    __syncwarp();
    if (valid) {
      load_x();
      apply_columns(q.mine, q.w, q.pc, q.ps, q.pl);
    }
  };
  auto follow = [&](Panel q) {
    wait_front(q.base + 1);
    if (ld_acquire(&s_status[q.pb]) == kFrozen) return;
    if (valid) {
      T win[KB];
      for (int t = 0; t < q.steps; ++t) {
        shift_in(win, q.mine, t);
        wait_front(q.base + t + 1);
        apply_step(win, q.mine, t, q.w, kTw, q.pc, q.ps);
      }
    }
    wait_front(q.base + steps_max);
    if (ld_acquire(&s_status[q.pb]) == kReplayed) restore_followed(q);
  };
  // the front: until the warps below have left panel p − 2, whose pair
  // buffer this one reuses; then kRunning, or kFrozen (no pairs)
  auto front_begin = [&](int p, Panel q) {
    for (int v = warp + 1; v < kMaxWarps && r0 + v * 32 < r1; ++v)
      while (ld_acquire(&s_wdone[v]) < p - 1) {
      }
    const bool frozen = ld_acquire(&s_frozen) != 0;
    if (lane == 0) st_release(&s_status[q.pb], frozen ? kFrozen : kRunning);
    if (frozen) q.pl[lane] = 0;
    return frozen;
  };
  // front step t: lane l makes pair (l, t − l) and rotates its diagonal
  auto make_pairs = [&](Panel q, int t, T& d, bool& bad) {
    const int i = t - lane;
    if (lane < q.w && i >= 0 && i < KB) {
      T xi = x[0];
#pragma unroll
      for (int k = 1; k < KB; ++k)
        if (i == k) xi = x[k];
      R c;
      T s;
      bad |= !make_pair(d, xi, dn, c, s);
      rotate(d, xi, c, s, dn);
      q.pc[t * KB + i] = c;
      q.ps[t * KB + i] = s;
    }
    __syncwarp();
    if (lane == 0) st_release(&s_front, q.base + t + 1);
  };
  // after the front's steps: the panel replayed in the plain version's
  // order from its entry state if any pair failed, else every pair live
  auto front_end = [&](Panel q, T& d, bool bad) {
    const bool any_bad = __any_sync(kFull, bad);
    if (any_bad) {
      __syncwarp();
      reload_block(q.tb, q.j0);
      __syncwarp();
      if (lane < q.w) {
        load_x();
        d = q.mine[lane];
      }
      bool live = true;
      for (int cc = 0; cc < q.w; ++cc) {
        int lv = 0;
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          int ok = 1;
          if (lane == cc && live) {
            R c;
            T s;
            ok = make_pair(d, x[i], dn, c, s);
            if (ok) {
              T xi = x[i];
              rotate(d, xi, c, s, dn);
              q.pc[(cc + i) * KB + i] = c;
              q.ps[(cc + i) * KB + i] = s;
            }
          }
          ok = __shfl_sync(kFull, ok, cc);
          if (live && !ok) {
            if (lane == cc) info[z] = q.j0 + cc + 1;
            live = false;
          }
          __syncwarp();
          if (live) {
            if (lane > cc && lane < q.w) {
              T l = q.mine[cc];
              rotate(l, x[i], q.pc[(cc + i) * KB + i],
                     q.ps[(cc + i) * KB + i], dn);
              q.mine[cc] = l;
            }
            lv = i + 1;
          }
        }
        if (lane == 0) q.pl[cc] = lv;
      }
      if (!live && lane == 0) st_release(&s_frozen, 1);
    } else if (lane < q.w) {
      q.pl[lane] = KB;
    }
    if (lane < q.w) q.mine[lane] = d;
    if (lane == 0) st_release(&s_status[q.pb], any_bad ? kReplayed : kClean);
  };
  // the panel final for the warps below, then published for the CTAs below
  // (in panel order)
  auto front_publish = [&](int p, Panel q) {
    __syncwarp();
    if (lane == 0) st_release(&s_front, q.base + steps_max);
    if (ctas > 1) {
      while (ld_acquire(&s_pub) < p) {
      }
      for (int idx = lane; idx < q.w * KB; idx += 32) {
        const int slot = (idx / KB + idx % KB) * KB + idx % KB;
        cz[(size_t)q.j0 * KB + idx] = q.pc[slot];
        sz[(size_t)q.j0 * KB + idx] = q.ps[slot];
      }
      if (lane < q.w) livez[q.j0 + lane] = q.pl[lane];
      fence_release_gpu();
      __syncwarp();
      if (lane == 0) {
        atomicExch(prog + b, p + 1);
        st_release(&s_pub, p + 1);
      }
    }
  };
  for (int p = 0; p <= warp; ++p) {
    const Panel q = panel(p);
    if (bufs == 2 && p < warp) {  // this warp's block of the next panel
      fetch_block(q.tb ^ 1, q.j0 + kTw);
      cp_commit();
      cp_wait<1>();
    } else {
      if (bufs == 1 && p > 0) {  // one buffer: this panel's block now
        fetch_block(0, q.j0);
        cp_commit();
      }
      cp_wait<0>();
    }
    __syncwarp();
    save_x();
    if (p < warp) {
      follow(q);
    } else {
      if (!front_begin(p, q)) {
        T d = q.mine[lane];  // this lane's diagonal entry (lane < w)
        bool bad = false;
        T win[KB];
        for (int t = 0; t < q.steps; ++t) {
          shift_in(win, q.mine, t);
          make_pairs(q, t, d, bad);
          apply_step(win, q.mine, t, q.w, lane, q.pc, q.ps);
        }
        front_end(q, d, bad);
      }
      front_publish(p, q);
    }
    __syncwarp();
    store_block(q.tb, q.j0);
    __syncwarp();
    if (lane == 0) st_release(&s_wdone[warp], p + 1);
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
        int n, int down, int B, int ctas, int rows, int bufs, void* info,
        void* g_c, void* g_s, void* g_live, void* g_x, void* progress,
        void* stream) {
  const size_t smem = smem_bytes<T>(rows, KB, bufs);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  T* L = static_cast<T*>(l);
  const T* W = static_cast<const T*>(w);
  int* inf = static_cast<int*>(info);
  real_t<T>* gc = static_cast<real_t<T>*>(g_c);
  T* gs = static_cast<T*>(g_s);
  int* gl = static_cast<int*>(g_live);
  T* gx = static_cast<T*>(g_x);
  int* pr = static_cast<int*>(progress);
  void* args[] = {&L, &bsl, &rsl, &W, &bsw, &n, &down, &inf, &gc, &gs, &gl,
                  &gx, &pr, &ctas, &rows, &bufs};
  return launch(chol_update_kernel<T, KB>, dim3(ctas, B), rows, smem, args,
                stream);
}

template <typename T>
int chol_update(void* l, long long bsl, long long rsl, const void* w,
                long long bsw, int n, int kb, int down, int B, int ctas,
                int rows, int bufs, void* info, void* g_c, void* g_s,
                void* g_live, void* g_x, void* progress, void* stream) {
  if (n < 1 || B < 1 || ctas < 1 || rows < 32 || rows > kMaxThreads ||
      rows % kTw != 0 || (long long)(ctas - 1) * rows >= n ||
      (long long)ctas * rows < n || (bufs != 1 && bufs != 2))
    return (int)cudaErrorInvalidValue;
  switch (kb) {
    case 1: return run<T, 1>(l, bsl, rsl, w, bsw, n, down, B, ctas, rows,
                             bufs, info, g_c, g_s, g_live, g_x, progress,
                             stream);
    case 2: return run<T, 2>(l, bsl, rsl, w, bsw, n, down, B, ctas, rows,
                             bufs, info, g_c, g_s, g_live, g_x, progress,
                             stream);
    case 4: return run<T, 4>(l, bsl, rsl, w, bsw, n, down, B, ctas, rows,
                             bufs, info, g_c, g_s, g_live, g_x, progress,
                             stream);
    case 8: return run<T, 8>(l, bsl, rsl, w, bsw, n, down, B, ctas, rows,
                             bufs, info, g_c, g_s, g_live, g_x, progress,
                             stream);
    case 16: return run<T, 16>(l, bsl, rsl, w, bsw, n, down, B, ctas, rows,
                               bufs, info, g_c, g_s, g_live, g_x, progress,
                               stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

#define SLATE_CHOL_UPDATE(SFX, T)                                            \
  int slate_chol_update_##SFX(void* l, long long bsl, long long rsl,         \
                              const void* w, long long bsw, int n, int kb,   \
                              int down, int B, int ctas, int rows, int bufs, \
                              void* info, void* g_c, void* g_s,              \
                              void* g_live, void* g_x, void* progress,       \
                              void* stream) {                                \
    return chol_update<T>(l, bsl, rsl, w, bsw, n, kb, down, B, ctas, rows,   \
                          bufs, info, g_c, g_s, g_live, g_x, progress,       \
                          stream);                                           \
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
