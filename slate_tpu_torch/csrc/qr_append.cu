// P7 and P8: QR row append in float32, float64, complex64 and complex128.
//
// P7 (qr_append_build): the structured QR of [R; U], in place on the
// upper-triangular R (npad × npad), U the (P × npad) appended rows, P one
// of 1, 2, 4, 8, 16. Per column j < n,
//     alpha = R[j][j],  x = U[:, j],  ‖x‖² = Σ_p |x_p|²  (p increasing),
//     phase = alpha/|alpha| (1 for alpha = 0),
//     beta = −phase·sqrt(|alpha|² + ‖x‖²),
//     tau_j = (beta − alpha)/beta,  w_j = x/(alpha − beta)
//     (‖x‖² = 0: tau_j = 0, w_j = 0, the diagonal keeps alpha),
//     then for every column c > j, with v = [1; w_j]:
//       vy = R[j][c] + Σ_p conj(w_j[p])·U[p][c]   (p increasing, added last),
//       R[j][c] −= tau_j·vy,  U[p][c] −= tau_j·(w_j[p]·vy),
//     R[j][j] = beta and U[:, j] = 0.
// That is the reference's convention (beta complex in complex types), not
// K3's larfg. Outputs w (P × npad) and tau (npad), zero beyond column n.
//
// P8 (qr_append_apply): applies those n reflectors to [ct; d], in place on
// ct (npad × q); d (P × q) is the appended rows' right-hand sides. Per
// column j < n and right-hand-side column c, the same reflection of
// (ct[j][c], d[:, c]).
//
// No Pallas kernels: they replace the reference's lax.scans in
// slate_tpu/linalg/update.py, qr_append_build (:189-241) and the forward
// sweep of appended_gels (:275-286), with the contracts of the plain
// versions hopper_ops.qr_append_build_plain and qr_append_apply_plain:
// every product, sum and quotient rounded apart (complex products part by
// part, complex quotients by Smith's form with the divisor made once,
// csrc/cx.cuh), sums over the appended rows in increasing order, so a zero
// appended row adds exact zeros at the end of each sum and changes no bit.
//
// What bounds them. P7 reads and writes R's upper triangle once and does
// about 2·n²·P multiply-adds; P8 reads ct once and does about 4·n·q·P.
// Both are far below the card's rates in the time they take, which is the
// chain of n dependent steps (P7: a reduction over P, a square root and
// two divisions, then one division of the tail and a reflection of the
// next column; P8: the reflection of one column, below).
//
// Design of P7. The update of column c at step j needs only (w_j, tau_j),
// R's row j and U's column c, so one thread owns one column, with U's
// column in registers, and 128 columns make a CTA (four warps of 32).
// - No step writes R's row j before step j, so alpha = R[j][j] and the
//   row's entries are the input's: each thread stages its entries of R's
//   rows 32 at a time into shared memory by cp.async, double-buffered
//   (one buffer where two would not keep every CTA of a cooperative
//   launch resident), the next 32 rows fetched while the current ones are
//   worked, and writes them back once; no global load sits on a step.
// - CTA b first applies the reflectors the CTAs left of it publish (in
//   the outputs w and tau, 32 steps at a time, behind their progress
//   counters), every thread its own column;
// - then its own steps, 32 per warp: warp q's columns are the steps of
//   chunk q, and that warp is the front. At step j its lane s makes the
//   scalars (‖x‖², alpha's phase, beta, tau) from alpha and its column of
//   U, lane p divides the tail's entry p (one divisor for all), and every
//   lane right of j reflects its column, so the owner of column j + 1 has
//   its column one reflection later; the warp is synchronised by
//   __syncwarp alone. Each step's reflector goes to shared memory and is
//   released through a step counter there to the warps to the right,
//   which follow step by step; a chunk's reflector buffer is reused two
//   chunks later, after the warps to the right have left it.
// - A chunk's reflectors are published for the CTAs right of it (fenced,
//   then the progress counter raised, in chunk order). A multi-CTA call is
//   one cooperative launch, so a spinning CTA cannot keep the one it
//   waits on off the card.
// The order of operations on every entry is the plain version's (each
// column reflected by steps 0, 1, … in turn), so the results are bit for
// bit its results.
//
// What bounds P8. Column c of [ct; d] is reflected by steps 0, 1, …, n − 1
// in turn, and step j needs the d that step j − 1 left: vy = ct[j][c] +
// Σ_p conj(w_j[p])·d[p] (p increasing, each product and sum rounded
// apart), then d[p] −= tau_j·(w_j[p]·vy). So each step is a dependent
// chain of P + 4 operations in real types (the first product, P − 1
// adds, the add of ct's entry, then w_j[p]·vy, tau_j·(…) and the
// subtraction that the next step's first product waits on) and P + 7 in
// complex types (a product part by part is two deep). Nothing else is on
// it: w_j, tau_j and ct's row j depend on nothing the sweep computes.
//
// Design of P8. The columns are independent, so no CTA waits on another;
// kApplyThreads threads a CTA work on columns, each with its share of d in
// registers, and the time is the column's chain of n steps. A warp issues
// a step's P + 4 chain operations and its 4P + 2 other rounded operations
// in order, and on the card that costs about twice the chain (tools/
// p67_ablation.py, no_loads). So a column takes two lanes where P is 16,
// or 8 in complex types (apply_lanes): each lane holds P/2 entries of d
// and does half of the products and updates; lane 0 of the pair sums its
// half, lane 1 continues from that partial (one shuffle) and hands vy back
// (another), so the sum runs over p in increasing order as one lane's
// would. Below that a column keeps one lane (the two shuffles would cost
// more than the halved issue saves).
// - The reflectors and ct's rows depend on nothing the sweep computes, so
//   they are staged kApplyBufs − 1 chunks of kApplyStep steps ahead by
//   cp.async, every thread a share: w's columns transposed so a step's P
//   entries lie side by side (P·itemsize / 16 broadcast 16-byte reads),
//   their tau, and ct's rows across the CTA's columns, 16 bytes a copy
//   where the rows are 16-byte aligned (zero-filled past q). Two barriers
//   a chunk hand a buffer over.
// - A thread reads step s + 1's operands from shared memory while step s
//   runs, and stores ct's finished entry with a plain store nothing waits
//   on; the step loop is unrolled by 4 (2 in complex types).
// The order of operations on every entry is the plain version's, so the
// results are bit for bit its results.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE square root and
// division are part of the contract).

#include <cuda_runtime.h>

#include <cstdint>

#include "cx.cuh"
#include "pipeline.cuh"

namespace {

constexpr int kCols = 128;   // P7: columns (threads) per CTA
constexpr int kStep = 32;    // P7: steps published and consumed at a time
constexpr int kApplyThreads = 128;  // P8: threads per CTA on the columns
constexpr int kApplyStep = 32;      // P8: steps staged at a time
constexpr int kApplyBufs = 3;       // P8: chunks in flight (staged ahead)
constexpr int kApplySplitP = 16;    // P8: the least P (P/2 complex) split
//                                     over two lanes
static_assert(kApplyThreads % 32 == 0 && kApplyThreads >= kApplyStep,
              "P8 stages a chunk's tau one per thread");

// P8's lanes per right-hand-side column at P appended rows
template <typename T>
__host__ __device__ constexpr int apply_lanes(int P) {
  return P * (sizeof(T) == sizeof(real_t<T>) ? 1 : 2) >= kApplySplitP ? 2
                                                                      : 1;
}

using cx::add_rn;
using cx::conj;
using cx::mul_rn;
using cx::sub_rn;
using pipe::cp_async;
using pipe::cp_async16_zfill;
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
template <typename R> __device__ __forceinline__ R neg(R a) { return -a; }
template <typename R> __device__ __forceinline__ Cx<R> neg(Cx<R> a) {
  return {-a.re, -a.im};
}

// (top, mat[:, c]) ← (I − tau·v·vᴴ)·(top, mat[:, c]) for v = [1; w]
template <typename T, int P>
__device__ __forceinline__ void reflect(T& top, T (&col)[P], const T* w,
                                        T tau) {
  T acc = mul_rn(conj(w[0]), col[0]);
#pragma unroll
  for (int p = 1; p < P; ++p) acc = add_rn(acc, mul_rn(conj(w[p]), col[p]));
  const T vy = add_rn(top, acc);
  top = sub_rn(top, mul_rn(tau, vy));
#pragma unroll
  for (int p = 0; p < P; ++p)
    col[p] = sub_rn(col[p], mul_rn(tau, mul_rn(w[p], vy)));
}

// P8's shared memory: kApplyBufs buffers of a chunk's w (P a step), tau
// and ct slots (one per column of the CTA)
template <typename T>
size_t apply_smem_bytes(int P) {
  return (size_t)kApplyBufs * kApplyStep *
         (P + 1 + kApplyThreads / apply_lanes<T>(P)) * sizeof(T);
}

template <typename T>
size_t build_smem_bytes(int P, int bufs) {
  return ((size_t)bufs * kStep * kCols + 2 * kStep * P + 2 * kStep) *
         sizeof(T);
}

// reflect with the reflector's tail in shared memory, read in one row
template <typename T, int P>
__device__ __forceinline__ void reflect_staged(T& top, T (&col)[P],
                                               const T* w, T tau) {
  T wv[P];
  lds_row(wv, w);
  reflect<T, P>(top, col, wv, tau);
}

template <typename T, int P>
__global__ void __launch_bounds__(kCols) qr_append_build_kernel(
    T* __restrict__ R, long long rsr, const T* __restrict__ U,
    T* __restrict__ Wout, T* __restrict__ tau, int n, int npad,
    int* __restrict__ progress, int ctas, int bufs) {
  using Re = real_t<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);        // bufs × kStep × kCols
  T* s_w = stage + (size_t)bufs * kStep * kCols;  // 2 × kStep × P
  T* s_tau = s_w + 2 * kStep * P;                 // 2 × kStep
  __shared__ int s_front, s_pub, s_wdone[kCols / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c0 = b * kCols, c1 = min(npad, c0 + kCols);
  const int col = c0 + tid;
  const bool valid = col < c1;
  T u[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    u[p] = valid ? U[(size_t)p * npad + col] : T(0);
  if (tid == 0) {
    s_front = 0;
    s_pub = 0;
  }
  if (tid < kCols / 32) s_wdone[tid] = 0;

  // this thread's entries of R's rows [j0, j0 + cnt) (the rows at or
  // above its diagonal: the only ones a step changes in its column) ↔ its
  // column of buffer tb; no other thread reads them
  auto rows_of = [&](int tb) { return stage + (size_t)tb * kStep * kCols; };
  auto fetch_rows = [&](int tb, int j0, int cnt) {
    T* st = rows_of(tb) + tid;
    if (valid)
      for (int s = 0; s < cnt && j0 + s <= col; ++s)
        cp_async<sizeof(T)>(st + s * kCols, R + (size_t)(j0 + s) * rsr + col);
  };
  auto store_rows = [&](int tb, int j0, int cnt) {
    const T* st = rows_of(tb) + tid;
    if (valid)
      for (int s = 0; s < cnt && j0 + s <= col; ++s)
        R[(size_t)(j0 + s) * rsr + col] = st[s * kCols];
  };
  auto tbuf = [&](int j0) { return bufs == 2 ? (j0 / kStep) & 1 : 0; };

  // 1. the steps of the CTAs left of this one, as they publish them
  const int e1 = min(c0, n);
  if (n > 0) fetch_rows(tbuf(0), 0, min(kStep, n));
  cp_commit();
  for (int j0 = 0; j0 < e1; j0 += kStep) {
    const int cnt = min(kStep, e1 - j0), tb = tbuf(j0);
    const int nxt = j0 + kStep, ncnt = min(kStep, n - nxt);
    if (bufs == 2) {  // the next rows: a later chunk or the first own one
      if (ncnt > 0) fetch_rows(tb ^ 1, nxt, ncnt);
      cp_commit();
    }
    const int src = j0 / kCols, need = (j0 - src * kCols) / kStep + 1;
    if (tid == 0) {
      while (ld_acquire_gpu(progress + src) < need) {
      }
    }
    __syncthreads();
    for (int idx = tid; idx < cnt * P; idx += kCols) {
      const int s = idx / P, p = idx % P;
      s_w[s * P + p] = cx::ldcg(Wout + (size_t)p * npad + j0 + s);
    }
    for (int s = tid; s < cnt; s += kCols) s_tau[s] = cx::ldcg(tau + j0 + s);
    if (bufs == 2)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    if (valid) {
      T* st = rows_of(tb) + tid;
      for (int s = 0; s < cnt; ++s) {
        T top = st[s * kCols];
        reflect_staged<T, P>(top, u, s_w + s * P, s_tau[s]);
        st[s * kCols] = top;
      }
    }
    store_rows(tb, j0, cnt);
    if (bufs == 1) {
      if (ncnt > 0) fetch_rows(0, nxt, ncnt);
      cp_commit();
    }
  }
  __syncthreads();
  if (c0 + warp * 32 >= c1) return;  // a warp with no columns

  // 2. this CTA's own steps: chunk q is warp q's 32 columns
  for (int q = 0; q <= warp; ++q) {
    const int j0 = c0 + q * kStep;
    if (j0 >= n) break;
    const int cnt = min(kStep, n - j0), tb = tbuf(j0), pb = q & 1;
    const int base = q * (kStep + 1);
    T* pw = s_w + pb * kStep * P;
    T* pt = s_tau + pb * kStep;
    T* st = rows_of(tb) + tid;
    const int nxt = j0 + kStep, ncnt = min(kStep, n - nxt);
    if (bufs == 2 && q < warp) {  // this thread's rows of the next chunk
      if (ncnt > 0) fetch_rows(tb ^ 1, nxt, ncnt);
      cp_commit();
      cp_wait<1>();
    } else {
      if (bufs == 1 && q > 0) {
        fetch_rows(0, j0, cnt);
        cp_commit();
      }
      cp_wait<0>();
    }
    if (q < warp) {
      // -- follow the front of chunk q, step by step
      for (int s = 0; s < cnt; ++s) {
        const int need = base + s + 1;
        while (ld_acquire(&s_front) < need) {
        }
        if (valid) {
          T top = st[s * kCols];
          reflect_staged<T, P>(top, u, pw + s * P, pt[s]);
          st[s * kCols] = top;
        }
      }
    } else {
      // -- the front: wait until the warps to the right have left chunk
      // q − 2, whose reflector buffer this one reuses
      for (int v = warp + 1; v < kCols / 32 && c0 + v * 32 < c1; ++v)
        while (ld_acquire(&s_wdone[v]) < q - 1) {
        }
      for (int s = 0; s < cnt; ++s) {
        const int j = j0 + s;
        // lane s: the reflector's scalars from alpha = R[j][j] (staged)
        // and its column of U
        T alpha = T(0), beta = T(0);
        int inert = 1;
        if (lane == s) {
          alpha = st[s * kCols];
          Re xn2 = cx::abs2_rn(u[0]);
#pragma unroll
          for (int p = 1; p < P; ++p) xn2 = add_rn(xn2, cx::abs2_rn(u[p]));
          const Re an = cx::modulus(alpha);
          const T phase = an > Re(0) ? cx::div_real_rn(alpha, an) : T(1);
          beta = scale_rn(neg(phase), cx::sqrt_rn(add_rn(mul_rn(an, an),
                                                         xn2)));
          inert = xn2 == Re(0);
          const T tj = inert ? T(0) : cx::div(sub_rn(beta, alpha), beta);
          pt[s] = tj;
          st[s * kCols] = inert ? alpha : beta;
        }
        alpha = cx::shfl(alpha, s);
        beta = cx::shfl(beta, s);
        inert = __shfl_sync(0xffffffffu, inert, s);
        // the tail w_j = U[:, j]/(alpha − beta): lane p divides entry p
        const auto dv = cx::make_divisor(inert ? T(1) : sub_rn(alpha, beta));
        T up = T(0);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const T v = cx::shfl(u[p], s);
          if (lane == p) up = v;
        }
        if (lane < P) pw[s * P + lane] = inert ? T(0) : cx::divide(up, dv);
        if (lane == s)
#pragma unroll
          for (int p = 0; p < P; ++p) u[p] = T(0);
        __syncwarp();
        if (lane == 0) st_release(&s_front, base + s + 1);
        if (valid && lane > s) {
          T top = st[s * kCols];
          reflect_staged<T, P>(top, u, pw + s * P, pt[s]);
          st[s * kCols] = top;
        }
      }
      // the chunk's reflectors to the outputs, then (several CTAs) the
      // chunk published for the CTAs right, in order
      for (int idx = lane; idx < cnt * P; idx += 32)
        Wout[(size_t)(idx % P) * npad + j0 + idx / P] = pw[idx];
      if (lane < cnt) tau[j0 + lane] = pt[lane];
      if (ctas > 1) {
        while (ld_acquire(&s_pub) < q) {
        }
        fence_release_gpu();
        __syncwarp();
        if (lane == 0) {
          atomicExch(progress + b, q + 1);
          st_release(&s_pub, q + 1);
        }
      }
    }
    store_rows(tb, j0, cnt);
    __syncwarp();
    if (lane == 0) st_release(&s_wdone[warp], q + 1);
  }
}

// One step of P8 on one lane of a column: its H entries of d (and of w_j),
// H = P / L. With L = 2, lane 0 of the pair sums its half of the products
// and lane 1 continues from lane 0's partial, so the sum runs over p in
// increasing order, as one lane's would; lane 1 adds ct's entry and hands
// vy back. Returns ct's new entry (lane 1's).
template <typename T, int H, int L>
__device__ __forceinline__ T apply_step(T top, T (&d)[H], const T (&w)[H],
                                        T tj) {
  if constexpr (L == 1) {
    reflect<T, H>(top, d, w, tj);
    return top;
  } else {
    T prod[H];
#pragma unroll
    for (int h = 0; h < H; ++h) prod[h] = mul_rn(conj(w[h]), d[h]);
    T acc = prod[0];
#pragma unroll
    for (int h = 1; h < H; ++h) acc = add_rn(acc, prod[h]);
    acc = cx::shfl_xor(acc, 1);  // lane 1 ← lane 0's partial
#pragma unroll
    for (int h = 0; h < H; ++h) acc = add_rn(acc, prod[h]);
    const T vy = cx::shfl(add_rn(top, acc), (threadIdx.x & 31) | 1);
    top = sub_rn(top, mul_rn(tj, vy));
#pragma unroll
    for (int h = 0; h < H; ++h)
      d[h] = sub_rn(d[h], mul_rn(tj, mul_rn(w[h], vy)));
    return top;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kApplyThreads) qr_append_apply_kernel(
    T* __restrict__ C, long long rsc, const T* __restrict__ D,
    const T* __restrict__ W, const T* __restrict__ tau, int n, int npad,
    int q) {
  constexpr int L = apply_lanes<T>(P), H = P / L;
  constexpr int kColsCta = kApplyThreads / L;  // a CTA's columns
  // the step loop's unrolling (measured: 4 in real types, 2 in complex)
  constexpr int kUnroll = sizeof(T) == sizeof(real_t<T>) ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int B = kApplyBufs;
  T* s_w = reinterpret_cast<T*>(smem);   // B × kApplyStep × P, [buf][s][p]
  T* s_tau = s_w + B * kApplyStep * P;   // B × kApplyStep
  T* s_top = s_tau + B * kApplyStep;     // B × kApplyStep × kColsCta
  const int tid = threadIdx.x, half = tid % L, cl = tid / L;
  const int col = blockIdx.x * kColsCta + cl;
  static_assert(kColsCta * sizeof(T) % 16 == 0, "P8 stages whole 16 bytes");
  const bool valid = col < q, owner = valid && half == L - 1;
  T d[H];
#pragma unroll
  for (int h = 0; h < H; ++h)
    d[h] = valid ? D[(size_t)(half * H + h) * q + col] : T(0);

  // ct's rows as 16-byte copies where they are 16-byte aligned (then a
  // CTA's columns are: kColsCta·itemsize is a multiple of 16)
  constexpr int V = 16 / sizeof(T);
  const int c0 = blockIdx.x * kColsCta;
  const bool vec = reinterpret_cast<uintptr_t>(C) % 16 == 0 &&
                   rsc * (long long)sizeof(T) % 16 == 0;

  // steps [j0, j0 + cnt) into buffer buf, every thread a share: w's
  // columns transposed (a step's P entries side by side), their tau, and
  // ct's rows across the CTA's columns (zero past q)
  auto stage = [&](int buf, int j0, int cnt) {
    T* sw = s_w + buf * kApplyStep * P;
    for (int idx = tid; idx < kApplyStep * P; idx += kApplyThreads) {
      const int s = idx % kApplyStep, p = idx / kApplyStep;
      if (s < cnt)
        cp_async<sizeof(T)>(sw + s * P + p, W + (size_t)p * npad + j0 + s);
    }
    if (tid < cnt)
      cp_async<sizeof(T)>(s_tau + buf * kApplyStep + tid, tau + j0 + tid);
    T* st = s_top + (size_t)buf * kApplyStep * kColsCta;
    const T* src = C + (size_t)j0 * rsc + c0;
    if (vec) {
      for (int idx = tid; idx < cnt * (kColsCta / V);
           idx += kApplyThreads) {
        const int s = idx / (kColsCta / V), c = idx % (kColsCta / V) * V;
        const int live = max(0, min(V, q - c0 - c));
        cp_async16_zfill(st + s * kColsCta + c,
                         live ? src + (size_t)s * rsc + c : C,
                         live * (int)sizeof(T));
      }
    } else {
      for (int idx = tid; idx < cnt * kColsCta; idx += kApplyThreads) {
        const int s = idx / kColsCta, c = idx % kColsCta;
        if (c0 + c < q)
          cp_async<sizeof(T)>(st + s * kColsCta + c,
                              src + (size_t)s * rsc + c);
      }
    }
  };

  // chunk i in buffer i % B, staged B − 1 chunks ahead (one commit group
  // a chunk, empty past n)
  for (int i = 0; i < B - 1; ++i) {
    if (i * kApplyStep < n)
      stage(i, i * kApplyStep, min(kApplyStep, n - i * kApplyStep));
    cp_commit();
  }
  for (int j0 = 0, buf = 0; j0 < n; j0 += kApplyStep, buf = (buf + 1) % B) {
    const int cnt = min(kApplyStep, n - j0);
    const int ahead = j0 + (B - 1) * kApplyStep;
    if (ahead < n)
      stage((buf + B - 1) % B, ahead, min(kApplyStep, n - ahead));
    cp_commit();
    cp_wait<B - 1>();
    __syncthreads();  // chunk j0 has landed
    const T* ws = s_w + buf * kApplyStep * P + half * H;
    const T* ts = s_tau + buf * kApplyStep;
    const T* tops = s_top + (size_t)buf * kApplyStep * kColsCta + cl;
    // step s's operands, read from shared memory one step ahead
    T wv[H], tj, top;
    auto operands = [&](int s, T (&w_)[H], T& t_, T& top_) {
      lds_row(w_, ws + s * P);
      t_ = ts[s];
      top_ = tops[s * kColsCta];
    };
    operands(0, wv, tj, top);
    T* out = C + (size_t)j0 * rsc + col;
#pragma unroll(kUnroll)
    for (int s = 0; s < cnt; ++s, out += rsc) {
      T wn[H], tn, topn;
      operands(s + 1 < cnt ? s + 1 : s, wn, tn, topn);
      top = apply_step<T, H, L>(top, d, wv, tj);
      if (owner) *out = top;
#pragma unroll
      for (int h = 0; h < H; ++h) wv[h] = wn[h];
      tj = tn;
      top = topn;
    }
    __syncthreads();  // buffer buf is staged again at the next chunk
  }
}

int finish(cudaError_t e) {
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int P>
int build(void* r, long long rsr, const void* u, void* w, void* tau, int n,
          int npad, int ctas, void* progress, void* stream) {
  auto kernel = qr_append_build_kernel<T, P>;
  T* R = static_cast<T*>(r);
  const T* U = static_cast<const T*>(u);
  T* W = static_cast<T*>(w);
  T* tw = static_cast<T*>(tau);
  int* pr = static_cast<int*>(progress);
  int bufs = 2;
  void* args[] = {&R, &rsr, &U, &W, &tw, &n, &npad, &pr, &ctas, &bufs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)build_smem_bytes<T>(P, 2));
  if (e != cudaSuccess) return (int)e;
  if (ctas == 1)
    return finish(cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                                   dim3(1), dim3(kCols), args,
                                   build_smem_bytes<T>(P, bufs), st));
  int dev = 0, coop = 0, n_sm = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // every CTA resident: one staging buffer where two would not let them be
  for (; bufs >= 1; --bufs) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kCols, build_smem_bytes<T>(P, bufs));
    if (e != cudaSuccess) return (int)e;
    if ((long long)ctas <= (long long)per_sm * n_sm) break;
  }
  if (bufs < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return finish(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(ctas), dim3(kCols), args,
      build_smem_bytes<T>(P, bufs), st));
}

template <typename T>
int append_build(void* r, long long rsr, const void* u, void* w, void* tau,
                 int n, int npad, int P, int ctas, void* progress,
                 void* stream) {
  if (n < 0 || n > npad || ctas != (npad + kCols - 1) / kCols || ctas < 1)
    return (int)cudaErrorInvalidValue;
  switch (P) {
    case 1: return build<T, 1>(r, rsr, u, w, tau, n, npad, ctas, progress, stream);
    case 2: return build<T, 2>(r, rsr, u, w, tau, n, npad, ctas, progress, stream);
    case 4: return build<T, 4>(r, rsr, u, w, tau, n, npad, ctas, progress, stream);
    case 8: return build<T, 8>(r, rsr, u, w, tau, n, npad, ctas, progress, stream);
    case 16: return build<T, 16>(r, rsr, u, w, tau, n, npad, ctas, progress, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int P>
int apply(void* c, long long rsc, const void* d, const void* w,
          const void* tau, int n, int npad, int q, void* stream) {
  auto kernel = qr_append_apply_kernel<T, P>;
  const size_t smem = apply_smem_bytes<T>(P);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int per_cta = kApplyThreads / apply_lanes<T>(P);
  kernel<<<(q + per_cta - 1) / per_cta, kApplyThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(c), rsc, static_cast<const T*>(d),
      static_cast<const T*>(w), static_cast<const T*>(tau), n, npad, q);
  return (int)cudaGetLastError();
}

template <typename T>
int append_apply(void* c, long long rsc, const void* d, const void* w,
                 const void* tau, int n, int npad, int q, int P,
                 void* stream) {
  if (n < 0 || n > npad || q < 1) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 1: return apply<T, 1>(c, rsc, d, w, tau, n, npad, q, stream);
    case 2: return apply<T, 2>(c, rsc, d, w, tau, n, npad, q, stream);
    case 4: return apply<T, 4>(c, rsc, d, w, tau, n, npad, q, stream);
    case 8: return apply<T, 8>(c, rsc, d, w, tau, n, npad, q, stream);
    case 16: return apply<T, 16>(c, rsc, d, w, tau, n, npad, q, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

#define SLATE_QR_APPEND(SFX, T)                                               \
  int slate_qr_append_build_##SFX(void* r, long long rsr, const void* u,      \
                                  void* w, void* tau, int n, int npad, int P, \
                                  int ctas, void* progress, void* stream) {   \
    return append_build<T>(r, rsr, u, w, tau, n, npad, P, ctas, progress,     \
                           stream);                                           \
  }                                                                           \
  int slate_qr_append_apply_##SFX(void* c, long long rsc, const void* d,      \
                                  const void* w, const void* tau, int n,      \
                                  int npad, int q, int P, void* stream) {     \
    return append_apply<T>(c, rsc, d, w, tau, n, npad, q, P, stream);         \
  }

SLATE_QR_APPEND(f32, float)
SLATE_QR_APPEND(f64, double)
SLATE_QR_APPEND(c64, Cx<float>)
SLATE_QR_APPEND(c128, Cx<double>)

#undef SLATE_QR_APPEND

#define SLATE_QR_APPEND_SMEM(SFX, T)                                   \
  long long slate_qr_append_apply_smem_bytes_##SFX(int P) {            \
    return (long long)apply_smem_bytes<T>(P);                          \
  }
SLATE_QR_APPEND_SMEM(f32, float)
SLATE_QR_APPEND_SMEM(f64, double)
SLATE_QR_APPEND_SMEM(c64, Cx<float>)
SLATE_QR_APPEND_SMEM(c128, Cx<double>)
#undef SLATE_QR_APPEND_SMEM

const char* slate_qr_append_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
