// P9: the k roots of one divide-and-conquer merge's secular equation
//     f(λ) = 1 + ρ·Σᵢ z2ᵢ / (δᵢ − λ) = 0,   δ ascending, z2 > 0, ρ > 0,
// in float64, as (upper, μ) with root j = δ[j + upper_j] + μ_j: each root
// is carried in the variable shifted to its nearer pole (dlaed4's
// convention), so δᵢ − λ_j = (δᵢ − δ[shift_j]) − μ_j never cancels.
//
// No Pallas kernel: this replaces the reference's df32 secular sweep
// _secular_kernel_body (slate_tpu/linalg/stedc.py:171-290, a lax.map of
// fori_loops that XLA fuses into one program) and its host sweep
// _secular_roots (:74-168), with the contract of the plain version
// hopper_ops.secular_roots_plain. The card has float64, so the TPU's
// double-single pairs are not carried over: every sum is a native float64
// sum.
//
// What bounds it. Each root takes 1 + 55 + 4 + 2 = 62 passes over all k
// poles (the pole choice, the bisections, the Newton steps, the
// fixed-point steps) plus one for ‖z‖², each pass a subtraction, a
// division and an addition per pole: about 61·k²·3 float64 operations, a
// few MB of bytes. So operations bound it, and the divisions (a
// reciprocal and a few dependent FMAs each) set the pace.
//
// Design, simple first: one thread per root, kThreads roots a CTA (one
// warp, so k = 4096 already spreads over 128 SMs). The CTA stages the
// poles δ and z2 in shared memory kTile at a time; every thread then reads
// the same pole in the same step, a broadcast. Every thread runs the same
// fixed schedule, so the CTA's barriers line up; threads past k compute
// on root k − 1 and store nothing. Each f is summed in pole order, with
// the plain version's guards: a zero denominator becomes 1e-300, and the
// fixed point masks its own pole (and a zero denominator) with 1e300.
// The widths δ_{j+1} − δ_j, and ρ‖z‖² for the last root, are made here.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math (IEEE division).

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 32;    // hopper_ops.SECULAR_THREADS
constexpr int kTile = 1024;     // hopper_ops.SECULAR_TILE
constexpr int kBisect = 55;     // hopper_ops.SECULAR_BISECT
constexpr int kNewton = 4;      // hopper_ops.SECULAR_NEWTON
constexpr int kFixed = 2;       // hopper_ops.SECULAR_FIXED

struct Poles {
  const double* delta;
  const double* z2;
  int k;
};

// One pass over the poles, tile by tile through shared memory: calls
// term(i, δᵢ, z2ᵢ) for i = 0 … k − 1 in order. Every thread of the CTA
// must call it (the barriers).
template <typename Term>
__device__ void sweep(const Poles& p, double* sd, double* sz, Term term) {
  for (int t0 = 0; t0 < p.k; t0 += kTile) {
    const int n = min(kTile, p.k - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < n; i += kThreads) {
      sd[i] = p.delta[t0 + i];
      sz[i] = p.z2[t0 + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < n; ++i) term(t0 + i, sd[i], sz[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
secular_roots_kernel(const double* __restrict__ delta,
                     const double* __restrict__ z2, double rho,
                     unsigned char* __restrict__ upper_out,
                     double* __restrict__ mu_out, int k) {
  __shared__ double sd[kTile];
  __shared__ double sz[kTile];
  const Poles p{delta, z2, k};
  const int jt = blockIdx.x * kThreads + threadIdx.x;
  const int j = min(jt, k - 1);
  const bool notlast = j < k - 1;

  double znorm2 = 0.0;
  sweep(p, sd, sz, [&](int, double, double z) { znorm2 += z; });
  const double dj = delta[j];
  const double w = notlast ? delta[j + 1] - dj : rho * znorm2;

  // the nearer pole, by the sign of f at the interval's midpoint
  const double mid0 = 0.5 * w;
  double s = 0.0;
  sweep(p, sd, sz, [&](int, double d, double z) {
    double den = (d - dj) - mid0;
    if (den == 0.0) den = 1e-300;
    s += z / den;
  });
  const bool upper = (1.0 + rho * s < 0.0) && notlast;
  const int sj = upper ? j + 1 : j;
  const double ds = delta[sj];

  double lo = upper ? -0.5 * w : 0.0;
  double hi = upper ? 0.0 : (notlast ? 0.5 * w : w);
  for (int it = 0; it < kBisect; ++it) {
    const double mid = 0.5 * (lo + hi);
    s = 0.0;
    sweep(p, sd, sz, [&](int, double d, double z) {
      double den = (d - ds) - mid;
      if (den == 0.0) den = 1e-300;
      s += z / den;
    });
    if (1.0 + rho * s < 0.0) lo = mid; else hi = mid;
  }
  const double blo = lo, bhi = hi;  // the bisection's bracket of the root

  double m = 0.5 * (lo + hi);
  for (int it = 0; it < kNewton; ++it) {
    double s1 = 0.0, s2 = 0.0;
    sweep(p, sd, sz, [&](int, double d, double z) {
      double den = (d - ds) - m;
      if (den == 0.0) den = 1e-300;
      const double r = z / den;
      s1 += r;
      s2 += r / den;
    });
    const double f = 1.0 + rho * s1;
    const double fp = rho * s2;  // f' = ρ·Σ z2/den²
    if (f < 0.0) lo = m; else hi = m;  // every evaluation shrinks it
    const double m_new = m - (fp > 0.0 ? f / fp : 0.0);
    const bool bad = m_new <= lo || m_new >= hi || !isfinite(m_new);
    m = bad ? 0.5 * (lo + hi) : m_new;
  }

  // roots closer to their pole than the bisection resolves: the fixed
  // point μ = ρ·z2ₚ / (1 + ρ·Σ_{i≠p} z2ᵢ/(δᵢ − δₚ − μ)) for relative
  // accuracy, a candidate taken only inside the bisection's bracket (as
  // the plain version: a pole of negligible weight beside a root the
  // other poles place would otherwise pull it to a false root)
  const double zp2 = z2[sj];
  const double weff = upper ? 0.5 * w : w;
  const bool near_pole = fabs(m) < 1e-6 * weff;
  const double want = upper ? -1.0 : 1.0;
  for (int it = 0; it < kFixed; ++it) {
    s = 0.0;
    sweep(p, sd, sz, [&](int i, double d, double z) {
      double den = (d - ds) - m;
      if (i == sj || den == 0.0) den = 1e300;
      s += z / den;
    });
    const double rest = 1.0 + rho * s;
    const double cand = rho * zp2 / (rest == 0.0 ? 1e-300 : rest);
    const double sgn = cand > 0.0 ? 1.0 : (cand < 0.0 ? -1.0 : 0.0);
    const bool ok = isfinite(cand) && rest != 0.0 && sgn == want &&
                    fabs(cand) < 1e-5 * weff && cand >= blo && cand <= bhi;
    if (near_pole && ok) m = cand;
  }

  if (jt < k) {
    upper_out[jt] = upper ? 1 : 0;
    mu_out[jt] = m;
  }
}

}  // namespace

extern "C" {

int slate_secular_roots_f64(const void* delta, const void* z2, double rho,
                            void* upper, void* mu, int k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const int ctas = (k + kThreads - 1) / kThreads;
  secular_roots_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const double*>(delta), static_cast<const double*>(z2), rho,
      static_cast<unsigned char*>(upper), static_cast<double*>(mu), k);
  return (int)cudaGetLastError();
}

const char* slate_secular_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
