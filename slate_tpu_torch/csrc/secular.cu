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
// fixed-point steps), each pass a subtraction, a reciprocal and a fused
// multiply-add per pole: about 62·k² terms of some nine float64
// instructions, a few MB of bytes. So the FP64 pipes bound it, provided
// that enough independent terms are in flight; one thread walking a
// root's k terms in a chain (the first design) is bound by that chain's
// latency instead, 62·k terms of about 200 cycles a launch.
//
// Design. A root's pole sums are split over a group of L lanes of one
// warp (L = 4, 8, 16 or 32; 32 / L roots a warp): lane l sums poles
// l, l + L, l + 2L, … in index order, each term z2ᵢ·(1/den) fused into its
// partial, and the L partials meet in a fixed xor butterfly
// (__shfl_xor_sync at offsets 1, 2, …, L/2). At each butterfly step the
// two lanes of a pair add the same two values, and float64 addition
// commutes, so EVERY LANE OF A GROUP ENDS EACH PASS WITH THE SAME f, BIT
// FOR BIT. The whole schedule depends on this: lo, hi, m, the pole choice
// and every branch are uniform across the group, with no vote and no
// broadcast. The fixed point masks its own pole on the lane that holds
// pole sj. The sums do not depend on the plan's other choices (warps a
// CTA, resident or tiled), only on L, and the launch has no atomics: two
// launches on one input give the same bits.
//
// The plan comes from k alone (plan_for; hopper_ops.secular_roots_plan
// mirrors it): L the widest whose k·L/32 root-warps fit one wave of
// kMaxWarps-warp CTAs on the card's kSms SMs (32 up to k = 2112, 16 up to
// 4224, 8 up to 8448, then 4), warps a CTA as few as spread the roots
// over all SMs (up to kMaxWarps), and the poles δ and z2 resident in
// shared memory for the whole schedule where 16·k bytes fit
// (k ≤ kResidentMax), else staged kTile at a time on every pass behind
// two barriers (all warps of a CTA run the same fixed schedule, so the
// barriers line up; groups past k compute on root k − 1 and store
// nothing). kTile is a multiple of 32, so a lane sums the same poles in
// the same order either way. Lanes of a group read consecutive poles and
// the groups of a warp the same ones, a broadcast. Staged tiles beat
// reading the poles straight from L2 above the resident limit (13.5
// against 18.0 ms at k = 16384 on an H100 SXM, tools/p9_ablation.py):
// a CTA's warps share each tile. The pole loop is unrolled by 8, so a
// lane keeps several independent reciprocals in flight.
//
// One reciprocal per pole and evaluation, branch-free: the
// rcp.approx.ftz.f64 seed and two Newton–Raphson steps (4 FMAs), where
// IEEE division compiles to a slow-path branch that keeps the unrolled
// terms from overlapping. Its denominator is clamped to |den| ≥ 1e-300
// with its sign kept (a zero to +1e-300, the plain version's guard), so
// a subnormal gap never overflows a term to ±Inf or NaN; the fixed point
// masks its own pole and a zero denominator with 1e300, as the plain
// version. Newton's f' takes r·(1/den) from the same reciprocal.
// ‖z‖² (the last root's width ρ‖z‖²) is summed by the last CTA alone,
// in the same lane order. The widths δ_{j+1} − δ_j are made here.
//
// Built with nvcc for sm_90a WITHOUT --use_fast_math.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBisect = 55;           // hopper_ops.SECULAR_BISECT
constexpr int kNewton = 4;            // hopper_ops.SECULAR_NEWTON
constexpr int kFixed = 2;             // hopper_ops.SECULAR_FIXED
constexpr int kMaxWarps = 16;         // hopper_ops.SECULAR_MAX_WARPS
constexpr int kMinLanes = 4;          // hopper_ops.SECULAR_MIN_LANES
constexpr int kSms = 132;             // hopper_ops.SECULAR_SMS
constexpr int kResidentMax = 14336;   // hopper_ops.SECULAR_RESIDENT_MAX
constexpr int kTile = 4096;           // hopper_ops.SECULAR_TILE
constexpr double kTiny = 1e-300;      // |den| clamp; a zero den's value
constexpr double kMask = 1e300;       // the fixed point's own pole

struct Plan {
  int ctas, warps, lanes, resident;
  size_t smem;
};

int lanes_for(int k) {
  int lanes = 32;
  while (lanes > kMinLanes && (long long)k * lanes > 32LL * kSms * kMaxWarps)
    lanes /= 2;
  return lanes;
}

Plan plan_for(int k) {
  Plan p;
  p.lanes = lanes_for(k);
  const int per_warp = 32 / p.lanes;
  const int spread = (k + per_warp * kSms - 1) / (per_warp * kSms);
  p.warps = spread < kMaxWarps ? spread : kMaxWarps;
  p.ctas = (k + per_warp * p.warps - 1) / (per_warp * p.warps);
  p.resident = k <= kResidentMax;
  p.smem = 2 * sizeof(double) * (size_t)(p.resident ? k : kTile);
  return p;
}

// 1/d from the seed and two Newton–Raphson steps (finite d with
// |d| ≥ 1e-300; the seed flushes subnormals, which the clamp keeps out)
__device__ __forceinline__ double recip(double d) {
  double x;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(x) : "d"(d));
  double e = fma(-d, x, 1.0);
  x = fma(x, e, x);
  e = fma(-d, x, 1.0);
  return fma(x, e, x);
}

__device__ __forceinline__ double clamp_den(double den) {
  return fabs(den) < kTiny ? (den < 0.0 ? -kTiny : kTiny) : den;
}

// the group's L partials summed by the fixed xor butterfly: the same bits
// on every lane of the group
template <int L>
__device__ __forceinline__ double group_sum(double s) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One pass over the poles: lane l of the group calls term(i, δᵢ, z2ᵢ) for
// i = l, l + L, … in order. Tiled, every thread of the CTA must call it
// (the barriers).
template <int L, bool kResident>
struct Sweep {
  const double* delta;
  const double* z2;
  double* sd;
  double* sz;
  int k, lane;

  template <typename Term>
  __device__ __forceinline__ void operator()(Term term) const {
    if (kResident) {
#pragma unroll 8
      for (int i = lane; i < k; i += L) term(i, sd[i], sz[i]);
      return;
    }
    for (int t0 = 0; t0 < k; t0 += kTile) {
      const int n = min(kTile, k - t0);
      __syncthreads();  // the previous tile is no longer read
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        sd[i] = delta[t0 + i];
        sz[i] = z2[t0 + i];
      }
      __syncthreads();
#pragma unroll 8
      for (int i = lane; i < n; i += L) term(t0 + i, sd[i], sz[i]);
    }
  }
};

template <int L, bool kResident>
__global__ void __launch_bounds__(kMaxWarps * 32)
secular_roots_kernel(const double* __restrict__ delta,
                     const double* __restrict__ z2, double rho,
                     unsigned char* __restrict__ upper_out,
                     double* __restrict__ mu_out, int k) {
  extern __shared__ double smem[];
  constexpr int kGroups = 32 / L;
  const int warp = threadIdx.x >> 5;
  const int group = (threadIdx.x & 31) / L;
  const Sweep<L, kResident> sweep{delta, z2, smem,
                                  smem + (kResident ? k : kTile), k,
                                  (int)(threadIdx.x & (L - 1))};
  const int jt = (blockIdx.x * (blockDim.x >> 5) + warp) * kGroups + group;
  const int j = min(jt, k - 1);
  const bool notlast = j < k - 1;
  if (kResident) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      sweep.sd[i] = delta[i];
      sweep.sz[i] = z2[i];
    }
    __syncthreads();
  }

  double znorm2 = 0.0;  // the last CTA's: its groups hold root k − 1
  if (blockIdx.x == gridDim.x - 1) {
    double s = 0.0;
    sweep([&](int, double, double z) { s += z; });
    znorm2 = group_sum<L>(s);
  }
  const double dj = delta[j];
  const double w = notlast ? delta[j + 1] - dj : rho * znorm2;

  // the nearer pole, by the sign of f at the interval's midpoint
  const double mid0 = 0.5 * w;
  double s = 0.0;
  sweep([&](int, double d, double z) {
    s = fma(z, recip(clamp_den((d - dj) - mid0)), s);
  });
  s = group_sum<L>(s);
  const bool upper = (1.0 + rho * s < 0.0) && notlast;
  const int sj = upper ? j + 1 : j;
  const double ds = delta[sj];

  double lo = upper ? -0.5 * w : 0.0;
  double hi = upper ? 0.0 : (notlast ? 0.5 * w : w);
  for (int it = 0; it < kBisect; ++it) {
    const double mid = 0.5 * (lo + hi);
    s = 0.0;
    sweep([&](int, double d, double z) {
      s = fma(z, recip(clamp_den((d - ds) - mid)), s);
    });
    s = group_sum<L>(s);
    if (1.0 + rho * s < 0.0) lo = mid; else hi = mid;
  }
  const double blo = lo, bhi = hi;  // the bisection's bracket of the root

  double m = 0.5 * (lo + hi);
  for (int it = 0; it < kNewton; ++it) {
    double s1 = 0.0, s2 = 0.0;
    sweep([&](int, double d, double z) {
      const double inv = recip(clamp_den((d - ds) - m));
      const double r = z * inv;
      s1 += r;
      s2 = fma(r, inv, s2);
    });
    s1 = group_sum<L>(s1);
    s2 = group_sum<L>(s2);
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
    sweep([&](int i, double d, double z) {
      const double den = (d - ds) - m;
      s = fma(z, recip((i == sj || den == 0.0) ? kMask : clamp_den(den)), s);
    });
    s = group_sum<L>(s);
    const double rest = 1.0 + rho * s;
    const double cand = rho * zp2 / (rest == 0.0 ? 1e-300 : rest);
    const double sgn = cand > 0.0 ? 1.0 : (cand < 0.0 ? -1.0 : 0.0);
    const bool ok = isfinite(cand) && rest != 0.0 && sgn == want &&
                    fabs(cand) < 1e-5 * weff && cand >= blo && cand <= bhi;
    if (near_pole && ok) m = cand;
  }

  if (jt < k && (threadIdx.x & (L - 1)) == 0) {
    upper_out[jt] = upper ? 1 : 0;
    mu_out[jt] = m;
  }
}

template <int L, bool kResident>
int launch(const Plan& p, const void* delta, const void* z2, double rho,
           void* upper, void* mu, int k, cudaStream_t stream) {
  auto kernel = secular_roots_kernel<L, kResident>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<p.ctas, p.warps * 32, p.smem, stream>>>(
      static_cast<const double*>(delta), static_cast<const double*>(z2), rho,
      static_cast<unsigned char*>(upper), static_cast<double*>(mu), k);
  return (int)cudaGetLastError();
}

template <bool kResident>
int dispatch(const Plan& p, const void* delta, const void* z2, double rho,
             void* upper, void* mu, int k, cudaStream_t stream) {
  switch (p.lanes) {
    case 4:
      return launch<4, kResident>(p, delta, z2, rho, upper, mu, k, stream);
    case 8:
      return launch<8, kResident>(p, delta, z2, rho, upper, mu, k, stream);
    case 16:
      return launch<16, kResident>(p, delta, z2, rho, upper, mu, k, stream);
    case 32:
      return launch<32, kResident>(p, delta, z2, rho, upper, mu, k, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the kernel's reciprocal of a clamped denominator, one value a thread
__global__ void secular_recip_kernel(const double* __restrict__ x,
                                     double* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = recip(clamp_den(x[i]));
}

}  // namespace

extern "C" {

int slate_secular_roots_f64(const void* delta, const void* z2, double rho,
                            void* upper, void* mu, int k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.resident ? dispatch<true>(p, delta, z2, rho, upper, mu, k, st)
                    : dispatch<false>(p, delta, z2, rho, upper, mu, k, st);
}

// the plan of a launch at k roots: ctas, warps a CTA, lanes a root,
// resident (1) or tiled (0), dynamic shared bytes
int slate_secular_plan(int k, int* out) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(k);
  out[0] = p.ctas;
  out[1] = p.warps;
  out[2] = p.lanes;
  out[3] = p.resident;
  out[4] = (int)p.smem;
  return 0;
}

// recip(clamp_den(x)) for n values (the reciprocal's error, measured by
// chip_smoke.py against IEEE division)
int slate_secular_recip_f64(const void* x, void* out, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  secular_recip_kernel<<<(n + 255) / 256, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(out), n);
  return (int)cudaGetLastError();
}

const char* slate_secular_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
