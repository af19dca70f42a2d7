// Complex arithmetic of the kernels: one element type Cx<R> in torch's
// interleaved layout (complex64 = Cx<float>, complex128 = Cx<double>) and
// the few operations the LU, Cholesky and Householder kernels and P1 need,
// each written for the real types too, so one kernel body serves float,
// double and both complex types.
//
// Two families:
// - cx::mul_rn, add_rn, sub_rn, divide, div_real_rn, sqrt_rn: every real
//   product, sum and quotient rounded apart (no FMA contraction), in the
//   order of the plain PyTorch versions' helpers (hopper_ops.cx_mul,
//   cx_div, cx_div_real, cx_abs), so a kernel that replays its plain
//   version's formula stays bitwise equal to it in complex types too. The
//   product is (ar·br − ai·bi, ar·bi + ai·br); the quotient is Smith's
//   scaled form as numpy and c10::complex write it, its ratio and scale
//   made once per divisor (cx::Divisor); the modulus is hypot, as
//   torch.hypot computes it on the card, and NaN where either part is NaN
//   (the reference's jnp.abs: XLA's |inf + nan·i| is NaN, hypot's inf).
// - the operators + − * and cx::fma_conj, conj, abs2, scale for kernels
//   held to a tolerance (K1, P1, K3, K4, P5), where the compiler may
//   contract.

#pragma once

#include <cuda_runtime.h>

template <typename R>
struct alignas(2 * sizeof(R)) Cx {
  R re, im;
  Cx() = default;
  __host__ __device__ constexpr Cx(R r, R i = R(0)) : re(r), im(i) {}
};

template <typename T> struct RealOf { using type = T; };
template <typename R> struct RealOf<Cx<R>> { using type = R; };
template <typename T> using real_t = typename RealOf<T>::type;

template <typename R>
__device__ __forceinline__ Cx<R> operator+(Cx<R> a, Cx<R> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename R>
__device__ __forceinline__ Cx<R> operator-(Cx<R> a, Cx<R> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename R>
__device__ __forceinline__ Cx<R> operator-(Cx<R> a) {
  return {-a.re, -a.im};
}
template <typename R>
__device__ __forceinline__ Cx<R> operator*(Cx<R> a, Cx<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename R>
__device__ __forceinline__ Cx<R>& operator+=(Cx<R>& a, Cx<R> b) {
  return a = a + b;
}
template <typename R>
__device__ __forceinline__ Cx<R>& operator-=(Cx<R>& a, Cx<R> b) {
  return a = a - b;
}

namespace cx {

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }

template <typename R>
__device__ __forceinline__ Cx<R> mul_rn(Cx<R> a, Cx<R> b) {
  return {sub_rn(mul_rn(a.re, b.re), mul_rn(a.im, b.im)),
          add_rn(mul_rn(a.re, b.im), mul_rn(a.im, b.re))};
}
template <typename R>
__device__ __forceinline__ Cx<R> add_rn(Cx<R> a, Cx<R> b) {
  return {add_rn(a.re, b.re), add_rn(a.im, b.im)};
}
template <typename R>
__device__ __forceinline__ Cx<R> sub_rn(Cx<R> a, Cx<R> b) {
  return {sub_rn(a.re, b.re), sub_rn(a.im, b.im)};
}

// a / r for a real r, part by part
template <typename R>
__device__ __forceinline__ R div_real_rn(R a, R r) { return div_rn(a, r); }
template <typename R>
__device__ __forceinline__ Cx<R> div_real_rn(Cx<R> a, R r) {
  return {div_rn(a.re, r), div_rn(a.im, r)};
}

template <typename R> __device__ __forceinline__ R conj(R a) { return a; }
template <typename R> __device__ __forceinline__ Cx<R> conj(Cx<R> a) {
  return {a.re, -a.im};
}
template <typename R> __device__ __forceinline__ R real_part(R a) { return a; }
template <typename R> __device__ __forceinline__ R real_part(Cx<R> a) {
  return a.re;
}
template <typename R> __device__ __forceinline__ R imag_part(R) { return R(0); }
template <typename R> __device__ __forceinline__ R imag_part(Cx<R> a) {
  return a.im;
}
// |a|², each product and the sum rounded apart
template <typename R> __device__ __forceinline__ R abs2_rn(R a) {
  return mul_rn(a, a);
}
template <typename R> __device__ __forceinline__ R abs2_rn(Cx<R> a) {
  return add_rn(mul_rn(a.re, a.re), mul_rn(a.im, a.im));
}

// |a|: fabs, and for a complex a hypot (torch.hypot's function), NaN
// where either part is NaN
__device__ __forceinline__ float modulus(float a) { return fabsf(a); }
__device__ __forceinline__ double modulus(double a) { return fabs(a); }
__device__ __forceinline__ float modulus(Cx<float> a) {
  return isnan(a.re) || isnan(a.im) ? __int_as_float(0x7fc00000)
                                    : hypotf(a.re, a.im);
}
__device__ __forceinline__ double modulus(Cx<double> a) {
  return isnan(a.re) || isnan(a.im)
             ? __longlong_as_double(0x7ff8000000000000LL)
             : hypot(a.re, a.im);
}

// the LU kernels' bad pivot, the reference's isnan(|d|) | (|d| == 0)
template <typename T>
__device__ __forceinline__ bool bad_pivot(T d) {
  const auto m = modulus(d);
  return isnan(m) || m == 0;
}

// |a|² and a·r (r real) for the kernels held to a tolerance
template <typename R> __device__ __forceinline__ R abs2(R a) { return a * a; }
template <typename R> __device__ __forceinline__ R abs2(Cx<R> a) {
  return a.re * a.re + a.im * a.im;
}
template <typename R> __device__ __forceinline__ R scale(R a, R r) { return a * r; }
template <typename R> __device__ __forceinline__ Cx<R> scale(Cx<R> a, R r) {
  return {a.re * r, a.im * r};
}
// c + a·conj(b)
template <typename T>
__device__ __forceinline__ T fma_conj(T a, T b, T c) { return c + a * conj(b); }

// Smith's division by one divisor d, as c10::complex's operator/=:
//   |d.re| ≥ |d.im|: rat = d.im/d.re, scl = 1/(d.re + d.im·rat),
//                    (a.re + a.im·rat)·scl + i·(a.im − a.re·rat)·scl
//   (both parts 0:   a.re/|d.re| + i·a.im/|d.im|)
//   otherwise:       rat = d.re/d.im, scl = 1/(d.im + d.re·rat),
//                    (a.re·rat + a.im)·scl + i·(a.im·rat − a.re)·scl
template <typename T>
struct Divisor {
  T d;
};
template <typename R>
struct Divisor<Cx<R>> {
  R rat, scl, ar, ai;  // ar, ai: |d.re|, |d.im|
  int mode;            // 0: |re| ≥ |im|, 1: both zero, 2: |re| < |im|
};

template <typename R>
__device__ __forceinline__ Divisor<R> make_divisor(R d) { return {d}; }
template <typename R>
__device__ __forceinline__ Divisor<Cx<R>> make_divisor(Cx<R> d) {
  Divisor<Cx<R>> v;
  v.ar = fabs(d.re);
  v.ai = fabs(d.im);
  if (v.ar >= v.ai) {
    v.mode = v.ar == R(0) && v.ai == R(0) ? 1 : 0;
    v.rat = div_rn(d.im, d.re);
    v.scl = div_rn(R(1), add_rn(d.re, mul_rn(d.im, v.rat)));
  } else {
    v.mode = 2;
    v.rat = div_rn(d.re, d.im);
    v.scl = div_rn(R(1), add_rn(d.im, mul_rn(d.re, v.rat)));
  }
  return v;
}

template <typename R>
__device__ __forceinline__ R divide(R a, const Divisor<R>& v) {
  return div_rn(a, v.d);
}
template <typename R>
__device__ __forceinline__ Cx<R> divide(Cx<R> a, const Divisor<Cx<R>>& v) {
  if (v.mode == 1) return {div_rn(a.re, v.ar), div_rn(a.im, v.ai)};
  if (v.mode == 0)
    return {mul_rn(add_rn(a.re, mul_rn(a.im, v.rat)), v.scl),
            mul_rn(sub_rn(a.im, mul_rn(a.re, v.rat)), v.scl)};
  return {mul_rn(add_rn(mul_rn(a.re, v.rat), a.im), v.scl),
          mul_rn(sub_rn(mul_rn(a.im, v.rat), a.re), v.scl)};
}
template <typename T>
__device__ __forceinline__ T div(T a, T b) {
  return divide(a, make_divisor(b));
}

// warp shuffles and L2 loads of any element type
template <typename R>
__device__ __forceinline__ R shfl(R v, int src, unsigned mask = 0xffffffffu) {
  return __shfl_sync(mask, v, src);
}
template <typename R>
__device__ __forceinline__ Cx<R> shfl(Cx<R> v, int src,
                                      unsigned mask = 0xffffffffu) {
  return {__shfl_sync(mask, v.re, src), __shfl_sync(mask, v.im, src)};
}
template <typename R>
__device__ __forceinline__ R shfl_xor(R v, int lane_mask,
                                      unsigned mask = 0xffffffffu) {
  return __shfl_xor_sync(mask, v, lane_mask);
}
template <typename R>
__device__ __forceinline__ Cx<R> shfl_xor(Cx<R> v, int lane_mask,
                                          unsigned mask = 0xffffffffu) {
  return {__shfl_xor_sync(mask, v.re, lane_mask),
          __shfl_xor_sync(mask, v.im, lane_mask)};
}

template <typename R>
__device__ __forceinline__ R ldcg(const R* p) { return __ldcg(p); }
__device__ __forceinline__ Cx<float> ldcg(const Cx<float>* p) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
  return {v.x, v.y};
}
__device__ __forceinline__ Cx<double> ldcg(const Cx<double>* p) {
  const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
  return {v.x, v.y};
}

}  // namespace cx
