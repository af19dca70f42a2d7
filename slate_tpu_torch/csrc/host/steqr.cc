// Host steqr of slate_tpu_torch: implicit-shift QR iteration on a real
// symmetric tridiagonal matrix, with optional eigenvector accumulation.
//
// The recurrence runs once on the host (a scalar chain no accelerator
// parallelizes). Each sweep's Givens rotations are journaled, then
// applied to Z by OpenMP threads, each on its own block of rows: every
// rank redundantly holds the rotations and applies them to its own
// rows, as SLATE's distributed steqr does (src/steqr_impl.cc:253-262).
// A thread takes its rows kRows at a time and applies each rotation to
// all of them before the next, so the kRows dependent chains of one
// rotation sequence overlap; every element of Z still sees the same
// rotations in the same order, so the result does not depend on kRows
// or on the thread count.
//
// Interface (ctypes, plain C):
//   int64_t st_steqr(n, d, e, z, compute_z, max_iters)
//   int64_t st_steqr_nt(n, d, e, z, compute_z, max_iters, threads)
// d[n], e[n] (e[n-1] unused), z row-major n x n (typically I), all
// float64, worked in place. Returns 0 on convergence, else the count of
// off-diagonals left (LAPACK's info > 0). Values come back unsorted.
// threads <= 0 takes OpenMP's default.
//
// Build: g++ -O3 -fPIC -fopenmp -shared -o libsteqr.so steqr.cc
// (slate_tpu_torch/ops/_build.py does this at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr int64_t kRows = 8;  // rows of Z a thread carries per pass

// Analytic eigendecomposition of the symmetric 2x2 [[a, b], [b, c]]
// (LAPACK dlaev2's formulas): rt1/rt2 the eigenvalues (|rt1| >= |rt2|),
// (cs1, sn1) the unit eigenvector of rt1. A trailing 2x2 block is closed
// with one exact rotation, as SLATE's steqr does with lapack::laev2.
void laev2(double a, double b, double c, double& rt1, double& rt2,
           double& cs1, double& sn1) {
    const double sm = a + c, df = a - c;
    const double adf = std::fabs(df), tb = b + b;
    const double ab = std::fabs(tb);
    double acmx, acmn;
    if (std::fabs(a) > std::fabs(c)) { acmx = a; acmn = c; }
    else                             { acmx = c; acmn = a; }
    double rt;
    if (adf > ab)      rt = adf * std::sqrt(1.0 + (ab / adf) * (ab / adf));
    else if (adf < ab) rt = ab * std::sqrt(1.0 + (adf / ab) * (adf / ab));
    else               rt = ab * std::sqrt(2.0);
    int sgn1;
    if (sm < 0.0) {
        rt1 = 0.5 * (sm - rt); sgn1 = -1;
        rt2 = (acmx / rt1) * acmn - (b / rt1) * b;
    } else if (sm > 0.0) {
        rt1 = 0.5 * (sm + rt); sgn1 = 1;
        rt2 = (acmx / rt1) * acmn - (b / rt1) * b;
    } else {
        rt1 = 0.5 * rt; rt2 = -0.5 * rt; sgn1 = 1;
    }
    double cs;
    int sgn2;
    if (df >= 0.0) { cs = df + rt; sgn2 = 1; }
    else           { cs = df - rt; sgn2 = -1; }
    const double acs = std::fabs(cs);
    if (acs > ab) {
        const double ct = -tb / cs;
        sn1 = 1.0 / std::sqrt(1.0 + ct * ct);
        cs1 = ct * sn1;
    } else if (ab == 0.0) {
        cs1 = 1.0; sn1 = 0.0;
    } else {
        const double tn = -cs / tb;
        cs1 = 1.0 / std::sqrt(1.0 + tn * tn);
        sn1 = tn * cs1;
    }
    if (sgn1 == sgn2) {
        const double tn = cs1;
        cs1 = -sn1;
        sn1 = tn;
    }
}

// Z <- Z * G_lo * ... * G_{hi-1}: rotation i mixes columns i and i + 1
// of every row, rows split among the threads in blocks of kRows.
void rotate_rows(double* z, int64_t n, int64_t lo, int64_t hi,
                 const double* cj, const double* sj, int threads) {
    const int64_t blocks = (n + kRows - 1) / kRows;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) num_threads(threads)
#endif
    for (int64_t blk = 0; blk < blocks; ++blk) {
        const int64_t r0 = blk * kRows;
        const int64_t r1 = std::min(n, r0 + kRows);
        for (int64_t i = lo; i < hi; ++i) {
            const double c = cj[i], s = sj[i];
            for (int64_t r = r0; r < r1; ++r) {
                double* zr = z + r * n;
                const double zi = zr[i];
                zr[i]     =  c * zi + s * zr[i + 1];
                zr[i + 1] = -s * zi + c * zr[i + 1];
            }
        }
    }
}

}  // namespace

extern "C" {

int64_t st_steqr_nt(int64_t n, double* d, double* e, double* z,
                    int64_t compute_z, int64_t max_iters, int64_t threads) {
    if (n <= 1) return 0;
    int nt = static_cast<int>(threads);
#if defined(_OPENMP)
    if (nt <= 0) nt = omp_get_max_threads();
#else
    nt = 1;
#endif
    double* cj = new double[n];
    double* sj = new double[n];

    // SLATE's deflation criterion (src/steqr_impl.cc:238-241, LAPACK
    // dsteqr's geometric mean): |e_i| <= eps sqrt(|d_i||d_{i+1}|)
    // + safe_min, in the unsquared form sqrt(|d_i|)*sqrt(|d_{i+1}|) so
    // that it cannot over- or underflow at the ends of the range.
    const double eps = std::numeric_limits<double>::epsilon();
    const double safmin = std::numeric_limits<double>::min();

    for (int64_t iter = 0; iter < max_iters; ++iter) {
        for (int64_t i = 0; i < n - 1; ++i) {
            if (e[i] == 0.0) continue;  // already deflated
            const double tol = eps * std::sqrt(std::fabs(d[i])) *
                               std::sqrt(std::fabs(d[i + 1])) + safmin;
            if (std::fabs(e[i]) <= tol) e[i] = 0.0;
        }
        // trailing undeflated block [lo, hi]
        int64_t hi = n - 1;
        while (hi > 0 && e[hi - 1] == 0.0) --hi;
        if (hi == 0) { delete[] cj; delete[] sj; return 0; }
        int64_t lo = hi - 1;
        while (lo > 0 && e[lo - 1] != 0.0) --lo;

        if (hi - lo == 1) {
            // close the 2x2 block with one exact rotation (laev2)
            double rt1, rt2, c2, s2;
            laev2(d[lo], e[lo], d[hi], rt1, rt2, c2, s2);
            d[lo] = rt1; d[hi] = rt2; e[lo] = 0.0;
            if (compute_z) {
                cj[lo] = c2; sj[lo] = s2;
                rotate_rows(z, n, lo, lo + 1, cj, sj, nt);
            }
            continue;
        }

        // Wilkinson shift from the trailing 2x2
        const double a11 = d[hi - 1], a22 = d[hi], ab = e[hi - 1];
        const double delta = (a11 - a22) / 2.0;
        const double sgn = (delta > 0.0) ? 1.0
                           : (delta < 0.0 ? -1.0 : 1.0);
        const double denom = delta + sgn * std::hypot(delta, ab);
        const double mu = (denom != 0.0) ? a22 - (ab * ab) / denom
                                         : a22 - ab;

        // bulge-chasing sweep over [lo, hi], journaling its rotations
        double f = d[lo] - mu, g = e[lo];
        for (int64_t i = lo; i < hi; ++i) {
            double c, s, r;
            if (g == 0.0)      { c = 1.0; s = 0.0; r = f; }
            else if (f == 0.0) { c = 0.0; s = 1.0; r = g; }
            else { r = std::hypot(f, g); c = f / r; s = g / r; }
            if (i > lo) e[i - 1] = r;
            const double m11 = d[i], m12 = e[i], m22 = d[i + 1];
            d[i]     = c * c * m11 + 2.0 * c * s * m12 + s * s * m22;
            d[i + 1] = s * s * m11 - 2.0 * c * s * m12 + c * c * m22;
            e[i] = (c * c - s * s) * m12 + c * s * (m22 - m11);
            if (i < hi - 1) {
                const double bulge = s * e[i + 1];
                e[i + 1] = c * e[i + 1];
                f = e[i]; g = bulge;
            }
            cj[i] = c; sj[i] = s;
        }
        if (compute_z) rotate_rows(z, n, lo, hi, cj, sj, nt);
    }
    delete[] cj; delete[] sj;
    int64_t left = 0;
    for (int64_t i = 0; i < n - 1; ++i) if (e[i] != 0.0) ++left;
    return left;
}

int64_t st_steqr(int64_t n, double* d, double* e, double* z,
                 int64_t compute_z, int64_t max_iters) {
    return st_steqr_nt(n, d, e, z, compute_z, max_iters, 0);
}

}  // extern "C"
