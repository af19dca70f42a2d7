"""Simplified API verbs of the ported slices (counterpart of
``slate_tpu/api.py:38-105``, ``119-289``, the batched verbs at
``320-359`` and the mixed-precision verbs at ``360-540``, no tracing
spans): the BLAS-3 verbs dispatch on the matrix kinds as the reference
does; the inverse verbs run getri and potri; the batched verbs take
(B, m, n) stacks (``linalg/batched.py``); the mixed verbs factor in a
lower precision and refine (``linalg/lu.py``, ``linalg/cholesky.py``,
``linalg/gmres.py``, and the batched mixed drivers)."""

from __future__ import annotations

import torch

from .core.exceptions import SlateError
from .core.tiled_matrix import TiledMatrix
from .core.types import MatrixKind, Options, Side, DEFAULT_OPTIONS
from .linalg import batched as batched_mod, blas3, cholesky, lu as lu_mod
from .linalg import gmres as gmres_mod, qr as qr_mod
from .refine.policy import check_cast_kinds, default_factor_dtype


def multiply(alpha, A: TiledMatrix, B: TiledMatrix, beta, C: TiledMatrix,
             opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """C = α·A·B + β·C: hemm or symm when A (or B) is Hermitian or
    Symmetric, else gemm."""
    if A.kind is MatrixKind.Hermitian:
        return blas3.hemm(Side.Left, alpha, A, B, beta, C, opts)
    if B.kind is MatrixKind.Hermitian:
        return blas3.hemm(Side.Right, alpha, B, A, beta, C, opts)
    if A.kind is MatrixKind.Symmetric:
        return blas3.symm(Side.Left, alpha, A, B, beta, C, opts)
    if B.kind is MatrixKind.Symmetric:
        return blas3.symm(Side.Right, alpha, B, A, beta, C, opts)
    return blas3.gemm(alpha, A, B, beta, C, opts)


def rank_k_update(alpha, A: TiledMatrix, beta, C: TiledMatrix,
                  opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """herk for a Hermitian C, else syrk."""
    if C.kind is MatrixKind.Hermitian:
        return blas3.herk(alpha, A, beta, C, opts)
    return blas3.syrk(alpha, A, beta, C, opts)


def rank_2k_update(alpha, A: TiledMatrix, B: TiledMatrix, beta,
                   C: TiledMatrix, opts: Options = DEFAULT_OPTIONS
                   ) -> TiledMatrix:
    """her2k for a Hermitian C, else syr2k."""
    if C.kind is MatrixKind.Hermitian:
        return blas3.her2k(alpha, A, B, beta, C, opts)
    return blas3.syr2k(alpha, A, B, beta, C, opts)


def triangular_multiply(alpha, A: TiledMatrix, B: TiledMatrix,
                        side: Side = Side.Left,
                        opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    return blas3.trmm(side, alpha, A, B, opts)


def triangular_solve(alpha, A: TiledMatrix, B: TiledMatrix,
                     side: Side = Side.Left,
                     opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    return blas3.trsm(side, alpha, A, B, opts)


def lu_factor(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS):
    """(LU, perm, info) with A[perm] = L·U."""
    return lu_mod.getrf(A, opts)


def lu_solve(A: TiledMatrix, B: TiledMatrix,
             opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    X, _ = lu_mod.gesv(A, B, opts)
    return X


def lu_solve_using_factor(LU: TiledMatrix, perm, B: TiledMatrix,
                          opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    return lu_mod.getrs(LU, perm, B, opts)


def lu_inverse_using_factor(LU: TiledMatrix, perm,
                            opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """A⁻¹ from lu_factor's (LU, perm)."""
    return lu_mod.getri(LU, perm, opts)


def chol_factor(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS):
    """(L, info) for a Hermitian/Symmetric A."""
    return cholesky.potrf(A, opts)


def chol_solve(A: TiledMatrix, B: TiledMatrix,
               opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    X, _ = cholesky.posv(A, B, opts)
    return X


def chol_solve_using_factor(L: TiledMatrix, B: TiledMatrix,
                            opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    return cholesky.potrs(L, B, opts)


def chol_inverse_using_factor(L: TiledMatrix,
                              opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """A⁻¹ from chol_factor's L (potri)."""
    return cholesky.potri(L, opts)


def qr_factor(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS):
    """Householder QR factors (geqrf) as a resident object."""
    return qr_mod.geqrf(A, opts)


def least_squares_solve_using_factor(QR, B: TiledMatrix,
                                     opts: Options = DEFAULT_OPTIONS
                                     ) -> TiledMatrix:
    """X = R⁻¹·(Qᴴ·B)[:n] from a resident qr_factor result."""
    return qr_mod.gels_using_factor(QR, B, opts)


def least_squares_solve(A: TiledMatrix, B: TiledMatrix,
                        opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    return qr_mod.gels(A, B, opts)


# ---------------------------------------------------------------------------
# batched small-problem verbs: (B, m, n) stacks, numpy or tensors; a
# numpy stack goes to ``device`` ("cuda" unless "cpu" is asked for), a
# tensor stays on its device
# ---------------------------------------------------------------------------

def gesv_batched(A, B, nb=None, device="cuda"):
    """Batched A·X = B over a (B, n, n) stack → (X, info (B,)): batched LU
    factor and solve."""
    return batched_mod.gesv_batched(A, B, nb, device)


def posv_batched(A, B, nb=None, device="cuda"):
    """Batched symmetric-positive-definite A·X = B (lower storage) over a
    (B, n, n) stack → (X, info (B,)): batched Cholesky factor and solve."""
    return batched_mod.posv_batched(A, B, nb, device)


def geqrf_batched(A, nb=None, device="cuda"):
    """Batched Householder QR over a (B, m, n) stack (m ≥ n) → (packed
    V\\R, taus, Ts), the factor ``gels_batched_using_factor`` takes."""
    return batched_mod.geqrf_batched(A, nb, device)


def gels_batched(A, B, nb=None, device="cuda"):
    """Batched least squares min‖A·X − B‖ over a (B, m, n) stack (m ≥ n)
    → (X, info (B,)): batched QR factor and solve."""
    return batched_mod.gels_batched(A, B, nb, device)


def _mixed_batched_factor_dtype(A, factor_dtype, what: str):
    """The batched mixed verbs' factor type: by default one tier down the
    refine ladder (f32 → bf16, f64 → f32, c128 → c64; complex64 has no
    lower complex type and raises, never a real-part-only factor); an
    explicit type must agree with the operand in real/complex kind."""
    wd = getattr(A, "dtype", None)
    if wd is None:
        wd = batched_mod._tensor(A, "cpu").dtype
    if factor_dtype is None:
        lo = default_factor_dtype(wd)
        if lo is None:
            raise SlateError(
                f"{what}: no lower factor precision exists for dtype {wd} "
                "— pass factor_dtype explicitly or use the full-precision "
                "batched solve")
        return lo
    try:
        check_cast_kinds(wd, factor_dtype, what)
    except ValueError as e:
        raise SlateError(str(e))
    return factor_dtype


def _mixed_batched_fallback(A, B, X, info, iters, solver, nb):
    """Re-solve the items that did not converge (iters < 0) at working
    precision through the plain batched driver and splice them back: a
    converged lane's bits are untouched, and a lane singular in low
    precision takes the fallback too and reports the working-precision
    info."""
    idx = torch.nonzero(iters < 0).flatten()
    if idx.numel() == 0:
        return X, info
    a = batched_mod._tensor(A, X.device)[idx]
    b = batched_mod._tensor(B, X.device, X.dtype)[idx]
    Xf, inff = solver(a, b, nb)
    X, info = X.clone(), info.clone()
    X[idx] = Xf
    info[idx] = inff
    return X, info


def gesv_mixed_batched(A, B, nb=None, factor_dtype=None, max_iters: int = 30,
                       tol=None, fallback: bool = True, device="cuda"):
    """Batched mixed-precision A·X = B over a (B, n, n) stack → (X, info
    (B,), iters (B,)): low-precision LU and per-item-masked refinement.
    ``factor_dtype`` defaults one tier down the refine ladder. iters[i] < 0:
    item i did not converge; with ``fallback`` (default, the reference's
    Option::UseFallbackSolver) those items are solved again at working
    precision by ``gesv_batched`` and keep their negative iters as the
    marker."""
    factor_dtype = _mixed_batched_factor_dtype(A, factor_dtype,
                                               "gesv_mixed_batched")
    X, info, iters = batched_mod.gesv_mixed_batched(
        A, B, nb, factor_dtype=factor_dtype, max_iters=max_iters, tol=tol,
        device=device)
    if fallback:
        X, info = _mixed_batched_fallback(A, B, X, info, iters,
                                          batched_mod.gesv_batched, nb)
    return X, info, iters


def posv_mixed_batched(A, B, nb=None, factor_dtype=None, max_iters: int = 30,
                       tol=None, fallback: bool = True, device="cuda"):
    """Batched mixed-precision Hermitian positive definite solve (lower
    storage) → (X, info (B,), iters (B,)); the refinement and fallback as
    ``gesv_mixed_batched``'s, the fallback by ``posv_batched``."""
    factor_dtype = _mixed_batched_factor_dtype(A, factor_dtype,
                                               "posv_mixed_batched")
    X, info, iters = batched_mod.posv_mixed_batched(
        A, B, nb, factor_dtype=factor_dtype, max_iters=max_iters, tol=tol,
        device=device)
    if fallback:
        X, info = _mixed_batched_fallback(A, B, X, info, iters,
                                          batched_mod.posv_batched, nb)
    return X, info, iters


# ---------------------------------------------------------------------------
# mixed-precision solves: (X, info, iters), iters < 0 when the
# full-precision fallback answered; the factor type defaults to float32
# ---------------------------------------------------------------------------

def gesv_mixed(A: TiledMatrix, B: TiledMatrix,
               opts: Options = DEFAULT_OPTIONS, factor_dtype=None):
    """A·X = B with a low-precision LU factor and iterative refinement in
    the working precision."""
    return lu_mod.gesv_mixed(A, B, opts, factor_dtype=factor_dtype
                             or torch.float32)


def posv_mixed(A: TiledMatrix, B: TiledMatrix,
               opts: Options = DEFAULT_OPTIONS, factor_dtype=None):
    """Hermitian positive definite mixed-precision solve."""
    return cholesky.posv_mixed(A, B, opts, factor_dtype=factor_dtype
                               or torch.float32)


def gesv_mixed_gmres(A: TiledMatrix, B: TiledMatrix,
                     opts: Options = DEFAULT_OPTIONS, factor_dtype=None):
    """GMRES-IR solve: a low-precision LU as the preconditioner, FGMRES in
    the working precision."""
    return gmres_mod.gesv_mixed_gmres(A, B, opts, factor_dtype=factor_dtype
                                      or torch.float32)


def posv_mixed_gmres(A: TiledMatrix, B: TiledMatrix,
                     opts: Options = DEFAULT_OPTIONS, factor_dtype=None):
    """GMRES-IR Hermitian positive definite solve: a low-precision
    Cholesky preconditioner, FGMRES refinement."""
    return gmres_mod.posv_mixed_gmres(A, B, opts, factor_dtype=factor_dtype
                                      or torch.float32)
