"""Simplified API verbs of the ported slices (counterpart of
``slate_tpu/api.py:38-105``, ``119-289`` and the batched verbs at
``320-359``, no tracing spans): the BLAS-3 verbs dispatch on the matrix
kinds as the reference does; the inverse verbs run getri and potri; the
batched verbs take (B, m, n) stacks (``linalg/batched.py``)."""

from __future__ import annotations

from .core.tiled_matrix import TiledMatrix
from .core.types import MatrixKind, Options, Side, DEFAULT_OPTIONS
from .linalg import batched as batched_mod, blas3, cholesky, lu as lu_mod
from .linalg import qr as qr_mod


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
