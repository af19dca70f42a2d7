"""BLAS-3 drivers (counterpart of ``slate_tpu/linalg/blas3.py``, single
device): gemm, symm, hemm, syrk, herk, syr2k, her2k, trmm and trsm.

Each is one plain product over the padded storage (cuBLAS on the card),
as the reference leaves them to XLA; the reference's GSPMD placement
constraints (``MethodGemm.A``/``C``, ``MethodHemm``) have nothing to
place on one device and are accepted as options. ``MethodGemm.SUMMA``
(an explicit multi-device schedule) raises. The band verbs (gbmm, hbmm,
tbsm) are a later slice.
"""

from __future__ import annotations

from ..core.exceptions import SlateError
from ..core.tiled_matrix import TiledMatrix, from_dense, unit_pad_diag
from ..core.types import (Diag, MatrixKind, MethodGemm, Options, Side, Uplo,
                          DEFAULT_OPTIONS)
from ..ops import blocked, tile_ops


def _wrap_like(c: TiledMatrix, data) -> TiledMatrix:
    """Repackage a canonical padded result as a matrix like ``c``."""
    return from_dense(data, c.nb, kind=c.kind, uplo=c.uplo, diag=c.diag,
                      logical_shape=c.shape, device=data.device)


def gemm(alpha, A: TiledMatrix, B: TiledMatrix, beta, C: TiledMatrix,
         opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """C ← α·op(A)·op(B) + β·C (returns a new matrix)."""
    (am, an), (bm, bn), (cm, cn) = A.shape, B.shape, C.shape
    if an != bm or am != cm or bn != cn:
        raise SlateError(f"gemm dimension mismatch: ({am}x{an})·({bm}x{bn})"
                         f" -> ({cm}x{cn})")
    if opts.method_gemm is MethodGemm.SUMMA:
        raise NotImplementedError(
            "gemm: MethodGemm.SUMMA is a multi-device schedule, not ported "
            "yet (ROADMAP Queue 1 item 12)")
    out = alpha * (A.dense_canonical() @ B.dense_canonical()) \
        + beta * C.dense_canonical()
    return _wrap_like(C, out)


def _side_product(side: Side, alpha, a, b, beta, c):
    return (alpha * (a @ b) if side is Side.Left else alpha * (b @ a)) \
        + beta * c


def symm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix, beta,
         C: TiledMatrix, opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """C ← α·A·B + β·C (Left) or α·B·A + β·C (Right), A symmetric."""
    if A.kind not in (MatrixKind.Symmetric, MatrixKind.Hermitian):
        raise SlateError("symm: A must be symmetric")
    return _wrap_like(C, _side_product(
        side, alpha, A.full_dense_canonical(), B.dense_canonical(), beta,
        C.dense_canonical()))


def hemm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix, beta,
         C: TiledMatrix, opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """C ← α·A·B + β·C (Left) or α·B·A + β·C (Right), A Hermitian."""
    if A.kind is not MatrixKind.Hermitian:
        raise SlateError("hemm: A must be Hermitian")
    return _wrap_like(C, _side_product(
        side, alpha, A.full_dense_canonical(), B.dense_canonical(), beta,
        C.dense_canonical()))


def syrk(alpha, A: TiledMatrix, beta, C: TiledMatrix,
         opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """C ← α·op(A)·op(A)ᵀ + β·C on C's stored triangle, C symmetric."""
    if C.kind is not MatrixKind.Symmetric:
        raise SlateError("syrk: C must be symmetric")
    return _wrap_like(C, tile_ops.syrk(alpha, A.dense_canonical(), beta,
                                       C.dense_canonical(), uplo=C.uplo))


def herk(alpha, A: TiledMatrix, beta, C: TiledMatrix,
         opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """C ← α·op(A)·op(A)ᴴ + β·C on C's stored triangle, C Hermitian."""
    if C.kind is not MatrixKind.Hermitian:
        raise SlateError("herk: C must be Hermitian")
    return _wrap_like(C, tile_ops.herk(alpha, A.dense_canonical(), beta,
                                       C.dense_canonical(), uplo=C.uplo))


def syr2k(alpha, A: TiledMatrix, B: TiledMatrix, beta, C: TiledMatrix,
          opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """C ← α·A·Bᵀ + α·B·Aᵀ + β·C on C's stored triangle, C symmetric."""
    if C.kind is not MatrixKind.Symmetric:
        raise SlateError("syr2k: C must be symmetric")
    return _wrap_like(C, tile_ops.syr2k(
        alpha, A.dense_canonical(), B.dense_canonical(), beta,
        C.dense_canonical(), uplo=C.uplo))


def her2k(alpha, A: TiledMatrix, B: TiledMatrix, beta, C: TiledMatrix,
          opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """C ← α·A·Bᴴ + ᾱ·B·Aᴴ + β·C on C's stored triangle, C Hermitian."""
    if C.kind is not MatrixKind.Hermitian:
        raise SlateError("her2k: C must be Hermitian")
    return _wrap_like(C, tile_ops.her2k(
        alpha, A.dense_canonical(), B.dense_canonical(), beta,
        C.dense_canonical(), uplo=C.uplo))


def trmm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix,
         opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """B ← α·op(A)·B (Left) or α·B·op(A) (Right), A triangular."""
    if A.kind is not MatrixKind.Triangular:
        raise SlateError("trmm: A must be triangular")
    a, b = A.full_dense_canonical(), B.dense_canonical()
    return _wrap_like(B, alpha * (a @ b) if side is Side.Left
                      else alpha * (b @ a))


def trsm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix,
         opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """Solve op(A)·X = α·B (Left) or X·op(A) = α·B for X, A triangular.

    One path for every ``MethodTrsm``: the gemm-based block recursion
    (``blocked.trsm_rec``), which the factorizations' solves run too.
    ``opts.method_trsm`` is accepted and ignored (see ``Options``).

    The recursion reads only A's stored triangle (and not its diagonal
    when ``Diag.Unit``), so A's storage is used as it is, without the
    masked copy the reference makes (``full_dense_canonical``). Only when
    A has padding is a copy taken, whose padded diagonal is set to 1 so
    the padding solves to zero."""
    if A.kind is not MatrixKind.Triangular:
        raise SlateError("trsm: A must be triangular")
    if A.uplo is Uplo.General:
        raise SlateError("trsm: A must have uplo Lower/Upper")
    a = A.dense_canonical()
    if A.shape[0] < a.shape[0] or A.shape[1] < a.shape[1]:
        a = unit_pad_diag(a.clone(), A.shape[0], A.shape[1])
    b = B.dense_canonical()
    rhs = b if alpha == 1 else alpha * b
    x = blocked.trsm_rec(a, rhs, left=(side is Side.Left),
                         lower=A.uplo is Uplo.Lower, unit=A.diag is Diag.Unit,
                         base=min(A.nb, a.shape[0]))
    return _wrap_like(B, x)
