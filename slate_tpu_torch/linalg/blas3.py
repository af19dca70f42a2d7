"""BLAS-3 routines the dense solves need (counterpart of
``slate_tpu/linalg/blas3.py``: ``trsm`` and ``gemm``, single device)."""

from __future__ import annotations

from ..core.exceptions import SlateError
from ..core.tiled_matrix import TiledMatrix, from_dense, unit_pad_diag
from ..core.types import (Diag, MatrixKind, Options, Side, Uplo,
                          DEFAULT_OPTIONS)
from ..ops import blocked


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
    out = alpha * (A.dense_canonical() @ B.dense_canonical()) \
        + beta * C.dense_canonical()
    return _wrap_like(C, out)


def trsm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix,
         opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """Solve op(A)·X = α·B (Left) or X·op(A) = α·B for X, A triangular,
    by the gemm-based block recursion (``blocked.trsm_rec``).

    ``trsm_rec`` reads only A's stored triangle (and not its diagonal
    when ``Diag.Unit``), so A's storage is used as it is, without the
    masked copy the reference makes (``full_dense_canonical``). Only
    when A has padding is a copy taken, whose padded diagonal is set to
    1 so the padding solves to zero."""
    if A.kind is not MatrixKind.Triangular:
        raise SlateError("trsm: A must be triangular")
    if A.uplo is Uplo.General:
        raise SlateError("trsm: A must have uplo Lower/Upper")
    a = A.dense_canonical()
    if A.shape[0] < a.shape[0] or A.shape[1] < a.shape[1]:
        a = unit_pad_diag(a.clone(), A.shape[0], A.shape[1])
    b = B.dense_canonical()
    x = blocked.trsm_rec(
        a, b if alpha == 1 else alpha * b,
        left=(side is Side.Left), lower=(A.uplo is Uplo.Lower),
        unit=(A.diag is Diag.Unit), base=min(A.nb, a.shape[0]))
    return _wrap_like(B, x)
