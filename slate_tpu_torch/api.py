"""Simplified API verbs of the ported slices (counterpart of
``slate_tpu/api.py:119-289``, dense operands only, no tracing spans)."""

from __future__ import annotations

from .core.tiled_matrix import TiledMatrix
from .core.types import Options, DEFAULT_OPTIONS
from .linalg import cholesky, lu as lu_mod, qr as qr_mod


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
