"""Simplified API verbs of the slice (counterpart of
``slate_tpu/api.py:119-220``, dense operands only, no tracing spans)."""

from __future__ import annotations

from .core.tiled_matrix import TiledMatrix
from .core.types import Options, DEFAULT_OPTIONS
from .linalg import cholesky, lu as lu_mod


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
