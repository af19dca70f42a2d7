"""Elementwise and auxiliary drivers (counterpart of
``slate_tpu/linalg/elementwise.py``): add, copy, scale, scale_row_col,
set_matrix and set_lambda, each one expression over the padded storage.
Every result is a new matrix whose padding is zero. ``redistribute``
raises until process grids are ported."""

from __future__ import annotations

import torch

from ..core.exceptions import SlateError
from ..core.tiled_matrix import TiledMatrix, as_tensor, from_dense, pad_mask
from ..core.types import MatrixKind, Options, DEFAULT_OPTIONS


def _like(A: TiledMatrix, data: torch.Tensor, kind=None) -> TiledMatrix:
    return from_dense(data, A.nb, kind=kind or A.kind, uplo=A.uplo,
                      diag=A.diag, logical_shape=A.shape, device=data.device)


def add(alpha, A: TiledMatrix, beta, B: TiledMatrix,
        opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """α·A + β·B, shaped like B."""
    if A.shape != B.shape:
        raise SlateError("add: shape mismatch")
    return _like(B, alpha * A.dense_canonical() + beta * B.dense_canonical())


def copy(A: TiledMatrix, dtype=None, kind: MatrixKind = None) -> TiledMatrix:
    """A copy of A, converted to ``dtype`` (a torch dtype) if given."""
    data = A.dense_canonical().to(dtype or A.dtype, copy=True,
                                  memory_format=torch.contiguous_format)
    return _like(A, data, kind)


def scale(numer, denom, A: TiledMatrix,
          opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """(numer/denom)·A."""
    return _like(A, A.dense_canonical() * (numer / denom))


def _padded_vector(v, n: int, like: torch.Tensor) -> torch.Tensor:
    out = torch.ones(n, dtype=like.dtype, device=like.device)
    v = as_tensor(v, like.device).to(like.dtype)
    out[: v.shape[0]] = v
    return out


def scale_row_col(R, C, A: TiledMatrix,
                  opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """A[i, j] ← r[i]·c[j]·A[i, j] (equilibration)."""
    a = A.dense_canonical()
    r = _padded_vector(R, a.shape[0], a)
    c = _padded_vector(C, a.shape[1], a)
    return _like(A, a * r[:, None] * c[None, :])


def set_matrix(offdiag, diag_, A: TiledMatrix,
               opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """``offdiag`` on every logical entry, ``diag_`` on the logical
    diagonal; the padding stays zero."""
    out = torch.full_like(A.dense_canonical(), offdiag)
    out.masked_fill_(~pad_mask(A), 0)
    out.diagonal()[: min(A.shape)] = diag_
    return _like(A, out)


def set_lambda(fn, A: TiledMatrix) -> TiledMatrix:
    """A[i, j] ← fn(i, j), with ``fn`` applied once to broadcast index
    tensors (rows (M, 1), columns (1, N)); the padding stays zero."""
    a = A.dense_canonical()
    i = torch.arange(a.shape[0], device=a.device)[:, None]
    j = torch.arange(a.shape[1], device=a.device)[None, :]
    vals = torch.as_tensor(fn(i, j), device=a.device).to(a.dtype)
    return _like(A, torch.where(pad_mask(A), vals, 0))


def redistribute(A: TiledMatrix, grid, spec=None) -> TiledMatrix:
    raise NotImplementedError(
        "redistribute: process grids are not ported yet (ROADMAP Queue 1 "
        "item 12)")
