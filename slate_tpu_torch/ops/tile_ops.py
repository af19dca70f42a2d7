"""Tile-level helpers (counterpart of ``slate_tpu/ops/tile_ops.py``): the
rank-k and rank-2k updates are plain products (cuBLAS on the card), as
the reference leaves them to XLA."""

from __future__ import annotations

import torch

from ..core.types import Uplo


def realify_diag(a: torch.Tensor) -> torch.Tensor:
    """zpotrf contract: the imaginary parts of the diagonal are taken as
    zero. Writes the caller's working copy in place; no-op for real
    dtypes."""
    if a.is_complex():
        a.diagonal().imag.zero_()
    return a


def syrk(alpha, a, beta, c, uplo: Uplo = Uplo.Lower):
    out = alpha * (a @ a.mT) + beta * c
    return _keep_triangle(out, c, uplo)


def herk(alpha, a, beta, c, uplo: Uplo = Uplo.Lower):
    out = alpha * (a @ a.mH) + beta * c
    return _keep_triangle(out, c, uplo)


def syr2k(alpha, a, b, beta, c, uplo: Uplo = Uplo.Lower):
    out = alpha * (a @ b.mT) + alpha * (b @ a.mT) + beta * c
    return _keep_triangle(out, c, uplo)


def her2k(alpha, a, b, beta, c, uplo: Uplo = Uplo.Lower):
    conj_alpha = alpha.conj() if torch.is_tensor(alpha) else alpha.conjugate()
    out = alpha * (a @ b.mH) + conj_alpha * (b @ a.mH) + beta * c
    return _keep_triangle(out, c, uplo)


def _keep_triangle(out, orig, uplo: Uplo):
    """syrk/herk only update one triangle; keep the other from orig."""
    if uplo is Uplo.Lower:
        return torch.tril(out) + torch.triu(orig, 1)
    return torch.triu(out) + torch.tril(orig, -1)
