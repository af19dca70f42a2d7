"""Matrix norms (counterpart of ``slate_tpu/linalg/norms.py``): one masked
reduction over the padded storage, with the matrix kind's implicit
structure made explicit first (``full_dense``). NaN propagates: torch's
max returns NaN when any entry is NaN, and the Frobenius scaling selects
on isnan explicitly."""

from __future__ import annotations

import torch

from ..core.exceptions import SlateError
from ..core.tiled_matrix import TiledMatrix, pad_mask
from ..core.types import Norm, NormScope


def _abs_masked(A: TiledMatrix):
    a = A.full_dense()
    mask = pad_mask(A)
    return a, mask, torch.where(mask, a.abs(), 0.0)


def norm(A: TiledMatrix, kind: Norm = Norm.One,
         scope: NormScope = NormScope.Matrix) -> torch.Tensor:
    """‖A‖ for kind in {Max, One, Inf, Fro} as a 0-d tensor (Rows scope:
    the per-row sums, Columns scope: ``col_norms``); honours the matrix
    kind and ignores padding."""
    if scope is NormScope.Columns:
        return col_norms(A, kind)
    a, mask, absa = _abs_masked(A)
    if scope is NormScope.Rows:
        if kind is not Norm.Inf and kind is not Norm.One:
            raise SlateError("row scope supports One/Inf style sums")
        return absa.sum(dim=1)[: A.shape[0]]
    if kind is Norm.Max:
        return torch.where(mask, a.abs(), -torch.inf).max()
    if kind is Norm.One:
        return absa.sum(dim=0).max()
    if kind is Norm.Inf:
        return absa.sum(dim=1).max()
    if kind is Norm.Fro:
        # scaled sum of squares (LAPACK's lassq) against overflow; a NaN
        # amax fails amax > 0, so select on isnan explicitly
        amax = absa.max()
        safe = torch.where(amax > 0, amax, 1.0)
        ssq = ((absa / safe) ** 2).sum()
        return torch.where(torch.isnan(amax) | (amax > 0),
                           safe * ssq.sqrt(), 0.0)
    raise SlateError(f"unsupported norm {kind}")


def col_norms(A: TiledMatrix, kind: Norm = Norm.Max) -> torch.Tensor:
    """Per-column norms (the reference's colNorms, NormScope.Columns)."""
    _, _, absa = _abs_masked(A)
    if kind is Norm.Max:
        v = absa.max(dim=0).values
    elif kind is Norm.One:
        v = absa.sum(dim=0)
    elif kind is Norm.Fro:
        v = (absa * absa).sum(dim=0).sqrt()
    else:
        raise SlateError(f"unsupported column norm {kind}")
    return v[: A.shape[1]]
