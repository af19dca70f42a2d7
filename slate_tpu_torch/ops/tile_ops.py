"""Tile-level helpers (counterpart of ``slate_tpu/ops/tile_ops.py``)."""

from __future__ import annotations

import torch


def realify_diag(a: torch.Tensor) -> torch.Tensor:
    """zpotrf contract: the imaginary parts of the diagonal are taken as
    zero. Writes the caller's working copy in place; no-op for real
    dtypes."""
    if a.is_complex():
        a.diagonal().imag.zero_()
    return a
