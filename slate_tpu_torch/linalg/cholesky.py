"""Cholesky family: potrf, potrs, posv, the inverse verbs trtri, trtrm
and potri, and the mixed-precision posv_mixed (counterpart of
``slate_tpu/linalg/cholesky.py:60-426``).

The blocked right-looking loop in its lookahead-1 order is the
reference's default path; the 2×2 recursion runs only where that loop
does not apply (more than ``ITER_MAX_NT`` block columns). The reference's
``Options.lookahead`` and ``factor_iter_large`` select its other arms;
the port accepts and ignores them. Two differences of form:

- each call clones the operand ONCE into a working copy and every
  functional update of the reference (``dus_i32``) is an in-place slice
  write on that copy;
- the per-tile failure test does not sync the host per tile. Each tile
  factor leaves a device-side flag (NaN on its diagonal) and keeps its
  input tile; ``info`` is resolved once after the loop, by running the
  exact LAPACK-style scan (``_chol_info_scan``) on the first failed
  tile only — the value the reference's per-tile ``lax.cond`` gives.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense, unit_pad_diag
from ..core.types import (Diag, MatrixKind, Norm, Options, Side, Uplo,
                          DEFAULT_OPTIONS)
from ..ops import blocked, tile_ops
from . import blas3

_POTRF_ITER_BASE = 2048
_ITER_MAX_NT = blocked.ITER_MAX_NT


def _chol_info_scan(a: torch.Tensor) -> torch.Tensor:
    """1-based index of the first non-positive leading minor of one tile
    (0 if none), by an unblocked recurrence over its lower triangle."""
    nbb = a.shape[0]
    mat = a.clone()
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    one = torch.ones((), dtype=mat.real.dtype, device=a.device)
    for i in range(nbb):
        d = mat[i, i].real
        bad = torch.isnan(d) | (d <= 0)
        info = torch.where((info == 0) & bad,
                           torch.full_like(info, i + 1), info)
        col = mat[i + 1:, i] / torch.where(bad, one, d).sqrt()
        mat[i + 1:, i + 1:] -= torch.outer(col, col.conj())
    return info


class _TileFlags:
    """Per-tile failure flags of one factorization, kept on the device:
    (row offset, flag tensor, the tile's input). ``resolve`` syncs once."""

    def __init__(self):
        self.items: List[Tuple[int, torch.Tensor, torch.Tensor]] = []

    def extend(self, other: "_TileFlags", shift: int):
        self.items += [(off + shift, f, t) for off, f, t in other.items]

    def resolve(self, device) -> torch.Tensor:
        zero = torch.zeros((), dtype=torch.int32, device=device)
        if not self.items:
            return zero
        flags = torch.stack([f for _, f, _ in self.items]).cpu()
        for (off, _, akk), failed in zip(self.items, flags.tolist()):
            if failed:
                return _chol_info_scan(akk) + off
        return zero


def _tile_chol(akk: torch.Tensor, flags: _TileFlags, offset: int
               ) -> torch.Tensor:
    """Factor one diagonal tile (the K1 kernel on the card) and record
    its failure flag; the input tile is kept for the info scan."""
    akk = akk.clone(memory_format=torch.contiguous_format)
    lkk = blocked.chol_tile_blocked(akk)
    flags.items.append((offset, torch.isnan(lkk.diagonal()).any(), akk))
    return lkk


def _iter_eligible(s: int, nb: int) -> bool:
    return s > nb and s % nb == 0 and s // nb <= _ITER_MAX_NT


def _potrf_iter(a: torch.Tensor, nb: int):
    """Iterative right-looking blocked Cholesky, IN PLACE on ``a``, as
    the reference's lookahead-1 pipeline: at step k the trailing update
    writes the next-panel slab first, panel k+1's tile is factored from
    it, then the remainder slabs follow. Returns (a with garbage above
    the diagonal, flags)."""
    s = a.shape[0]
    nt = s // nb
    flags = _TileFlags()
    ahead = None
    for k in range(nt):
        k0, k1 = k * nb, (k + 1) * nb
        if ahead is None:
            lkk = _tile_chol(a[k0:k1, k0:k1], flags, k0)
        else:
            lkk, ahead = ahead, None
        a[k0:k1, k0:k1] = lkk
        if k1 >= s:
            continue
        inv = blocked.trtri_lower_batched(lkk)
        pan = a[k1:, k0:k1] @ inv.mH
        a[k1:, k0:k1] = pan
        blocked.herk_trailing_inplace(a, pan, k1, nb, j_stop=k1 + nb)
        ahead = _tile_chol(a[k1:k1 + nb, k1:k1 + nb], flags, k1)
        blocked.herk_trailing_inplace(a, pan, k1, nb, j_start=k1 + nb)
    return a, flags


def _potrf_rec(a: torch.Tensor, nb: int):
    """Recursive blocked Cholesky, writing the factor into ``a`` IN
    PLACE (garbage above the diagonal). Returns (a, flags)."""
    s = a.shape[0]
    if s <= nb:
        flags = _TileFlags()
        a.copy_(_tile_chol(a, flags, 0))
        return a, flags
    if s <= _POTRF_ITER_BASE and s % nb == 0 and s // nb <= _ITER_MAX_NT:
        return _potrf_iter(a, nb)
    h = blocked._half(s, nb)
    _, flags = _potrf_rec(a[:h, :h], nb)
    a[h:, :h] = blocked.trsm_rec(a[:h, :h], a[h:, :h], left=False,
                                 lower=True, conj_a=True, trans_a=True,
                                 base=nb)
    # real dtypes: K5 updates the view a[h:, h:] in place and returns it
    a22 = blocked.herk_lower_rec(a[h:, h:], a[h:, :h])
    _, f2 = _potrf_rec(a22, nb)
    if a22.data_ptr() != a[h:, h:].data_ptr():  # the complex recursion's copy
        a[h:, h:] = a22
    flags.extend(f2, h)
    return a, flags


def _potrf_blocked(a: torch.Tensor, nb: int):
    """Blocked Cholesky of the padded working copy → (tril factor, info).
    The in-place iterative loop owns every size with nt ≤ ITER_MAX_NT;
    otherwise the 2×2 recursion."""
    if _iter_eligible(a.shape[0], nb):
        out, flags = _potrf_iter(a, nb)
    else:
        out, flags = _potrf_rec(a, nb)
    return out.tril_(), flags.resolve(a.device)


@accurate_matmuls
def potrf(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS
          ) -> Tuple[TiledMatrix, torch.Tensor]:
    """Cholesky factorization A = L·Lᴴ (Lower) or UᴴU (Upper).

    Reads only the stored triangle (Upper storage is conjugate-
    transposed into the working copy). Returns (triangular factor,
    info): info is a 0-d int32 device tensor, 0 on success, k > 0 when
    the leading minor k is not positive definite."""
    if A.kind not in (MatrixKind.Hermitian, MatrixKind.Symmetric):
        raise SlateError("potrf: A must be Hermitian/Symmetric (use "
                         "slate_tpu_torch.hermitian)")
    if A.shape[0] != A.shape[1]:
        raise SlateError("potrf: A must be square")
    n, nb = A.shape[0], A.nb
    src = A.dense_canonical()
    if A.uplo is Uplo.Upper:
        src = src.mH
    # the one working copy of this call: every update below writes it
    a = src.clone(memory_format=torch.contiguous_format).resolve_conj()
    tile_ops.realify_diag(a)
    unit_pad_diag(a, n, n)
    lower, info = _potrf_blocked(a, nb)
    if A.uplo is Uplo.Upper:
        out = from_dense(lower.mH.contiguous(), nb,
                         kind=MatrixKind.Triangular, uplo=Uplo.Upper,
                         logical_shape=(n, n), device=lower.device)
    else:
        out = from_dense(lower, nb, kind=MatrixKind.Triangular,
                         uplo=Uplo.Lower, logical_shape=(n, n),
                         device=lower.device)
    return out, info


@accurate_matmuls
def potrs(L: TiledMatrix, B: TiledMatrix,
          opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """Solve A·X = B given the Cholesky factor (two triangular solves)."""
    if L.kind is not MatrixKind.Triangular:
        raise SlateError("potrs: L must be the factor from potrf")
    if L.uplo is Uplo.Lower:
        y = blas3.trsm(Side.Left, 1.0, L, B, opts)
        return blas3.trsm(Side.Left, 1.0, L.H, y, opts)
    y = blas3.trsm(Side.Left, 1.0, L.H, B, opts)
    return blas3.trsm(Side.Left, 1.0, L, y, opts)


def posv(A: TiledMatrix, B: TiledMatrix,
         opts: Options = DEFAULT_OPTIONS) -> Tuple[TiledMatrix, torch.Tensor]:
    """Solve A·X = B for Hermitian positive definite A."""
    L, info = potrf(A, opts)
    return potrs(L, B, opts), info


@accurate_matmuls
def trtri(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """Triangular inverse of a Triangular A, lower or upper, unit or not.

    The padded triangle (the other one zeroed, 1 on a padded diagonal) is
    inverted by ``blocked.trtri_rec``: its diagonal leaves of at most 64
    rows are P1 launches, combined by batched gemms (the one inversion
    path of the port; the reference solves against I with
    ``lax.linalg.triangular_solve``). TriangularBand raises until band
    kinds are ported."""
    if A.kind not in (MatrixKind.Triangular, MatrixKind.TriangularBand):
        raise SlateError("trtri: A must be triangular")
    n = A.shape[0]
    a = unit_pad_diag(A.full_dense_canonical(), n, n)
    inv = blocked.trtri_rec(a, lower=A.uplo is Uplo.Lower,
                            unit=A.diag is Diag.Unit)
    return from_dense(inv, A.nb, kind=MatrixKind.Triangular, uplo=A.uplo,
                      diag=A.diag, logical_shape=A.shape, device=inv.device)


@accurate_matmuls
def trtrm(L: TiledMatrix, opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """Lᴴ·L (Lower) or U·Uᴴ (Upper) of a triangular matrix, one gemm: the
    second half of potri."""
    a = L.full_dense_canonical()
    out = a.mH @ a if L.uplo is Uplo.Lower else a @ a.mH
    return from_dense(out, L.nb, kind=MatrixKind.Hermitian, uplo=L.uplo,
                      logical_shape=L.shape, device=out.device)


def potri(A_factor: TiledMatrix, opts: Options = DEFAULT_OPTIONS
          ) -> TiledMatrix:
    """A⁻¹ from the Cholesky factor: L⁻ᴴ·L⁻¹ (trtri, then trtrm)."""
    return trtrm(trtri(A_factor, opts), opts)


# ---------------------------------------------------------------------------
# mixed precision
# ---------------------------------------------------------------------------

@accurate_matmuls
def posv_mixed(A: TiledMatrix, B: TiledMatrix,
               opts: Options = DEFAULT_OPTIONS, factor_dtype=torch.float32
               ) -> Tuple[TiledMatrix, torch.Tensor, int]:
    """Mixed-precision posv with iterative refinement (slate::posv_mixed,
    src/posv_mixed.cc:23-77; the reference's ``linalg/cholesky.py:
    381-426``): potrf of A cast to ``factor_dtype``, then R = B − A·X by
    hemm (or symm) in the working precision and X += potrs(R) until
    ‖R‖∞ ≤ ‖X‖∞·‖A‖∞·ε·√n, at most ``opts.max_iterations`` steps.
    Returns (X, info, iters); iters < 0: the full-precision posv answered
    (under ``opts.use_fallback_solver``)."""
    from . import elementwise as ew
    from .norms import norm
    if A.dtype == factor_dtype:
        X, info = posv(A, B, opts)
        return X, info, 0
    work = A.dtype
    L_lo, info = potrf(ew.copy(A, dtype=factor_dtype), opts)
    cte = norm(A, Norm.Inf) * torch.finfo(work).eps * math.sqrt(A.shape[0])
    residual = blas3.hemm if A.kind is MatrixKind.Hermitian else blas3.symm

    def lo_solve(R: TiledMatrix) -> TiledMatrix:
        return ew.copy(potrs(L_lo, ew.copy(R, dtype=factor_dtype), opts),
                       dtype=work)

    X = lo_solve(B)
    converged = False
    iters = 0
    for it in range(opts.max_iterations):
        iters = it + 1
        R = residual(Side.Left, -1.0, A, X, 1.0, B, opts)
        if bool(norm(R, Norm.Inf) <= norm(X, Norm.Inf) * cte):
            converged = True
            break
        X = ew.add(1.0, lo_solve(R), 1.0, X, opts)
    if not converged and opts.use_fallback_solver:
        X, info = posv(A, B, opts)
        return X, info, -iters
    return X, info, iters
