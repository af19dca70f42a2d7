"""LU family: getrf (partial pivot), getrs, gesv (counterpart of
``slate_tpu/linalg/lu.py:52-425, 672-717``).

Pivots are a gather permutation: ``A[perm] = L·U``. The reference's
default round-6/7 path is the one path here: the pivot-fused iterative
loop (the row permutation folded into the trailing update's row reads,
stored L columns reordered once at the end by composed suffix
permutations) in the lookahead-1 order, with pow2-bucketed panel
heights; the 2×2 width recursion runs only where the iterative loop
does not apply (more than ``ITER_MAX_NT`` block columns). The
reference's ``Options.lookahead``, ``lu_pivot_fusion`` and
``factor_iter_large`` select its other arms; the port accepts and
ignores them. Each call clones the operand ONCE into a working copy;
the reference's functional updates are in-place slice writes on it.

Padding: padded rows/cols carry an identity diagonal (``unit_pad_diag``,
the reference's ``_pad_identity_diag``), so the padded system is
[[A, 0], [0, I]] and a padded row never wins a pivot for a logical
column (it is zero there).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense, unit_pad_diag
from ..core.types import MethodLU, Options, DEFAULT_OPTIONS
from ..ops import blocked

_GETRF_ITER_BASE = 2048
_ITER_MAX_NT = blocked.ITER_MAX_NT


def _iter_eligible(w: int, nb: int) -> bool:
    return w % nb == 0 and w // nb <= _ITER_MAX_NT


def _bucketed_panel(panel: torch.Tensor, nb: int):
    """Pivoted factorization of an (rows × w) panel at its pow2 height
    bucket (zero rows appended below) → (lu, perm, info) cut to rows."""
    rows, w = panel.shape
    hb = blocked.bucket_pow2(rows, nb)
    if hb > rows:
        panel = torch.cat([panel, panel.new_zeros((hb - rows, w))])
    lu, perm, info = blocked.panel_getrf(panel)
    return lu[:rows], perm[:rows], info


def _getrf_rec(a: torch.Tensor, nb: int):
    """Recursive blocked partial-pivot LU of an (M × W) block, W ≤ M
    (returns new tensors: lu, perm, info)."""
    m, w = a.shape
    if w <= nb:
        return _bucketed_panel(a, nb)
    if w <= _GETRF_ITER_BASE and w % nb == 0 and w // nb <= _ITER_MAX_NT:
        return _getrf_iter(a.clone(), nb)
    h = blocked._half(w, nb)
    lu1, p1, i1 = _getrf_rec(a[:, :h], nb)
    right = a[:, h:].index_select(0, p1)
    u_top = blocked.trsm_rec(lu1[:h, :h], right[:h], left=True, lower=True,
                             unit=True, base=min(nb, h))
    schur = right[h:] - lu1[h:, :h] @ u_top
    lu2, p2, i2 = _getrf_rec(schur, nb)
    lu = torch.empty_like(a)
    lu[:h, :h] = lu1[:h]
    lu[:h, h:] = u_top
    lu[h:, :h] = lu1[h:, :h].index_select(0, p2)
    lu[h:, h:] = lu2
    perm = blocked._compose_tail(p1, p2, h)
    info = torch.where(i1 > 0, i1, torch.where(i2 > 0, i2 + h, 0))
    return lu, perm, info.to(torch.int32)


def _lift(p: torch.Tensor, h: int, m: int) -> torch.Tensor:
    """The length-m gather perm [0..h) ++ (h + p)."""
    head = torch.arange(h, dtype=p.dtype, device=p.device)
    return torch.cat([head, p + h]) if h < m else head


def _suffix_perms(pps: List[torch.Tensor], m: int, nb: int):
    """σⱼ = q_{j+1}∘…∘q_{nt−1} for every step j, as gather perms (q_k
    is step k's local perm lifted to the full index space)."""
    nt = len(pps)
    sigmas = [None] * nt
    sig = torch.arange(m, dtype=torch.int32, device=pps[0].device)
    for j in range(nt - 2, -1, -1):
        sig = _lift(pps[j + 1], (j + 1) * nb, m).index_select(0, sig)
        sigmas[j] = sig
    return sigmas


def _apply_deferred_left_swaps(a: torch.Tensor, pps, nb: int) -> torch.Tensor:
    """Reorder each stored L column block once by its composed suffix
    permutation, in place (rows above (j+1)·nb are fixed by σⱼ)."""
    for j, sig in enumerate(_suffix_perms(pps, a.shape[0], nb)):
        if sig is None:
            continue
        j0, j1 = j * nb, (j + 1) * nb
        a[j1:, j0:j1] = a[:, j0:j1].index_select(0, sig[j1:])
    return a


def _getrf_iter(a: torch.Tensor, nb: int):
    """Iterative right-looking blocked partial-pivot LU, IN PLACE on
    ``a``, in the reference's lookahead-1 order: at step k the next-panel
    slab is updated first, panel k+1 is factored from it, then the
    remaining slabs. Row swaps are fused into the trailing update's row
    reads; the stored L columns are reordered once at the end. Returns
    (a, perm, info)."""
    m, w = a.shape
    nt = w // nb
    perm = torch.arange(m, dtype=torch.int32, device=a.device)
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    pps = []

    def trail(k0, p_p, lu_p, inv11, lo, hi):
        # one nb-wide column slab at a time: U12 from the pivot rows,
        # Schur complement from the other rows, both gathered on read
        k1 = k0 + nb
        for j0 in range(lo, hi, nb):
            blk = a[k0:, j0:j0 + nb]
            u12 = inv11 @ blk.index_select(0, p_p[:nb])
            schur = blk.index_select(0, p_p[nb:]) - lu_p[nb:] @ u12
            a[k0:k1, j0:j0 + nb] = u12
            a[k1:, j0:j0 + nb] = schur

    ahead = None
    for k in range(nt):
        k0, k1 = k * nb, (k + 1) * nb
        if ahead is None:
            lu_p, p_p, i_p = _bucketed_panel(a[k0:, k0:k1], nb)
        else:
            (lu_p, p_p, i_p), ahead = ahead, None
        info = torch.where((info == 0) & (i_p > 0), i_p + k0, info)
        perm[k0:] = perm[k0:].index_select(0, p_p)
        pps.append(p_p)
        a[k0:, k0:k1] = lu_p
        if k1 >= w:
            continue
        l11 = torch.tril(lu_p[:nb], -1)
        l11.diagonal().fill_(1)
        inv11 = blocked.trtri_lower_batched(l11, unit=True)
        lo = k1
        if k1 + nb < w:
            trail(k0, p_p, lu_p, inv11, k1, k1 + nb)
            ahead = _bucketed_panel(a[k1:, k1:k1 + nb], nb)
            lo = k1 + nb
        trail(k0, p_p, lu_p, inv11, lo, w)
    _apply_deferred_left_swaps(a, pps, nb)
    return a, perm, info.to(torch.int32)


def _getrf_blocked(a: torch.Tensor, nb: int):
    """Blocked partial-pivot LU of the padded working copy (possibly
    rectangular): the iterative loop for every width with nt ≤
    ITER_MAX_NT, else the width recursion; a wide matrix's remaining U
    columns get one block solve."""
    m, n = a.shape
    k = min(m, n)
    if _iter_eligible(k, nb):
        lu, perm, info = _getrf_iter(a[:, :k], nb)
    else:
        lu, perm, info = _getrf_rec(a[:, :k], nb)
        a[:, :k] = lu
    if n > k:
        rest = a[:, k:].index_select(0, perm)
        a[:, k:] = blocked.trsm_rec(a[:, :k], rest, left=True, lower=True,
                                    unit=True, base=nb)
    return a, perm, info


def _check_method(opts: Options, what: str):
    if opts.method_lu in (MethodLU.NoPiv, MethodLU.CALU, MethodLU.RBT):
        raise NotImplementedError(
            f"{what}: MethodLU.{opts.method_lu.name} is not ported yet "
            "(ROADMAP Queue 1 item 3)")
    if opts.pivot_threshold < 1.0:
        raise NotImplementedError(
            f"{what}: pivot_threshold < 1 (tournament pivoting) is not "
            "ported yet (ROADMAP Queue 1 item 3)")


@accurate_matmuls
def getrf(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS
          ) -> Tuple[TiledMatrix, torch.Tensor, torch.Tensor]:
    """Partial-pivot LU: A[perm] = L·U. Returns (LU packed in one
    matrix, perm int32, info 0-d int32: 1-based first zero pivot)."""
    _check_method(opts, "getrf")
    m, n = A.shape
    # the one working copy of this call: every update below writes it
    a = A.dense_canonical().clone(memory_format=torch.contiguous_format)
    a = unit_pad_diag(a.resolve_conj(), m, n)
    lu, perm, info = _getrf_blocked(a, A.nb)
    out = from_dense(lu, A.nb, logical_shape=(m, n), device=lu.device)
    return out, perm, info


@accurate_matmuls
def getrs(LU: TiledMatrix, perm: torch.Tensor, B: TiledMatrix,
          opts: Options = DEFAULT_OPTIONS, trans: bool = False
          ) -> TiledMatrix:
    """Solve A·X = B (or Aᵀ·X = B) from getrf factors: permute rows,
    unit-lower solve, upper solve. The factor is read in place; only
    when it has padding is a copy with a unit padded diagonal taken."""
    lu = LU.dense_canonical()
    if LU.shape != tuple(lu.shape):
        lu = unit_pad_diag(lu.clone(), *LU.shape)
    b = B.dense_canonical()
    if b.shape[0] != lu.shape[0]:
        raise SlateError("getrs: rhs rows do not match the factor")
    if not trans:
        y = blocked.trsm_rec(lu, b.index_select(0, perm), left=True,
                             lower=True, unit=True, base=LU.nb)
        x = blocked.trsm_rec(lu, y, left=True, lower=False, unit=False,
                             base=LU.nb)
    else:
        z = blocked.trsm_rec(lu, b, left=True, lower=False, unit=False,
                             trans_a=True, base=LU.nb)
        w = blocked.trsm_rec(lu, z, left=True, lower=True, unit=True,
                             trans_a=True, base=LU.nb)
        x = torch.empty_like(w).index_copy_(0, perm.long(), w)
    return from_dense(x, B.nb, logical_shape=B.shape, device=x.device)


def gesv(A: TiledMatrix, B: TiledMatrix, opts: Options = DEFAULT_OPTIONS
         ) -> Tuple[TiledMatrix, torch.Tensor]:
    """Solve A·X = B (getrf + getrs)."""
    _check_method(opts, "gesv")
    LU, perm, info = getrf(A, opts)
    return getrs(LU, perm, B, opts), info
