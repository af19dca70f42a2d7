"""LU family: getrf (partial pivot, threshold pivoting, no pivoting and
tournament pivoting), getrs, gesv, the no-pivot and butterfly solvers
(getrf_nopiv, gesv_nopiv, gerbt, gesv_rbt), CALU (getrf_tntpiv), the
inverse (getri, getri_oop) and the mixed-precision gesv_mixed
(counterpart of ``slate_tpu/linalg/lu.py:52-885``).

Pivots are a gather permutation: ``A[perm] = L·U``. The reference's
default round-6/7 path is the one path here: the pivot-fused iterative
loop (the row permutation folded into the trailing update's row reads,
stored L columns reordered once at the end by composed suffix
permutations) in the lookahead-1 order, with pow2-bucketed panel
heights; the 2×2 width recursion runs only where the iterative loop
does not apply (more than ``ITER_MAX_NT`` block columns). The
reference's ``Options.lookahead``, ``lu_pivot_fusion``,
``lu_tournament_batched`` and ``factor_iter_large`` select its other
arms; the port accepts and ignores them (its tournament runs the batched
rounds, one P3 launch each). Each call clones the operand ONCE into a
working copy; the reference's functional updates are in-place slice
writes on it.

Padding: padded rows/cols carry an identity diagonal (``unit_pad_diag``,
the reference's ``_pad_identity_diag``), so the padded system is
[[A, 0], [0, I]] and a padded row never wins a pivot for a logical
column (it is zero there).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense, unit_pad_diag
from ..core.types import MethodLU, Norm, Options, DEFAULT_OPTIONS
from ..ops import blocked, hopper_ops
from . import blas3, elementwise as ew
from .norms import norm

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


def _getrf_rec(a: torch.Tensor, nb: int, threshold: float = 1.0):
    """Recursive blocked partial-pivot LU of an (M × W) block, W ≤ M
    (returns new tensors: lu, perm, info). Under ``threshold`` < 1 a tall
    nb-wide base is a tournament panel (``_tournament_panel``)."""
    m, w = a.shape
    if w <= nb:
        if threshold < 1.0 and m > w:
            return _tournament_panel(a, w, nb, m)
        return _bucketed_panel(a, nb)
    if w <= _GETRF_ITER_BASE and w % nb == 0 and w // nb <= _ITER_MAX_NT:
        return _getrf_iter(a.clone(), nb, threshold)
    h = blocked._half(w, nb)
    lu1, p1, i1 = _getrf_rec(a[:, :h], nb, threshold)
    right = a[:, h:].index_select(0, p1)
    u_top = blocked.trsm_rec(lu1[:h, :h], right[:h], left=True, lower=True,
                             unit=True, base=min(nb, h))
    schur = right[h:] - lu1[h:, :h] @ u_top
    lu2, p2, i2 = _getrf_rec(schur, nb, threshold)
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


def _getrf_iter(a: torch.Tensor, nb: int, threshold: float = 1.0):
    """Iterative right-looking blocked partial-pivot LU, IN PLACE on
    ``a``, in the reference's lookahead-1 order: at step k the next-panel
    slab is updated first, panel k+1 is factored from it, then the
    remaining slabs. Row swaps are fused into the trailing update's row
    reads; the stored L columns are reordered once at the end. Under
    ``threshold`` < 1 (threshold pivoting) each panel is a tournament
    panel: the winners first (``_tournament_perm``), then the gathered
    panel eliminated without pivoting. Returns (a, perm, info)."""
    m, w = a.shape
    nt = w // nb
    perm = torch.arange(m, dtype=torch.int32, device=a.device)
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    pps = []

    def factor_panel(panel):
        if threshold < 1.0:
            return _tournament_panel(panel, nb, nb, panel.shape[0], m)
        return _bucketed_panel(panel, nb)

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
            lu_p, p_p, i_p = factor_panel(a[k0:, k0:k1])
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
            ahead = factor_panel(a[k1:, k1:k1 + nb])
            lo = k1 + nb
        trail(k0, p_p, lu_p, inv11, lo, w)
    _apply_deferred_left_swaps(a, pps, nb)
    return a, perm, info.to(torch.int32)


def _getrf_blocked(a: torch.Tensor, nb: int, threshold: float = 1.0):
    """Blocked partial-pivot LU of the padded working copy (possibly
    rectangular): the iterative loop for every width with nt ≤
    ITER_MAX_NT, else the width recursion; a wide matrix's remaining U
    columns get one block solve. ``threshold`` < 1 runs tournament
    panels."""
    m, n = a.shape
    k = min(m, n)
    if _iter_eligible(k, nb):
        lu, perm, info = _getrf_iter(a[:, :k], nb, threshold)
    else:
        lu, perm, info = _getrf_rec(a[:, :k], nb, threshold)
        a[:, :k] = lu
    if n > k:
        rest = a[:, k:].index_select(0, perm)
        a[:, k:] = blocked.trsm_rec(a[:, :k], rest, left=True, lower=True,
                                    unit=True, base=nb)
    return a, perm, info


@accurate_matmuls
def getrf(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS
          ) -> Tuple[TiledMatrix, torch.Tensor, torch.Tensor]:
    """Partial-pivot LU: A[perm] = L·U. Returns (LU packed in one
    matrix, perm int32, info 0-d int32: 1-based first zero pivot).
    ``pivot_threshold`` < 1 runs tournament panels (threshold pivoting);
    ``MethodLU.CALU`` factors through ``getrf_tntpiv``; ``MethodLU.NoPiv``
    through ``getrf_nopiv`` (which ignores ``pivot_threshold``) and
    returns the identity perm over the canonical rows."""
    if opts.method_lu is MethodLU.NoPiv:
        LU, info = getrf_nopiv(A, opts)
        return LU, _iota(LU), info
    if opts.method_lu is MethodLU.CALU:
        return getrf_tntpiv(A, opts)
    m, n = A.shape
    # the one working copy of this call: every update below writes it
    a = A.dense_canonical().clone(memory_format=torch.contiguous_format)
    a = unit_pad_diag(a.resolve_conj(), m, n)
    lu, perm, info = _getrf_blocked(a, A.nb, opts.pivot_threshold)
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
    """Solve A·X = B (getrf + getrs, so CALU and threshold pivoting too;
    ``MethodLU.RBT`` runs ``gesv_rbt``)."""
    if opts.method_lu is MethodLU.RBT:
        return gesv_rbt(A, B, opts)
    LU, perm, info = getrf(A, opts)
    return getrs(LU, perm, B, opts), info


def _iota(LU: TiledMatrix) -> torch.Tensor:
    """The identity gather perm over the factor's canonical rows."""
    return torch.arange(LU.mt * LU.nb, dtype=torch.int32, device=LU.device)


# ---------------------------------------------------------------------------
# LU without pivoting
# ---------------------------------------------------------------------------

_NOPIV_BASE = 64


def _lu_nopiv_leaf(a: torch.Tensor, info: torch.Tensor, offset: int):
    """No-pivot LU of an (m, n) leaf with s = min(m, n) ≤ 64, IN PLACE:
    the top s × s square is one P2 launch on the view itself
    (``hopper_ops.lu_nopiv_base_inplace``, which sets ``info`` to
    offset + its first bad step if it still reads 0), and the rest is
    solved against it, L21 = A21·U11⁻¹ below and U12 = L11⁻¹·A12 to the
    right (``blocked.trsm_rec``). This is the reference's unblocked loop
    (``_lu_nopiv_unblocked``, which runs min(m, n) steps over the whole
    leaf) with other rounding. The rows below solve against U11 with each
    bad diagonal entry (zero or NaN) taken as 1, as that loop divides by 1
    at a bad pivot, so a zero pivot leaves them finite."""
    m, n = a.shape
    s = min(m, n)
    lu = a[:s, :s]
    hopper_ops.lu_nopiv_base_inplace(lu, info, offset)
    if m > s:
        d = lu.diagonal()
        u11 = torch.triu(lu)
        u11.diagonal().copy_(torch.where(hopper_ops.bad_pivot(d),
                                         torch.ones_like(d), d))
        a[s:, :s] = blocked.trsm_rec(u11, a[s:, :s], left=False, lower=False)
    if n > s:
        a[:s, s:] = blocked.trsm_rec(lu, a[:s, s:], left=True, lower=True,
                                     unit=True)


def _lu_nopiv_recursive(a: torch.Tensor, info: torch.Tensor,
                        offset: int = 0, base: int = _NOPIV_BASE):
    """Recursive blocked no-pivot LU, IN PLACE on ``a``, with the
    reference's 8-aligned halves: factor A11, U12 = L11⁻¹·A12 and
    L21 = A21·U11⁻¹ (``blocked.trsm_rec``), A22 −= L21·U12, recurse on
    A22; leaves of at most ``base`` (≤ 64) are ``_lu_nopiv_leaf``.
    The solves invert only diagonal blocks of ``base`` rows (P1) and
    substitute between them by gemms: without pivoting L is unbounded,
    and inverting the 512-row blocks of the default trsm base loses
    accuracy with their condition (RBT then falls back to partial
    pivoting more often). ``info`` (0-d int32, 0 on entry) receives the
    first bad pivot's 1-based step in ``a``, plus ``offset``: the leaves
    run in diagonal order and each writes only into a slot still 0, which
    is the reference's ``info1 if info1 > 0 else info2 + half``."""
    n = min(a.shape)
    if n <= base:
        _lu_nopiv_leaf(a, info, offset)
        return
    half = (n // 2 + 7) & ~7 if n > 16 else n // 2  # 8-aligned split
    half = max(8, min(half, n - 1))
    _lu_nopiv_recursive(a[:half, :half], info, offset, base)
    a11 = a[:half, :half]
    a[:half, half:] = blocked.trsm_rec(a11, a[:half, half:], left=True,
                                       lower=True, unit=True, base=base)
    a[half:, :half] = blocked.trsm_rec(a11, a[half:, :half], left=False,
                                       lower=False, base=base)
    a[half:, half:] -= a[half:, :half] @ a[:half, half:]
    _lu_nopiv_recursive(a[half:, half:], info, offset + half, base)


@accurate_matmuls
def getrf_nopiv(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS
                ) -> Tuple[TiledMatrix, torch.Tensor]:
    """LU without pivoting, A = L·U, for diagonally dominant or
    butterfly-preconditioned matrices. Returns (LU packed, info 0-d
    int32: the 1-based first zero or NaN pivot, |d| as the reference's
    ``jnp.abs``). Padded rows/cols carry an identity diagonal. float32,
    float64, complex64 and complex128 (P2 has all four)."""
    m, n = A.shape
    # the one working copy of this call: every update below writes it
    a = A.dense_canonical().clone(memory_format=torch.contiguous_format)
    a = unit_pad_diag(a.resolve_conj(), m, n)
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    _lu_nopiv_recursive(a, info)
    return from_dense(a, A.nb, logical_shape=(m, n), device=a.device), info


def gesv_nopiv(A: TiledMatrix, B: TiledMatrix,
               opts: Options = DEFAULT_OPTIONS
               ) -> Tuple[TiledMatrix, torch.Tensor]:
    """Solve A·X = B by ``getrf_nopiv`` and ``getrs``."""
    LU, info = getrf_nopiv(A, opts)
    return getrs(LU, _iota(LU), B, opts), info


# ---------------------------------------------------------------------------
# tournament pivoting (CALU)
# ---------------------------------------------------------------------------

def _tournament_perm(panel: torch.Tensor, w: int, nb: int, prows: int,
                     mpad: int) -> torch.Tensor:
    """CALU tournament over a (prows × w) panel → the length-``prows``
    gather perm putting the w winner rows on top, the other rows after
    them in order (the reference's batched arm).

    The panel is cut into nb-row chunks, their count rounded up to a
    power of two with zero chunks whose candidate rows carry the sentinel
    ``mpad`` (rows past the panel that pad the last chunk carry their own
    index ≥ prows). Each round is one ``blocked.panel_getrf_batched`` call
    over the stack (one P3 launch on the card); each chunk's first w
    pivot rows are its candidates, and chunk 2i meets chunk 2i + 1 as one
    (2w, w) chunk of the next round, down to one chunk, whose first w
    pivot rows win. A sentinel can win only where a panel column is
    entirely zero; each is replaced by a distinct unused row (the unused
    rows in order, one per sentinel by its ordinal), so the result stays a
    permutation and the singularity shows only in info. No host sync."""
    dev = panel.device
    nchunks = -(-prows // nb)
    nck = 1
    while nck < nchunks:
        nck *= 2
    pad = nck * nb - prows
    if pad:
        panel = torch.cat([panel, panel.new_zeros((pad, w))])
    chunks = panel.reshape(nck, nb, w)
    cand = torch.arange(nck * nb, dtype=torch.int32, device=dev).reshape(
        nck, nb)
    if nck != nchunks:
        cand = torch.where(cand < prows, cand, mpad)
    while chunks.shape[0] > 1:
        top = blocked.panel_getrf_batched(chunks)[1][:, :w].long()
        chunks = chunks.gather(1, top[:, :, None].expand(-1, -1, w)).reshape(
            -1, 2 * w, w)
        cand = cand.gather(1, top).reshape(-1, 2 * w)
    pfin = blocked.panel_getrf_batched(chunks)[1][0, :w].long()
    winners = cand[0].index_select(0, pfin)  # panel-relative rows
    valid = winners < prows
    # index_fill_ takes its value as a scalar: an indexed assignment would
    # copy it to the card first and wait for the stream
    used = torch.zeros(prows + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(valid, winners, prows).long(), True)
    # the unused rows in order, first (a stable sort of the flags)
    unused = torch.argsort(used[:prows].to(torch.int8), stable=True)
    invalid = (~valid).long()
    slot = torch.cumsum(invalid, 0) - invalid  # per-slot sentinel ordinal
    winners = torch.where(valid, winners,
                          unused.index_select(0, slot).to(torch.int32))
    others = torch.ones(prows, dtype=torch.bool, device=dev).index_fill_(
        0, winners.long(), False)
    rest = torch.argsort((~others).to(torch.int8), stable=True)[:prows - w]
    return torch.cat([winners, rest.to(torch.int32)])


def _tournament_panel(panel: torch.Tensor, w: int, nb: int, prows: int,
                      mpad: Optional[int] = None):
    """Tournament-pivoted factorization of a (prows × w) panel → (lu
    packed, the tournament's compaction perm, info 0-d int32): the
    winners (``_tournament_perm``, sentinel ``mpad``, default prows), then
    the panel gathered by that perm (a new tensor, the only copy) and
    eliminated without pivoting, its w × w top IN PLACE by
    ``_lu_nopiv_recursive`` (P2 leaves) and the rows below by
    ``blocked.trsm_rec(..., left=False, lower=False)`` against that U
    (P1 bases). That solve divides by a zero pivot, as the reference's
    ``triangular_solve`` does there; info still names the first bad
    pivot. The reference's ``perm_done`` arm (the caller gathers) is this
    one: here the gather is always this call's."""
    p_p = _tournament_perm(panel, w, nb, prows,
                           prows if mpad is None else mpad)
    pan = panel.index_select(0, p_p)
    info = torch.zeros((), dtype=torch.int32, device=panel.device)
    _lu_nopiv_recursive(pan[:w], info)
    if prows > w:
        pan[w:] = blocked.trsm_rec(pan[:w], pan[w:], left=False, lower=False,
                                   base=_NOPIV_BASE)
    return pan, p_p, info


@accurate_matmuls
def getrf_tntpiv(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS
                 ) -> Tuple[TiledMatrix, torch.Tensor, torch.Tensor]:
    """Tournament (CALU) pivoting LU: A[perm] = L·U → (LU packed, perm
    int32, info 0-d int32), in the reference's fused form. Per nb-wide
    panel: the tournament panel (``_tournament_panel``: the winners, then
    the gathered panel factored without pivoting), U12 by a unit-lower
    solve of the winner rows and the Schur complement from the other
    rows, both gathered on read, one nb-wide column slab at a time;
    the stored L columns are reordered once at the end
    (``_apply_deferred_left_swaps``). Each call clones the operand once
    into a working copy and updates it in place."""
    m, n = A.shape
    nb = A.nb
    a = A.dense_canonical().clone(memory_format=torch.contiguous_format)
    a = unit_pad_diag(a.resolve_conj(), m, n)
    mpad, npad = a.shape
    perm = torch.arange(mpad, dtype=torch.int32, device=a.device)
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    pps = []
    for k in range(min(A.mt, A.nt)):
        k0, k1 = k * nb, min((k + 1) * nb, npad)
        w, prows = k1 - k0, mpad - k0
        lu_p, p_perm, i_p = _tournament_panel(a[k0:, k0:k1], w, nb, prows,
                                              mpad)
        perm[k0:] = perm[k0:].index_select(0, p_perm)
        pps.append(p_perm)
        info = torch.where((info == 0) & (i_p > 0), i_p + k0, info)
        if k1 < npad:
            # U12 from the winner rows, then the Schur complement slab by
            # slab from the other rows, gathered on read (the writes go
            # below row k1 and the winner rows' values are held in urow)
            urow = blocked.trsm_rec(
                lu_p[:w], a[k0:, k1:].index_select(0, p_perm[:w]), left=True,
                lower=True, unit=True, base=_NOPIV_BASE)
            for j0 in range(k1, npad, nb):
                j1 = min(j0 + nb, npad)
                a[k1:, j0:j1] = (a[k0:, j0:j1].index_select(0, p_perm[w:])
                                 - lu_p[w:] @ urow[:, j0 - k1:j1 - k1])
            a[k0:k1, k1:] = urow
        a[k0:, k0:k1] = lu_p
    _apply_deferred_left_swaps(a, pps, nb)
    return (from_dense(a, nb, logical_shape=(m, n), device=a.device), perm,
            info.to(torch.int32))


# ---------------------------------------------------------------------------
# inverse from the factors
# ---------------------------------------------------------------------------

def getri(LU: TiledMatrix, perm: torch.Tensor,
          opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """A⁻¹ from getrf factors: getrs against I."""
    n = LU.shape[0]
    eye = torch.eye(LU.dense_canonical().shape[0], dtype=LU.dtype,
                    device=LU.device)
    I = from_dense(eye, LU.nb, logical_shape=(n, n), device=LU.device)
    return getrs(LU, perm, I, opts)


def getri_oop(LU: TiledMatrix, perm: torch.Tensor,
              opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """Out-of-place inverse from getrf factors: every solve here leaves
    the factors as they are, so this is ``getri`` under the reference's
    other name."""
    return getri(LU, perm, opts)


# ---------------------------------------------------------------------------
# Random Butterfly Transform (RBT)
# ---------------------------------------------------------------------------

# what the last gesv_rbt call did: refinement steps taken, and whether it
# fell back to partial pivoting (a diagnostic, like hopper_ops.LAUNCHES)
RBT_LAST: Dict[str, object] = {"refinements": 0, "fallback": False}


def _butterfly_vectors(n2: int, depth: int, seed: int, dtype,
                       device) -> torch.Tensor:
    """(2·depth, n2) random butterfly diagonals exp(r/10)/√2 with r
    uniform in [−1, 1), drawn in float32 on the CPU from a
    ``torch.Generator`` seeded with ``seed`` and moved to ``device``, so
    they do not depend on the device. They are not ``jax.random``'s
    numbers for the same seed (the reference's): the two packages' RBTs
    are different random transforms of the same kind."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    r = torch.rand((2 * depth, n2), generator=gen, dtype=torch.float32)
    d = torch.exp((2 * r - 1) / 10.0) / math.sqrt(2.0)
    return d.to(dtype=dtype, device=device)


def _apply_butterfly(x: torch.Tensor, d: torch.Tensor,
                     transpose: bool) -> torch.Tensor:
    """One butterfly level on a (nblk, blk, k) stack: y = Bᵀ·x
    (transpose) or B·x per block, B = [[D1, D2], [D1, −D2]], d the
    (nblk, blk) diagonals."""
    h = x.shape[1] // 2
    x1, x2 = x[:, :h], x[:, h:]
    d1, d2 = d[:, :h, None], d[:, h:2 * h, None]
    if transpose:
        return torch.cat([d1 * (x1 + x2), d2 * (x1 - x2)], dim=1)
    return torch.cat([d1 * x1 + d2 * x2, d1 * x1 - d2 * x2], dim=1)


def _rbt_rows(x: torch.Tensor, diags: torch.Tensor, depth: int,
              transpose: bool) -> torch.Tensor:
    """The depth-d recursive butterfly W (or Wᵀ) applied to the rows of
    x, as a new tensor."""
    n = x.shape[0]
    levels = range(depth) if transpose else range(depth - 1, -1, -1)
    for lev in levels:
        nblk = 2 ** lev
        blk = n // nblk
        d = diags[lev][: nblk * blk].reshape(nblk, blk)
        x = _apply_butterfly(x.reshape(nblk, blk, -1), d,
                             transpose).reshape(n, -1)
    return x


def gerbt(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS, seed: int = 0):
    """Two-sided random butterfly transform Ã = Uᵀ·A·V of the padded A
    (identity on the padded diagonal), at depth ``opts.depth`` lowered
    until 2^depth divides the padded size. Returns (Ã, (u, depth),
    (v, depth)). As in the reference, Ã is cut to A's logical shape (its
    padding is zeroed)."""
    depth = opts.depth
    a = unit_pad_diag(A.dense_canonical().clone(), *A.shape)
    n = a.shape[0]
    while n % (2 ** depth):
        depth -= 1
    u = _butterfly_vectors(n, depth, seed * 2 + 1, a.dtype, a.device)
    v = _butterfly_vectors(n, depth, seed * 2 + 2, a.dtype, a.device)
    at = _rbt_rows(a, u, depth, transpose=True)           # Uᵀ·A
    at = _rbt_rows(at.mT, v, depth, transpose=True).mT    # Uᵀ·A·V
    At = from_dense(at, A.nb, logical_shape=A.shape, device=at.device)
    return At, (u, depth), (v, depth)


def gesv_rbt(A: TiledMatrix, B: TiledMatrix,
             opts: Options = DEFAULT_OPTIONS
             ) -> Tuple[TiledMatrix, torch.Tensor]:
    """Solve A·X = B by the butterfly transform, no-pivot LU and
    iterative refinement: A = U·Ã·Vᵀ ⇒ X = V·Ã⁻¹·Uᵀ·B, refined in working
    precision (residual by ``blas3.gemm``, correction added by
    ``elementwise.add``) until ‖R‖∞ ≤ ‖X‖∞·‖A‖∞·ε·√n, at most
    ``opts.max_iterations`` steps; without convergence and with
    ``opts.use_fallback_solver`` it solves again with partial pivoting.
    ``RBT_LAST`` records the steps taken and whether it fell back."""
    At, (u, du), (v, dv) = gerbt(A, opts)
    LU, info = getrf_nopiv(At, opts)
    npad = LU.dense_canonical().shape[0]
    iota = _iota(LU)

    def rbt_solve(rhs: TiledMatrix) -> TiledMatrix:
        rb = rhs.dense_canonical()
        if rb.shape[0] < npad:
            rb = torch.cat([rb, rb.new_zeros((npad - rb.shape[0],
                                              rb.shape[1]))])
        tb = _rbt_rows(rb, u, du, transpose=True)
        Tb = from_dense(tb, B.nb, logical_shape=(npad, rhs.shape[1]),
                        device=tb.device)
        Y = getrs(LU, iota, Tb, opts)
        x = _rbt_rows(Y.dense_canonical()[:npad], v, dv, transpose=False)
        return from_dense(x[: B.shape[0]], B.nb, logical_shape=B.shape,
                          device=x.device)

    X = rbt_solve(B)
    anorm = norm(A, Norm.Inf)
    cte = anorm * torch.finfo(A.dtype).eps * math.sqrt(A.shape[0])
    RBT_LAST.update(refinements=0, fallback=False)
    for step in range(opts.max_iterations + 1):
        R = blas3.gemm(-1.0, A, X, 1.0, B, opts)
        if bool(norm(R, Norm.Inf) <= norm(X, Norm.Inf) * cte):
            RBT_LAST["refinements"] = step
            return X, info
        X = ew.add(1.0, rbt_solve(R), 1.0, X, opts)
    RBT_LAST["refinements"] = opts.max_iterations + 1
    if not opts.use_fallback_solver:
        return X, info
    RBT_LAST["fallback"] = True
    LU2, perm2, info2 = getrf(A, opts.replace(
        method_lu=MethodLU.PartialPiv))
    return getrs(LU2, perm2, B, opts), info2


# ---------------------------------------------------------------------------
# mixed precision
# ---------------------------------------------------------------------------

@accurate_matmuls
def gesv_mixed(A: TiledMatrix, B: TiledMatrix,
               opts: Options = DEFAULT_OPTIONS, factor_dtype=torch.float32
               ) -> Tuple[TiledMatrix, torch.Tensor, int]:
    """Factor in low precision, refine in the working precision
    (slate::gesv_mixed, src/gesv_mixed.cc:23-77; the reference's
    ``linalg/lu.py:851-885``): getrf of A cast to ``factor_dtype``, then
    at most ``opts.max_iterations`` steps of R = B − A·X (gemm in the
    working precision), X += getrs(R) until ‖R‖∞ ≤ ‖X‖∞·‖A‖∞·ε·√n.
    Returns (X, info, iters); iters < 0: no convergence, and with
    ``opts.use_fallback_solver`` the full-precision gesv answered."""
    if A.dtype == factor_dtype:
        X, info = gesv(A, B, opts)
        return X, info, 0
    work = A.dtype
    LU, perm, info = getrf(ew.copy(A, dtype=factor_dtype), opts)
    cte = norm(A, Norm.Inf) * torch.finfo(work).eps * math.sqrt(A.shape[0])

    def lo_solve(R: TiledMatrix) -> TiledMatrix:
        return ew.copy(getrs(LU, perm, ew.copy(R, dtype=factor_dtype),
                             opts), dtype=work)

    X = lo_solve(B)
    converged = False
    iters = 0
    for it in range(opts.max_iterations):
        iters = it + 1
        R = blas3.gemm(-1.0, A, X, 1.0, B, opts)
        if bool(norm(R, Norm.Inf) <= norm(X, Norm.Inf) * cte):
            converged = True
            break
        X = ew.add(1.0, lo_solve(R), 1.0, X, opts)
    if not converged and opts.use_fallback_solver:
        X, info = gesv(A, B, opts)
        return X, info, -iters
    return X, info, iters
