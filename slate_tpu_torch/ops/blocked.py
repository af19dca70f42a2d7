"""Gemm-based blocked building blocks of the factorizations.

Counterpart of ``slate_tpu/ops/blocked.py`` (the parts the dense
Cholesky, LU and QR slices run). The algorithms and the reference's
dispatch decisions are kept — recursion bases (``TRTRI_BASE``,
``TRSM_BASE``, ``_LARFT_BASE``), ``PANEL_IB`` and the ``panel_getrf`` /
``panel_geqrf`` width recursions, pow2 panel-height buckets,
``ITER_MAX_NT`` — so the CPU tests compare the same algorithm step for
step. The panel bases themselves (and larfg) live beside their kernels
in ``hopper_ops``. The XLA workarounds are not ported (``dus_i32``,
``lift_tail_perm``, ``rebalance``/``replicate_on_grid``, jit wrappers).

Where the reference writes a functional update (``dynamic_update_slice``,
``.at[].set``), the port writes the slice IN PLACE on the factorization's one
working copy, cloned once per call. The reference's ``mm(a, b, prec)``
is plain ``a @ b`` here, at full precision under the factorizations'
``accurate_matmuls`` (TF32 off), and its ``permute_rows_limited(x, perm,
max_moved)`` is ``x.index_select(0, perm)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import hopper_ops

TRTRI_BASE = 64
TRSM_BASE = 512
PANEL_IB = 32
# bound on the python-unrolled iterative outer loops (shared by
# linalg/cholesky.py and linalg/lu.py, as in the reference)
ITER_MAX_NT = 64


def _round_to(x: int, q: int) -> int:
    return -(-x // q) * q


def _half(n: int, q: int) -> int:
    """Split point for 2×2 recursion: ~n/2 rounded up to a multiple of q,
    clamped to keep both halves non-empty."""
    h = _round_to(n // 2, q)
    if h >= n:
        h = _round_to(n // 2, 8)
    if h >= n or h == 0:
        h = max(1, n // 2)
    return h


def bucket_pow2(h: int, q: int) -> int:
    """Smallest q·2^i ≥ h — the panel-height bucketing quantum."""
    b = q
    while b < h:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# triangular inverse
# ---------------------------------------------------------------------------

def _trtri_lower_base(l: torch.Tensor, unit: bool) -> torch.Tensor:
    """Inverse of one lower-triangular block of at most 64 rows: one P1
    launch (``hopper_ops.trtri_leaves``; its plain version on the CPU).
    Reads only the lower triangle."""
    return hopper_ops.trtri_leaves(l[None], unit)[0]


def trtri_lower_rec(l: torch.Tensor, unit: bool = False,
                    base: int = TRTRI_BASE) -> torch.Tensor:
    """inv(L) by 2×2 block recursion:
    inv([[A,0],[B,C]]) = [[iA,0],[−iC·B·iA, iC]]. Only the lower
    triangle of ``l`` is read. ``base`` ≤ 64 (P1's widest leaf)."""
    n = l.shape[0]
    if n <= base:
        return _trtri_lower_base(l, unit)
    h = _half(n, 8)
    out = torch.zeros_like(l)
    ia = trtri_lower_rec(l[:h, :h], unit, base)
    ic = trtri_lower_rec(l[h:, h:], unit, base)
    out[:h, :h] = ia
    out[h:, h:] = ic
    out[h:, :h] = -(ic @ (l[h:, :h] @ ia))
    return out


def _blocks(l: torch.Tensor, row0: int, s: int, step: int) -> torch.Tensor:
    """The (n/step, s, s) stack of blocks l[row0 + i : row0 + i + s, i :
    i + s] for i = 0, step, 2·step, … as one strided view (no copy)."""
    rs, cs = l.stride()
    return l.as_strided((l.shape[0] // step, s, s),
                        (step * (rs + cs), rs, cs),
                        l.storage_offset() + row0 * rs)


def trtri_lower_batched(l: torch.Tensor, unit: bool = False,
                        leaf: int = 64) -> torch.Tensor:
    """inv(L) with all diagonal leaf blocks inverted in one P1 launch
    (``hopper_ops.trtri_leaves`` on a strided view of the diagonal), then
    combined level by level with batched gemms. Needs a power-of-two leaf
    grid; otherwise the recursion."""
    n = l.shape[0]
    nleaf = n // leaf if n % leaf == 0 else 0
    if n <= leaf or nleaf == 0 or (nleaf & (nleaf - 1)) != 0:
        return trtri_lower_rec(l, unit)
    inv = hopper_ops.trtri_leaves(_blocks(l, 0, leaf, leaf), unit)
    s = leaf
    while s < n:
        nblk = inv.shape[0]
        ia, ic = inv[0::2], inv[1::2]
        b = _blocks(l, s, s, 2 * s)
        nxt = torch.zeros((nblk // 2, 2 * s, 2 * s), dtype=l.dtype,
                          device=l.device)
        nxt[:, :s, :s] = ia
        nxt[:, s:, s:] = ic
        nxt[:, s:, :s] = -(ic @ b @ ia)
        inv = nxt
        s *= 2
    return inv[0]


def trtri_rec(a: torch.Tensor, lower: bool = True,
              unit: bool = False) -> torch.Tensor:
    """Triangular inverse, lower or upper (inv(U) = inv(Uᵀ)ᵀ), through
    ``trtri_lower_batched``. Reads only the stored triangle."""
    if lower:
        return trtri_lower_batched(a, unit)
    return trtri_lower_batched(a.mT, unit).mT


# ---------------------------------------------------------------------------
# triangular solve
# ---------------------------------------------------------------------------

def _trsm_left_lower(m, b, unit, base):
    """X with M·X = B, M lower triangular (only lower triangle read)."""
    n = m.shape[0]
    if n <= base:
        return trtri_lower_batched(m, unit) @ b
    h = _half(n, base)
    x = torch.empty_like(b)
    x[:h] = _trsm_left_lower(m[:h, :h], b[:h], unit, base)
    x[h:] = _trsm_left_lower(m[h:, h:], b[h:] - m[h:, :h] @ x[:h], unit,
                             base)
    return x


def _trsm_left_upper(m, b, unit, base):
    """X with M·X = B, M upper triangular (inv(U) = inv(Uᵀ)ᵀ)."""
    n = m.shape[0]
    if n <= base:
        return trtri_lower_batched(m.mT, unit).mT @ b
    h = _half(n, base)
    x = torch.empty_like(b)
    x[h:] = _trsm_left_upper(m[h:, h:], b[h:], unit, base)
    x[:h] = _trsm_left_upper(m[:h, :h], b[:h] - m[:h, h:] @ x[h:], unit,
                             base)
    return x


def trsm_rec(a: torch.Tensor, b: torch.Tensor, *, left: bool = True,
             lower: bool = True, unit: bool = False, trans_a: bool = False,
             conj_a: bool = False, base: int = TRSM_BASE) -> torch.Tensor:
    """Solve op(A)·X = B (left) or X·op(A) = B (right), A triangular,
    by block recursion over inverted diagonal blocks (the bases invert
    with ``trtri_lower_batched``). Returns a new tensor."""
    m = a.conj() if conj_a else a
    eff_lower = lower
    if trans_a:
        m = m.mT
        eff_lower = not lower
    if left:
        solve = _trsm_left_lower if eff_lower else _trsm_left_upper
        return solve(m, b, unit, base)
    mt = m.mT
    solve = _trsm_left_upper if eff_lower else _trsm_left_lower
    return solve(mt, b.mT, unit, base).mT


# ---------------------------------------------------------------------------
# triangle-aware rank-k updates
# ---------------------------------------------------------------------------

def herk_lower_rec(c: torch.Tensor, a: torch.Tensor,
                   b: Optional[torch.Tensor] = None, base: int = 1024
                   ) -> torch.Tensor:
    """C − A·Bᴴ restricted to the lower triangle (B defaults to A); the
    strict upper of the result holds ``c``'s entries.

    ``c`` may be overwritten. Without ``b`` and for a real dtype (the
    reference's gate) the update is one K5 call,
    ``hopper_ops.herk_lower_update`` — the CUDA kernel on the card, its
    plain version on the CPU — which writes ``c`` IN PLACE (through its
    row stride, so ``c`` may be a view; on the card ``c`` and ``a`` need
    a unit column stride) and returns it. With ``b`` given,
    or a complex dtype, the reference's 2×2 recursion (cuBLAS gemms)
    returns a new tensor."""
    if b is None:
        if not c.is_complex():
            return hopper_ops.herk_lower_update(c, a)
        b = a
    s = c.shape[0]
    if s <= base:
        return c - a @ b.mH
    h = _half(s, 8)
    out = c.clone()
    out[:h, :h] = herk_lower_rec(c[:h, :h], a[:h], b[:h], base)
    out[h:, :h] = c[h:, :h] - a[h:] @ b[:h].mH
    out[h:, h:] = herk_lower_rec(c[h:, h:], a[h:], b[h:], base)
    return out


def herk_trailing_inplace(a: torch.Tensor, pan: torch.Tensor, k1: int,
                          nb: int, j_start: Optional[int] = None,
                          j_stop: Optional[int] = None) -> torch.Tensor:
    """A[k1:, k1:] ← A[k1:, k1:] − pan·panᴴ written IN PLACE into ``a``,
    one nb-wide column slab at a time, over slabs [j_start, j_stop).
    Splitting the range leaves every slab's gemm unchanged, so the
    lookahead pipeline's split calls are bitwise one full call. Only the
    lower trapezoid of the result is meaningful."""
    s = a.shape[0]
    lo = k1 if j_start is None else j_start
    hi = s if j_stop is None else min(j_stop, s)
    for j0 in range(lo, hi, nb):
        jw = min(nb, s - j0)
        rows = pan[j0 - k1:]
        cols = pan[j0 - k1:j0 - k1 + jw]
        a[j0:, j0:j0 + jw] -= rows @ cols.mH
    return a


# ---------------------------------------------------------------------------
# Cholesky of one diagonal tile
# ---------------------------------------------------------------------------

def chol_tile_blocked(a: torch.Tensor) -> torch.Tensor:
    """Cholesky of one diagonal tile: the K1 kernel on the card (its
    plain version on the CPU), A = L·Lᴴ from the real part of the
    diagonal. Strict upper zeroed; NaN on the diagonal from the first
    non-positive pivot on."""
    return hopper_ops.chol_tile(a.contiguous())


# ---------------------------------------------------------------------------
# blocked panel LU (partial pivot)
# ---------------------------------------------------------------------------

def _compose_tail(p1: torch.Tensor, p2: torch.Tensor, h: int) -> torch.Tensor:
    """Total gather perm for 'apply p1, then p2 on rows h:'."""
    return torch.cat([p1[:h], p1[h:].index_select(0, p2)])


def panel_getrf(a: torch.Tensor, ib: int = PANEL_IB
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked partial-pivot LU of a tall (H × w) panel, recursing on
    width; every base (w ≤ 128) is one ``lu_panel_base`` call — the K2
    kernel on the card, its plain version (the reference's
    ``_panel_getrf_base``) on the CPU. Returns (lu, perm, info) with
    gather semantics a[perm] = L·U."""
    hh, w = a.shape
    if hopper_ops.lu_panel_eligible(w):
        return hopper_ops.lu_panel_base(a.contiguous())
    h = _round_to(w // 2, ib)
    lu1, p1, i1 = panel_getrf(a[:, :h], ib)
    right = a[:, h:].index_select(0, p1)
    u_top = trsm_rec(lu1[:h, :h], right[:h], left=True, lower=True,
                     unit=True, base=max(ib, 64))
    schur = right[h:] - lu1[h:, :h] @ u_top
    lu2, p2, i2 = panel_getrf(schur, ib)
    lu = torch.empty_like(a)
    lu[:h, :h] = lu1[:h]
    lu[:h, h:] = u_top
    lu[h:, :h] = lu1[h:, :h].index_select(0, p2)
    lu[h:, h:] = lu2
    perm = _compose_tail(p1, p2, h)
    info = torch.where(i1 > 0, i1, torch.where(i2 > 0, i2 + h, 0))
    return lu, perm, info.to(torch.int32)


def panel_getrf_batched(stack: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial-pivot LU of every chunk of a (B, H, w) stack, the per-round
    factorization of the CALU tournament → (lu, perm (B, H), info (B,))
    stacks with ``panel_getrf``'s contract per chunk. One
    ``lu_panel_batched`` call: the P3 kernel on the card (one launch per
    round), its plain version on the CPU."""
    return hopper_ops.lu_panel_batched(stack.contiguous())


# ---------------------------------------------------------------------------
# blocked panel QR (Householder)
# ---------------------------------------------------------------------------

_LARFT_BASE = 32


def _larft_base(v: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """LAPACK's columnwise T recurrence on the Gram matrix VᴴV (the
    small-width base of ``larft``)."""
    return hopper_ops.larft_columnwise(v.mH @ v, taus)


def larft(v: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Forward columnwise T factor of the compact-WY form I − V·T·Vᴴ.

    Above ``_LARFT_BASE`` columns, the recurrence in closed form,
    T = D·(I + S·D)⁻¹ with S = striu(VᴴV) and D = diag(τ): one Gram
    gemm, one unit-triangular inverse (``trtri_lower_batched`` on the
    transpose) and a row scaling. A column with τᵢ = 0 gives a zero
    column of T."""
    w = taus.shape[0]
    if w <= _LARFT_BASE:
        return _larft_base(v, taus)
    s = torch.triu(v.mH @ v, 1)
    m = torch.eye(w, dtype=v.dtype, device=v.device) + s * taus[None, :]
    minv = trtri_lower_batched(m.mT, unit=True)
    return taus[:, None] * minv.mT


def _split_v(vr: torch.Tensor, w: int) -> torch.Tensor:
    """Unit-lower-trapezoidal V from a packed V\\R panel (first w
    columns), as a new tensor."""
    v = torch.tril(vr[:, :w], -1)
    v.diagonal().fill_(1)
    return v


def panel_geqrf(a: torch.Tensor, ib: int = PANEL_IB
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked Householder QR of a tall (H × w) panel → (V\\R packed,
    taus), recursing on width. Every base is one kernel call on the card
    (its plain version on the CPU): the K3 kernel ``qr_panel_base`` where
    the reference stops its recursion (w ≤ ib; K3 takes w ≤ 32), the K4
    kernel ``qr_panel_base_wide`` at 32 < w ≤ 128 with w % 32 == 0.
    Other widths split at ~w/2 (a multiple of ib); the right half is
    reflected by the left half's compact-WY form (larft and two gemms)."""
    hh, w = a.shape
    if w <= ib or _round_to(w // 2, ib) >= w:
        return hopper_ops.qr_panel_base(a.contiguous())
    if hopper_ops.qr_panel_wide_eligible(w):
        return hopper_ops.qr_panel_base_wide(a.contiguous())
    h = _round_to(w // 2, ib)
    vr1, taus1 = panel_geqrf(a[:, :h], ib)
    v1 = _split_v(vr1, h)
    t1 = larft(v1, taus1)
    right = a[:, h:] - v1 @ (t1.mH @ (v1.mH @ a[:, h:]))
    vr2, taus2 = panel_geqrf(right[h:], ib)
    vr = torch.empty_like(a)
    vr[:, :h] = vr1
    vr[:h, h:] = right[:h]
    vr[h:, h:] = vr2
    return vr, torch.cat([taus1, taus2])


def apply_block_reflectors_stacked(Vs: torch.Tensor, Ts: torch.Tensor,
                                   C: torch.Tensor, rows0) -> torch.Tensor:
    """C ← Q·C IN PLACE for Q = ∏ₖ(I − VₖTₖVₖᴴ) given stacked per-panel
    block reflectors Vs (k, n, b) / Ts (k, b, b), the shared back-transform
    of the two-sided reductions (unmtr_he2td, unmtr_he2hb); the last panel
    applies first. ``rows0[k]`` is the first row on which Vₖ is not zero:
    panel k reads and writes C's rows from there on. Returns C."""
    for k in reversed(range(Vs.shape[0])):
        V, c = Vs[k, rows0[k]:], C[rows0[k]:]
        c -= V @ (Ts[k] @ (V.mH @ c))
    return C


def apply_block_reflectors_stacked_H(Vs: torch.Tensor, Ts: torch.Tensor,
                                     C: torch.Tensor, rows0) -> torch.Tensor:
    """C ← Qᴴ·C IN PLACE for the same stacked Q as
    apply_block_reflectors_stacked (first panel applies first;
    Hᴴ = I − V·Tᴴ·Vᴴ). Returns C."""
    for k in range(Vs.shape[0]):
        V, c = Vs[k, rows0[k]:], C[rows0[k]:]
        c -= V @ (Ts[k].mH @ (V.mH @ c))
    return C


def level_plan(rem: int, min_panels: int = 4):
    """Panel counts per level of the halving two-sided reductions
    (he2hb): halve the remaining panels until few are left, then finish.
    The port keeps the reference's levels because they fix the layout of
    he2hb's reflectors, (offset, Vs, Ts) per level."""
    plan = []
    while rem > 0:
        kp = rem if rem <= min_panels else rem // 2
        plan.append(kp)
        rem -= kp
    return plan


def panel_geqrf_with_t(a: torch.Tensor):
    """Panel QR and its T factor: (vr_packed, taus, T (w, w))."""
    vr, taus = panel_geqrf(a)
    t = larft(_split_v(vr, a.shape[1]), taus)
    return vr, taus, t


# ---------------------------------------------------------------------------
# the batched small-problem engine: (B, n, n) stacks, a leading batch dim
# ---------------------------------------------------------------------------
# Counterpart of slate_tpu/ops/blocked.py:997-1360 with the reference's
# constants and recursions. Its column loops run as port-only kernels, one
# launch for the whole stack: P1 (trtri_leaves) at every trtri leaf, P3
# (lu_panel_batched) at every LU panel, P4 (chol_tile_batched) at every
# Cholesky block and P5 (qr_panel_batched) at every QR panel. Every kernel
# computes each item alone, so one bad item (singular, not SPD, NaN) flags
# its own info and leaves its neighbours' bits untouched; the batched gemms
# are cuBLAS's (plain jnp in the reference). Each driver clones its input
# once and writes the reference's functional updates in place on that copy.

TRTRI_B_LEAF = 32
TRSM_B_BASE = 64
CHOL_B_IB = 32


def trtri_lower_b(l: torch.Tensor, unit: bool = False,
                  leaf: int = TRTRI_B_LEAF) -> torch.Tensor:
    """Batched inv(L) over a (B, n, n) stack by the 2×2 block recursion;
    each leaf (n ≤ ``leaf``) is one P1 launch on the (B, s, s) view. Only
    the lower triangles are read. Returns a new contiguous stack."""
    n = l.shape[-1]
    if n <= leaf:
        return hopper_ops.trtri_leaves(l, unit)
    h = _half(n, 8)
    ia = trtri_lower_b(l[:, :h, :h], unit, leaf)
    ic = trtri_lower_b(l[:, h:, h:], unit, leaf)
    out = l.new_zeros(l.shape)
    out[:, :h, :h] = ia
    out[:, h:, h:] = ic
    out[:, h:, :h] = -(ic @ (l[:, h:, :h] @ ia))
    return out


def trsm_lower_b(m: torch.Tensor, b: torch.Tensor, unit: bool = False,
                 base: int = TRSM_B_BASE) -> torch.Tensor:
    """Batched X with M·X = B, M a (B, n, n) lower-triangular stack: block
    recursion on the rows, each base (n ≤ ``base``) multiplied by its
    batched inverse (``trtri_lower_b``)."""
    n = m.shape[-1]
    if n <= base:
        return trtri_lower_b(m, unit) @ b
    h = _half(n, 8)
    x = b.new_empty(b.shape)
    x[:, :h] = trsm_lower_b(m[:, :h, :h], b[:, :h], unit, base)
    x[:, h:] = trsm_lower_b(m[:, h:, h:], b[:, h:] - m[:, h:, :h] @ x[:, :h],
                            unit, base)
    return x


def trsm_upper_b(m: torch.Tensor, b: torch.Tensor, unit: bool = False,
                 base: int = TRSM_B_BASE) -> torch.Tensor:
    """Batched X with M·X = B, M a (B, n, n) upper-triangular stack (each
    base inverted as inv(Mᵀ)ᵀ: P1 reads the ``.mT`` view)."""
    n = m.shape[-1]
    if n <= base:
        return trtri_lower_b(m.mT, unit).mT @ b
    h = _half(n, 8)
    x = b.new_empty(b.shape)
    x[:, h:] = trsm_upper_b(m[:, h:, h:], b[:, h:], unit, base)
    x[:, :h] = trsm_upper_b(m[:, :h, :h], b[:, :h] - m[:, :h, h:] @ x[:, h:],
                            unit, base)
    return x


def chol_tile_b(d: torch.Tensor, ib: int = CHOL_B_IB
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched guarded Cholesky of a (B, b, b) stack of diagonal tiles →
    (tril L, info (B,)). A tile of at most ``ib`` columns, or one that
    ``ib`` does not divide, is one P4 launch (the reference's unrolled
    base); otherwise ``ib``-wide steps: P4 on the diagonal block, one P1
    launch for its inverse, the column block by a gemm and the trailing
    update by another. Above P4's widest tile (64) a width that ``ib``
    does not divide takes the same steps with a narrower last block (the
    reference unrolls such a tile whole)."""
    b = d.shape[-1]
    if b <= hopper_ops.LEAF_MAX and (b <= ib or b % ib):
        return hopper_ops.chol_tile_batched(d)
    d = d.clone(memory_format=torch.contiguous_format)
    info = torch.zeros(d.shape[0], dtype=torch.int32, device=d.device)
    for j0 in range(0, b, ib):
        j1 = min(j0 + ib, b)
        l8, binfo = hopper_ops.chol_tile_batched(d[:, j0:j1, j0:j1])
        info = torch.where((info == 0) & (binfo > 0), j0 + binfo, info)
        d[:, j0:j1, j0:j1] = l8
        if j1 >= b:
            continue
        col = d[:, j1:, j0:j1] @ hopper_ops.trtri_leaves(l8).mH
        d[:, j1:, j0:j1] = col
        d[:, j1:, j1:] -= col @ col.mH
    return torch.tril(d), info


def potrf_batched(a: torch.Tensor, nb: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched blocked lower Cholesky of a (B, n, n) stack → (tril L,
    info (B,)), A = L·Lᴴ: per nb-wide block column the tile factor
    (``chol_tile_b``),
    the panel by the tile's batched inverse, and the trailing update one
    nb-wide column slab at a time. Reads only the lower triangles; one
    non-SPD item flags its own info (1-based) and changes no other."""
    a = a.clone(memory_format=torch.contiguous_format)
    bsz, n, _ = a.shape
    info = torch.zeros(bsz, dtype=torch.int32, device=a.device)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        lkk, tinfo = chol_tile_b(a[:, k0:k1, k0:k1])
        info = torch.where((info == 0) & (tinfo > 0), k0 + tinfo, info)
        a[:, k0:k1, k0:k1] = lkk
        if k1 >= n:
            continue
        pan = a[:, k1:, k0:k1] @ trtri_lower_b(lkk).mH
        a[:, k1:, k0:k1] = pan
        for j0 in range(k1, n, nb):
            jw = min(nb, n - j0)
            a[:, j0:, j0:j0 + jw] -= (pan[:, j0 - k1:]
                                      @ pan[:, j0 - k1:j0 - k1 + jw].mH)
    return torch.tril(a), info


def getrf_batched(a: torch.Tensor, nb: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched blocked partial-pivot LU of a (B, n, n) stack → (LU, perm
    int32 (B, n) with a[b][perm[b]] = L·U, info (B,)). Each nb-wide panel
    is one P3 launch (``panel_getrf_batched``, on the panel's contiguous
    copy); its perm is applied to the whole row block by one batched row
    gather (the reference's ``lift_tail_perm_b`` gather map); U12 comes
    from a batched unit-lower trsm and the Schur complement from one
    batched gemm. A singular item keeps a valid perm, flags its own
    1-based info column and changes no other."""
    a = a.clone(memory_format=torch.contiguous_format)
    bsz, n, _ = a.shape
    perm = torch.arange(n, dtype=torch.int32,
                        device=a.device).repeat(bsz, 1)
    info = torch.zeros(bsz, dtype=torch.int32, device=a.device)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        w = k1 - k0
        plu, pperm, pinfo = panel_getrf_batched(a[:, k0:, k0:k1])
        info = torch.where((info == 0) & (pinfo > 0), k0 + pinfo, info)
        rows = pperm.long()
        a[:, k0:] = a[:, k0:].gather(1, rows[:, :, None].expand(-1, -1, n))
        perm[:, k0:] = perm[:, k0:].gather(1, rows)
        a[:, k0:, k0:k1] = plu
        if k1 >= n:
            continue
        u12 = trsm_lower_b(plu[:, :w], a[:, k0:k1, k1:], unit=True)
        a[:, k0:k1, k1:] = u12
        a[:, k1:, k1:] -= plu[:, w:] @ u12
    return a, perm, info


def _split_v_b(vr: torch.Tensor, w: int) -> torch.Tensor:
    """Batched unit-lower-trapezoidal V from packed V\\R stacks (first w
    columns), as a new tensor."""
    v = torch.tril(vr[:, :, :w], -1)
    v.diagonal(dim1=1, dim2=2).fill_(1)
    return v


def larft_b(v: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Batched forward columnwise T factor in closed form,
    T = D·(I + striu(VᴴV)·D)⁻¹, the inverse by the batched unit-triangular
    ``trtri_lower_b`` (P1) on the transpose. A column with τ = 0 gives a
    zero column of T."""
    w = taus.shape[-1]
    s = torch.triu(v.mH @ v, 1)
    m = torch.eye(w, dtype=v.dtype, device=v.device) + s * taus[:, None, :]
    return taus[:, :, None] * trtri_lower_b(m.mT, unit=True).mT


def _panel_geqrf_batched(p: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed V\\R and taus of a (B, H, w) panel stack: one P5 launch,
    or, wider than P5's 128 columns, the blocked QR of the panel in
    128-wide panels."""
    if p.shape[-1] <= hopper_ops.QR_PANEL_MAX_W:
        return hopper_ops.qr_panel_batched(p)
    vr, taus, _ = geqrf_batched(p, hopper_ops.QR_PANEL_MAX_W)
    return vr, taus


def geqrf_batched(a: torch.Tensor, nb: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched blocked Householder QR of a (B, m, n) stack, m ≥ n →
    (packed V\\R, taus (B, n), Ts (B, ceil(n/nb), nb, nb)). Each nb-wide
    panel is one P5 launch on the panel's view (``_panel_geqrf_batched``;
    a panel wider than 128 takes one per 128 columns); its T comes from the
    batched ``larft_b`` (zero-padded to nb on a narrower last panel) and
    the trailing update C ← C − V·(Tᴴ·(Vᴴ·C)) is three batched gemms."""
    a = a.clone(memory_format=torch.contiguous_format)
    bsz, m, n = a.shape
    taus = a.new_zeros((bsz, n))
    ts = a.new_zeros((bsz, -(-n // nb), nb, nb))
    for i, k0 in enumerate(range(0, n, nb)):
        k1 = min(k0 + nb, n)
        w = k1 - k0
        vr, tau = _panel_geqrf_batched(a[:, k0:, k0:k1])
        a[:, k0:, k0:k1] = vr
        taus[:, k0:k1] = tau
        v = _split_v_b(vr, w)
        t = larft_b(v, tau)
        ts[:, i, :w, :w] = t
        if k1 < n:
            c = a[:, k0:, k1:]
            c -= v @ (t.mH @ (v.mH @ c))
    return a, taus, ts


def getrs_batched(lu: torch.Tensor, perm: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Batched A·X = B from ``getrf_batched`` factors: one batched row
    gather b[perm], then the unit-lower and the upper batched trsm."""
    pb = b.gather(1, perm.long()[:, :, None].expand(-1, -1, b.shape[2]))
    return trsm_upper_b(lu, trsm_lower_b(lu, pb, unit=True))


def potrs_batched(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched A·X = B from ``potrf_batched`` factors: L, then Lᴴ."""
    return trsm_upper_b(l.mH, trsm_lower_b(l, b))


def gels_qr_solve_batched(vr: torch.Tensor, ts: torch.Tensor,
                          b: torch.Tensor, nb: int) -> torch.Tensor:
    """Batched least-squares solve from ``geqrf_batched`` factors:
    X = R⁻¹·(Qᴴ·B)[:n], Qᴴ applied panel by panel through the stored
    compact-WY (V, T) pairs (C ← C − V·(Tᴴ·(Vᴴ·C))), then one batched
    upper trsm against R."""
    n = vr.shape[2]
    c = b.clone(memory_format=torch.contiguous_format)
    for i, k0 in enumerate(range(0, n, nb)):
        w = min(nb, n - k0)
        v = _split_v_b(vr[:, k0:, k0:k0 + w], w)
        t = ts[:, i, :w, :w]
        ck = c[:, k0:]
        ck -= v @ (t.mH @ (v.mH @ ck))
    return trsm_upper_b(torch.triu(vr[:, :n, :n]), c[:, :n])
