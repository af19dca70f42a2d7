"""SVD: svd, ge2tb, ge2bd, bdsqr and their back-transforms (counterpart
of ``slate_tpu/linalg/svd.py``).

Stage 1 has two reductions. ``ge2tb`` takes A (m ≥ n) to upper band form
with bandwidth nb by alternating a left QR and a right LQ per nb panel
over ``blocked.level_plan``. ``ge2bd`` takes A straight to a real upper
bidiagonal by LAPACK's labrd/gebrd recurrence: per column, two matrix-
vector products on the trailing block and a left and a right larfg, then
a rank-2b update per 32-column panel. A complex A gives a real
bidiagonal, because larfg's betas are real (the zgebrd property).

Stage 2: ``bdsqr`` maps the bidiagonal to its 2k × 2k Golub–Kahan
tridiagonal and runs it through stedc (``linalg/stedc.py``: the merges
on the device, their secular roots on P9); the band arm embeds the band
in the perfect-shuffled [[0, Bᴴ], [B, 0]] and runs hb2td, stedc and
unmtr_hb2td on it. Below ``_BAND_DC_MIN`` the band takes a dense
``torch.linalg.svd`` (the reference's plain ``jnp.linalg.svd`` there).
The back-transforms are stacked block reflectors applied by gemms; every
T factor comes from ``blocked.larft_b`` (P1 at its leaves).

As in ``linalg/eig.py``, each reduction works in place on one working
copy and touches only the active trailing block, and every loop count is
a host ``int``; the results keep the reference's layouts. Each stage is
called through its module-level name (``obs/stages.SVD_STAGES``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense, resolve_device
from ..core.types import (MatrixKind, MethodSVD, Options, Side, Uplo,
                          DEFAULT_OPTIONS)
from ..ops import blocked
from ..ops.hopper_ops import abs2, larfg
from .eig import _real_dtype, hb2td, unmtr_hb2td
from .qr import geqrf, unmqr
from .stedc import stedc

_DC_MIN_N = 2048     # MethodSVD.Auto takes the DC path from this order
_BD_PANEL = 32       # labrd panel width of ge2bd
_BAND_DC_MIN = 1024  # below this the band takes a dense SVD
_BD_EPS = float(np.finfo(np.float64).eps)

Reflectors = List[Tuple[int, torch.Tensor, torch.Tensor]]


def _working_copy(A: TiledMatrix) -> torch.Tensor:
    """A's padded storage (op applied) as a new contiguous tensor."""
    a = A.dense_canonical()
    if a.data_ptr() == A.data.data_ptr():
        a = a.clone()
    return a.resolve_conj().contiguous()


# ---------------------------------------------------------------------------
# ge2tb: full → band
# ---------------------------------------------------------------------------

def _panel_qr(P: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Householder QR of the (h × w) panel ``P`` IN PLACE, the reflector
    of column j pivoting at row j; v goes to column j of ``V`` (h rows,
    zero above the pivot). Columns whose pivot is past the last row are
    no-ops with τ = 0 and v = 0. R stays in P's upper triangle and the
    entries below it are set to zero. Returns the taus."""
    h, w = P.shape
    taus = P.new_zeros(w)
    for j in range(min(w, h)):
        col = P[j:, j]
        beta, tau, scale = larfg(col[0], abs2(col[1:]).sum())
        v = V[j:, j]
        v[0] = 1
        v[1:] = col[1:] * scale
        w_row = v.conj() @ P[j:, j:]
        P[j:, j:] -= torch.outer(tau.conj() * v, w_row)
        taus[j] = tau
    top = min(w, h)
    P[:top].copy_(torch.triu(P[:top]))
    P[top:] = 0
    return taus


def _larft(V: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """The T factor of one panel through the batched ``larft_b`` (P1)."""
    return blocked.larft_b(V[None], taus[None])[0]


def _ge2tb_level(a: torch.Tensor, nb: int, kp: int):
    """One ge2tb level, IN PLACE on the (sm × sn) ``a``: reduce its first
    ``kp`` panels to upper band form. Panel k's left QR pivots at row
    k·nb and reflects the columns right of the panel; its right LQ (of
    the panel's row block, as the QR of its conjugate transpose) pivots at
    column (k+1)·nb and reflects the rows below the block. A panel whose
    LQ falls off the right edge has none (V = 0, T = 0). Returns (Vls,
    Tls, Vrs, Trs): (kp, sm, nb), (kp, nb, nb), (kp, sn, nb), (kp, nb,
    nb)."""
    sm, sn = a.shape
    Vls = a.new_zeros((kp, sm, nb))
    Tls = a.new_zeros((kp, nb, nb))
    Vrs = a.new_zeros((kp, sn, nb))
    Trs = a.new_zeros((kp, nb, nb))
    for k in range(kp):
        k0, k1 = k * nb, (k + 1) * nb
        # left QR of the panel's columns; Hᴴ on the columns right of it
        Vl = Vls[k, k0:]
        tl = _panel_qr(a[k0:, k0:k1], Vl)
        Tl = Tls[k]
        Tl.copy_(_larft(Vls[k], tl))
        c = a[k0:, k1:]
        c -= Vl @ (Tl.mH @ (Vl.mH @ c))
        if k1 >= sn:
            continue
        # right LQ of the row block: the QR of its conjugate transpose,
        # then a ← a·H on the rows below the block
        G = a[k0:k1, k1:].mH.resolve_conj().clone()
        Vr = Vrs[k, k1:]
        tr = _panel_qr(G, Vr)
        Tr = Trs[k]
        Tr.copy_(_larft(Vrs[k], tr))
        c = a[k1:, k1:]
        c -= ((c @ Vr) @ Tr) @ Vr.mH
        a[k0:k1, k1:] = G.mH
    return Vls, Tls, Vrs, Trs


@accurate_matmuls
def ge2tb(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS):
    """Reduce A (m ≥ n) to upper band form B = Uᴴ·A·V with bandwidth nb
    (slate::ge2tb). Returns (band (mpad, npad), u_refl, v_refl): lists of
    (offset, Vs, Ts) per level of ``blocked.level_plan``; panel k of a
    level pivots at global row offset + k·nb (U) and column offset +
    (k+1)·nb (V). The padding stays zero (never an identity): zero
    padding adds exact zero singular values, which sort last."""
    nb = A.nb
    a = _working_copy(A)
    kt = a.shape[1] // nb
    u_refl: Reflectors = []
    v_refl: Reflectors = []
    off = 0
    for kp in blocked.level_plan(kt):
        Vls, Tls, Vrs, Trs = _ge2tb_level(a[off:, off:], nb, kp)
        u_refl.append((off, Vls, Tls))
        v_refl.append((off, Vrs, Trs))
        off += kp * nb
    return a, u_refl, v_refl


def _apply_levels(refl: Reflectors, C: torch.Tensor, nb: int, trans: bool,
                  shift: int) -> torch.Tensor:
    """C ← Q·C (or Qᴴ·C) IN PLACE for Q = H₀·H₁·… in level order; panel
    k of a level acts on the rows from offset + (k + shift)·nb."""
    levels = refl if trans else list(reversed(refl))
    apply = (blocked.apply_block_reflectors_stacked_H if trans
             else blocked.apply_block_reflectors_stacked)
    for off, Vs, Ts in levels:
        apply(Vs, Ts, C[off:], [(k + shift) * nb for k in range(Vs.shape[0])])
    return C


def _apply_u(u_refl: Reflectors, C: torch.Tensor, nb: int,
             trans: bool) -> torch.Tensor:
    """U·C (or Uᴴ·C) for ge2tb's U; returns a new tensor."""
    return _apply_levels(u_refl, C.clone(), nb, trans, 0)


def _apply_v(v_refl: Reflectors, C: torch.Tensor, nb: int,
             trans: bool) -> torch.Tensor:
    """V·C (or Vᴴ·C) for ge2tb's V (each panel one block lower than U's);
    returns a new tensor."""
    return _apply_levels(v_refl, C.clone(), nb, trans, 1)


@accurate_matmuls
def unmbr_ge2tb(u_refl: Reflectors, v_refl: Reflectors, u: torch.Tensor,
                v: torch.Tensor, nb: int):
    """The back-transform of the band's singular vectors: (U·u, V·v)."""
    return _apply_u(u_refl, u, nb, False), _apply_v(v_refl, v, nb, False)


# ---------------------------------------------------------------------------
# ge2bd: full → bidiagonal (labrd/gebrd)
# ---------------------------------------------------------------------------

def _ge2bd(a: torch.Tensor, b: int = _BD_PANEL):
    """Blocked Householder bidiagonalization Q_lᴴ·A·Q_r = bidiag(d, e),
    IN PLACE on the padded ``a`` (LAPACK's gebrd/labrd, the reference's
    ``_ge2bd_jit``).

    Column jj of panel k (j = jj − k·b): its entries from row jj, corrected
    by the panel's earlier columns (A − Vl·Yᴴ − X·Urᴴ), give the left
    reflector v (pivot row jj, d[jj] = its beta); y = τₗ·(A_updᴴ·v) on the
    columns right of jj; row jj of A_upd − yᴴ from column jj + 1 gives the
    right reflector u (pivot column jj + 1, e[jj] = its beta; it acts on
    the conjugated row); x = τᵣ·(A_upd − v·yᴴ)·u on the rows below jj. The
    last column has no right reflector (u = 0, τ = 0). After the panel
    the trailing block takes A − Vl·Yᴴ − X·Urᴴ. Returns (d, e real,
    Vls (panels, mpad, b), TauLs, Urs (panels, npad, b), TauRs)."""
    mpad, npad = a.shape
    kt = min(mpad, npad)
    n_panels = max(1, -(-kt // b))
    rdt = _real_dtype(a.dtype)
    d = torch.zeros(kt, dtype=rdt, device=a.device)
    e = torch.zeros(max(kt - 1, 0), dtype=rdt, device=a.device)
    Vls = a.new_zeros((n_panels, mpad, b))
    Urs = a.new_zeros((n_panels, npad, b))
    TauLs = a.new_zeros((n_panels, b))
    TauRs = a.new_zeros((n_panels, b))
    for k in range(n_panels):
        j0 = k * b
        Vl, Ur = Vls[k], Urs[k]
        Y = a.new_zeros((npad, b))
        X = a.new_zeros((mpad, b))
        ncols = min(b, kt - j0)
        for j in range(ncols):
            jj = j0 + j
            Vp, Yp, Xp, Up = Vl[:, :j], Y[:, :j], X[:, :j], Ur[:, :j]
            col = a[jj:, jj] - Vp[jj:] @ Yp[jj].conj() \
                - Xp[jj:] @ Up[jj].conj()
            beta, tau_l, scale = larfg(col[0], abs2(col[1:]).sum())
            d[jj] = beta.real
            v = Vl[jj:, j]
            v[0] = 1
            v[1:] = col[1:] * scale
            TauLs[k, j] = tau_l
            if jj + 1 >= npad:
                continue
            # y on the columns right of jj (v is zero above row jj)
            c1 = jj + 1
            y = tau_l * (a[jj:, c1:].mH @ v
                         - Yp[c1:] @ (Vp[jj:].mH @ v)
                         - Up[c1:] @ (Xp[jj:].mH @ v))
            Y[c1:, j] = y
            row = a[jj, c1:] - (Yp[c1:] @ Vp[jj].conj()).conj() \
                - (Up[c1:] @ Xp[jj].conj()).conj() - y.conj()
            g = row.conj()
            beta_r, tau_r, scale_r = larfg(g[0], abs2(g[1:]).sum())
            if jj + 1 < kt:
                e[jj] = beta_r.real
            u = Ur[c1:, j]
            u[0] = 1
            u[1:] = g[1:] * scale_r
            TauRs[k, j] = tau_r
            # x on the rows below jj (u is zero left of column jj + 1)
            x = tau_r * (a[c1:, c1:] @ u
                         - Vp[c1:] @ (Yp[c1:].mH @ u)
                         - Xp[c1:] @ (Up[c1:].mH @ u)
                         - v[1:] * torch.vdot(y, u))
            X[c1:, j] = x
        j1 = j0 + ncols
        a22 = a[j1:, j1:]
        a22 -= Vl[j1:] @ Y[j1:].mH + X[j1:] @ Ur[j1:].mH
    return d, e, Vls, TauLs, Urs, TauRs


@accurate_matmuls
def ge2bd(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS):
    """Bidiagonalize A (m ≥ n): (d, e, (Vl, Tl), (Ur, Tr)) with
    Q_lᴴ·A·Q_r = bidiag(d, e) upper on the padded size, d and e real for
    every type, Q_l = ∏ₖ(I − VlₖTlₖVlₖᴴ) (panel k's reflectors pivot at
    rows k·32 + j) and Q_r the same from Ur, Tr (pivots one column
    right). The T factors come from ``blocked.larft_b`` (P1)."""
    d, e, Vls, TauLs, Urs, TauRs = _ge2bd(_working_copy(A))
    return (d, e, (Vls, blocked.larft_b(Vls, TauLs)),
            (Urs, blocked.larft_b(Urs, TauRs)))


@accurate_matmuls
def unmbr_ge2bd(ql, qr, u: torch.Tensor, v: torch.Tensor):
    """The back-transform of the bidiagonal's singular vectors:
    (Q_l·u, Q_r·v) for ge2bd's ((Vl, Tl), (Ur, Tr)); new tensors."""
    (Vl, Tl), (Ur, Tr) = ql, qr
    b = Vl.shape[2]
    panels = range(Vl.shape[0])
    U = blocked.apply_block_reflectors_stacked(
        Vl, Tl, u.clone(), [k * b for k in panels])
    V = blocked.apply_block_reflectors_stacked(
        Ur, Tr, v.clone(), [k * b + 1 for k in panels])
    return U, V


# ---------------------------------------------------------------------------
# bdsqr: the bidiagonal's SVD through the Golub–Kahan tridiagonal
# ---------------------------------------------------------------------------

def _renormalise(u: torch.Tensor, v: torch.Tensor):
    """Each column of u and v scaled to unit norm (zero columns kept): at a
    tiny σ the ±σ pair is near-degenerate and its vector may split
    unevenly between the two halves."""
    un = torch.linalg.vector_norm(u, dim=0)
    vn = torch.linalg.vector_norm(v, dim=0)
    return (u / torch.where(un == 0, 1.0, un).to(u.dtype),
            v / torch.where(vn == 0, 1.0, vn).to(v.dtype))


def _complete(mats, g: int, klog: int):
    """Rank deficiency: the ±0 eigenspace of the Golub–Kahan matrix mixes
    the u/v pairs arbitrarily, so the columns g..klog (σ ≈ 0) are rebuilt
    IN PLACE as an orthonormal completion of the first g, from e₀..e_{klog−1}
    by one QR: span(v_good)⊥ = null(B) and span(u_good)⊥ = null(Bᴴ), and
    the completed columns stay inside the first klog coordinates."""
    for mat in mats:
        basis = torch.eye(mat.shape[0], klog, dtype=mat.dtype,
                          device=mat.device)
        qc, _ = torch.linalg.qr(torch.cat([mat[:, :g], basis], dim=1))
        mat[:, g:klog] = qc[:, g:klog]


def bdsqr(d, e, compute_uv: bool = False, logical_k: Optional[int] = None,
          device=None):
    """Singular values (and vectors) of the real upper bidiagonal (d, e)
    (slate::bdsqr), by stedc on its Golub–Kahan tridiagonal: the 2k × 2k
    symmetric matrix with a zero diagonal and the off-diagonal (d₁, e₁,
    d₂, …, d_k), whose eigenpairs are ±σᵢ with the shuffled vector
    (v₁, u₁, v₂, u₂, …)/√2. Returns σ descending (float64, on ``device``),
    and with ``compute_uv`` also U and Vᵀ of B (k × k float64 tensors on
    ``device``).

    ``device``: where stedc's merges run and the results live ("cuda"
    unless asked for the CPU; no card raises). ``logical_k``: for a
    zero-padded bidiagonal, the logical size: the σ ≈ 0 columns are then
    completed inside the first logical_k coordinates, so cropping to the
    logical rows keeps them unit-norm. A complex (d, e) raises, as
    LAPACK's zbdsqr takes a real bidiagonal."""
    if any(x.is_complex() if isinstance(x, torch.Tensor)
           else np.iscomplexobj(x) for x in (d, e)):
        raise SlateError("bdsqr: d and e must be real (complex matrices "
                         "carry a real bidiagonal; absorb phases into "
                         "the left/right transforms)")
    dev = resolve_device("cuda" if device is None else device)
    d = _host64(d)
    e = _host64(e)
    k = d.size
    f64 = torch.float64
    if k == 0:
        z = torch.zeros((0, 0), dtype=f64, device=dev)
        s = torch.zeros(0, dtype=f64, device=dev)
        return (s, z, z.clone()) if compute_uv else s
    off = np.empty(2 * k - 1)
    off[0::2] = d
    off[1::2] = e
    tzero = np.zeros(2 * k)
    if not compute_uv:
        w, _ = stedc(tzero, off, compute_z=False, device=dev)
        return torch.as_tensor(np.sort(w[k:])[::-1].copy(), device=dev)
    w, q = stedc(tzero, off, device=dev)
    sig = w[k:]                      # the ascending positive half
    order = np.argsort(sig)[::-1].copy()
    sig = sig[order]
    cols = torch.as_tensor(order + k, device=dev)
    Q = q[:, cols]
    u, v = _renormalise(math.sqrt(2.0) * Q[1::2], math.sqrt(2.0) * Q[0::2])
    klog = k if logical_k is None else min(logical_k, k)
    tol = max(sig[0], 0.0) * 8 * k * _BD_EPS
    g = int((sig > tol).sum())
    if g < klog:
        _complete((u, v), g, klog)
    return torch.as_tensor(sig, device=dev), u, v.T.contiguous()


def _host64(x) -> np.ndarray:
    """A 1-D float64 numpy copy of x (numpy array or tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.array(x, np.float64).reshape(-1)


# ---------------------------------------------------------------------------
# the driver's arms
# ---------------------------------------------------------------------------

def _svd_dc(A: TiledMatrix, opts: Options, want_vectors: bool):
    """DC arm (all types: the bidiagonal is real): ge2bd, bdsqr on the
    float64 (d, e), the basis cast to A's type and back-transformed by the
    stacked reflectors."""
    m, n = A.shape
    k = min(m, n)
    rdt = _real_dtype(A.dtype)
    d, e, ql, qr = ge2bd(A, opts)
    if not want_vectors:
        s = bdsqr(d, e, compute_uv=False, device=A.device)
        return s[:k].to(rdt), None, None
    s, ub, vbt = bdsqr(d, e, compute_uv=True, logical_k=k, device=A.device)
    kt = d.shape[0]
    mpad, npad = ql[0].shape[1], qr[0].shape[1]
    u_pad = torch.zeros((mpad, k), dtype=A.dtype, device=A.device)
    v_pad = torch.zeros((npad, k), dtype=A.dtype, device=A.device)
    u_pad[:kt] = ub[:, :k].to(A.dtype)
    v_pad[:kt] = vbt.T[:, :k].to(A.dtype)
    U, V = unmbr_ge2bd(ql, qr, u_pad, v_pad)
    return (s[:k].to(rdt),
            from_dense(U, A.nb, logical_shape=(m, k), device=A.device),
            from_dense(V, A.nb, logical_shape=(n, k), device=A.device))


def _svd_band_gk(A: TiledMatrix, band: torch.Tensor, u_refl: Reflectors,
                 v_refl: Reflectors, k: int, want_vectors: bool,
                 complete: bool = True):
    """The band arm: embed the upper band B in the perfect-shuffled
    Hermitian [[0, Bᴴ], [B, 0]] (bandwidth 2·nb), then hb2td, stedc and
    unmtr_hb2td on it; the top k eigenpairs (+σ, (v, u)/√2 interleaved)
    are the SVD. The embedding is stored dense, (2·npad)², as hb2td takes
    it. ``complete``: rebuild the σ ≈ 0 columns as an orthonormal
    completion (``_complete``; its rank count reads σ on the host); the
    served ``svd_staged`` skips it, as the reference's does."""
    mpad, npad = band.shape
    nbw = A.nb
    m, n = A.shape
    dev = A.device
    rdt = _real_dtype(A.dtype)
    bsq = band[:npad, :npad]
    s2 = 2 * npad
    C = torch.zeros((s2, s2), dtype=bsq.dtype, device=dev)
    C[1::2, 0::2] = bsq
    C[0::2, 1::2] = bsq.mH
    CB = from_dense(C, nbw, kind=MatrixKind.HermitianBand, uplo=Uplo.Lower,
                    kl=2 * nbw, ku=2 * nbw, logical_shape=(s2, s2),
                    device=dev)
    d, e, Vh, Th, phase = hb2td(CB)
    dn = d[:s2].double().cpu().numpy()
    en = e[:s2 - 1].double().cpu().numpy()
    if not want_vectors:
        w, _ = stedc(dn, en, compute_z=False, device=dev)
        # roundoff can push an exact-zero ±σ pair slightly negative
        sig = np.maximum(np.sort(w)[::-1][:k], 0.0)
        return torch.as_tensor(sig.copy(), device=dev).to(rdt), None, None
    w, z = stedc(dn, en, device=dev)
    order = np.argsort(w)[::-1][:k].copy()
    sig = np.maximum(w[order], 0.0)
    zt = z[:, torch.as_tensor(order, device=dev)].to(C.dtype)
    zb = unmtr_hb2td(Vh, Th, zt, phase)[:s2]
    r2 = math.sqrt(2.0)
    u, v = _renormalise(zb[1::2] * r2, zb[0::2] * r2)
    tol = (sig[0] if k else 0.0) * 8 * s2 * _BD_EPS
    g = int((sig > tol).sum())
    if complete and g < k:
        _complete((u, v), g, k)
    u_pad = torch.zeros((mpad, k), dtype=C.dtype, device=dev)
    u_pad[:npad] = u
    Uf, Vf = unmbr_ge2tb(u_refl, v_refl, u_pad, v, nbw)
    return (torch.as_tensor(sig.copy(), device=dev).to(rdt),
            from_dense(Uf, nbw, logical_shape=(m, k), device=dev),
            from_dense(Vf, nbw, logical_shape=(n, k), device=dev))


def _svd_band_dense(A: TiledMatrix, band: torch.Tensor, u_refl: Reflectors,
                    v_refl: Reflectors, k: int, want_vectors: bool):
    """The small band arm: one dense SVD of the band's square block (as
    the reference, outside any kernel). Its padding rows and columns are
    exactly zero, so the padding's σ are exactly 0 and sort last."""
    mpad, npad = band.shape
    m, n = A.shape
    nb = A.nb
    bsq = band[:npad, :npad]
    if not want_vectors:
        return torch.linalg.svdvals(bsq)[:k], None, None
    ub, s, vbt = torch.linalg.svd(bsq, full_matrices=False)
    u_pad = torch.zeros((mpad, k), dtype=ub.dtype, device=A.device)
    u_pad[:npad] = ub[:, :k]
    Uf, Vf = unmbr_ge2tb(u_refl, v_refl, u_pad, vbt[:k].mH, nb)
    return (s[:k], from_dense(Uf, nb, logical_shape=(m, k), device=A.device),
            from_dense(Vf, nb, logical_shape=(n, k), device=A.device))


@accurate_matmuls
def svd(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS,
        want_vectors: bool = False
        ) -> Tuple[torch.Tensor, Optional[TiledMatrix], Optional[TiledMatrix]]:
    """Singular value decomposition (slate::svd) with the reference's
    MethodSVD dispatch, in every type (complex reduces to a real
    bidiagonal or a complex band): a wide A goes through Aᴴ; DC (and Auto
    at min(m, n) ≥ ``_DC_MIN_N``) with m < 2n runs ge2bd + bdsqr; m ≥ 2n
    takes geqrf, the SVD of R and unmqr of [U_R; 0]; otherwise ge2tb and
    the band arm (hb2td + stedc on the Golub–Kahan embedding) at
    npad ≥ ``_BAND_DC_MIN`` and npad ≥ 3·nb, or a dense SVD of the band.

    Returns (σ descending in the real type, U or None, V or None) with
    A = U·Σ·Vᴴ, thin U (m × k) and V (n × k), k = min(m, n), on A's
    device."""
    m, n = A.shape
    nb = A.nb
    if m < n:
        s, V, U = svd(A.H, opts, want_vectors=want_vectors)
        return s, U, V
    method = opts.method_svd
    if method is MethodSVD.Auto and min(m, n) >= _DC_MIN_N:
        method = MethodSVD.DC
    if method is MethodSVD.DC and m < 2 * n:
        return _svd_dc(A, opts, want_vectors)
    if m >= 2 * n:
        QR = geqrf(A, opts)
        R = from_dense(QR.r_matrix.full_dense_canonical(), nb,
                       logical_shape=(n, n), device=A.device)
        s, Ur, V = svd(R, opts, want_vectors=want_vectors)
        if not want_vectors:
            return s, None, None
        ur = Ur.dense_canonical()
        u_full = ur.new_zeros((-(-m // nb) * nb, ur.shape[1]))
        u_full[:ur.shape[0]] = ur
        U = unmqr(Side.Left, QR, from_dense(u_full, nb, logical_shape=(m, n),
                                            device=A.device),
                  trans=False, opts=opts)
        return s, U, V
    band, u_refl, v_refl = ge2tb(A, opts)
    npad = band.shape[1]
    k = min(m, n)
    if npad >= _BAND_DC_MIN and npad >= 3 * nb:
        return _svd_band_gk(A, band, u_refl, v_refl, k, want_vectors)
    return _svd_band_dense(A, band, u_refl, v_refl, k, want_vectors)
