"""Hermitian eigensolvers: heev, hegv, hegst, he2hb, unmtr_he2hb, hb2td,
unmtr_hb2td, he2td, unmtr_he2td, steqr, sterf (counterpart of
``slate_tpu/linalg/eig.py``; stedc is ``linalg/stedc.py``).

Stage 1 has two strategies (``Options.eig_stage1``): ``he2td``, the
direct blocked tridiagonalization (LAPACK's latrd/sytrd: one matrix-
vector product per column, a rank-2b update per 64-column panel), and
``two_stage``, he2hb's band reduction (panel QR and a two-sided update per
nb columns) then hb2td's bulge chase on 3b × 3b windows. Stage 3 is
stedc's divide & conquer (``linalg/stedc.py``: the merges on the device,
their secular roots on P9) or the port's own host steqr
(``csrc/host/steqr.cc``, built with g++ at first use); the
back-transforms are stacked block reflectors applied by gemms.

The reference's fixed-shape full-matrix masks exist so that XLA compiles
one program; here each column's product and each panel's update touch
only the active trailing block, as LAPACK's do, and every loop count is
a host ``int``. The results keep the reference's layouts: he2td's
(d, e, Vs (k, npad, 64), Ts), he2hb's [(offset, Vs, Ts)] per level of
``blocked.level_plan`` and hb2td's (d, e, Vh (sweeps, hops, b),
Th (sweeps, hops), phase). Each driver works in place on one working
copy of its operand.

``MethodEig.DC`` and ``MethodEig.Auto`` at n ≥ ``_DC_MIN_N`` run stedc;
``MethodEig.QR`` above the steqr cap warns as the reference does and
runs stedc too, decided from n alone before any device work.
"""

from __future__ import annotations

import ctypes
import dataclasses
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense, unit_pad_diag
from ..core.types import (MatrixKind, MethodEig, Norm, Options, Side, Uplo,
                          DEFAULT_OPTIONS)
from ..ops import _build, blocked
from ..ops.hopper_ops import abs2, larfg
from . import blas3
from .norms import norm
from .stedc import stedc

# Auto takes the dense eigh of he2hb's band below this order, stedc above
_DC_MIN_N = 2048
_TD_PANEL = 64       # latrd panel width of he2td
_STEQR_MAX_N = 8192  # QR iteration with vectors is Θ(n³) on the host


def _working_copy(A: TiledMatrix) -> torch.Tensor:
    """The full canonical matrix of A as a new contiguous tensor (never
    A's own storage)."""
    a = A.full_dense_canonical()
    if a.data_ptr() == A.data.data_ptr():
        a = a.clone()
    return a.resolve_conj().contiguous()


# ---------------------------------------------------------------------------
# stage 1: full → band
# ---------------------------------------------------------------------------

def _he2hb_level(a: torch.Tensor, nb: int, kp: int):
    """One he2hb level, IN PLACE on the s × s Hermitian ``a``: reduce its
    first ``kp`` panels to band form. Returns (Vs (kp, s, nb),
    Ts (kp, nb, nb)); panel k's reflector lives on rows ≥ (k+1)·nb."""
    s = a.shape[0]
    Vs = a.new_zeros((kp, s, nb))
    Ts = a.new_zeros((kp, nb, nb))
    for k in range(kp):
        k0, j0 = k * nb, (k + 1) * nb
        P = a[j0:, k0:j0].clone()  # the panel below its diagonal block
        V = Vs[k, j0:]
        taus = a.new_zeros(nb)
        for j in range(nb):
            # QR of column j below row j0 + j; Hᴴ = I − conj(τ)·v·vᴴ
            # applied to the columns ≥ j of the panel
            col = P[j:, j]
            beta, tau, scale = larfg(col[0], abs2(col[1:]).sum())
            v = V[j:, j]
            v[0] = 1
            v[1:] = col[1:] * scale
            w_row = v.conj() @ P[j:, j:]
            P[j:, j:] -= torch.outer(tau.conj() * v, w_row)
            taus[j] = tau
        T = blocked.larft(Vs[k], taus)
        # two-sided update of the trailing block a[j0:, j0:]
        a22 = a[j0:, j0:]
        y = a22 @ (V @ T)
        wmat = y - 0.5 * (V @ (T.mH @ (V.mH @ y)))
        a22 -= V @ wmat.mH + wmat @ V.mH
        a22.copy_(0.5 * (a22 + a22.mH))
        # band writes: [R; 0] in the panel's columns, Rᴴ in its rows
        r = torch.triu(P[:nb])
        a[j0:, k0:j0] = 0
        a[j0:j0 + nb, k0:j0] = r
        a[k0:j0, j0:] = a[j0:, k0:j0].mH
        Ts[k] = T
    return Vs, Ts


@accurate_matmuls
def he2hb(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS):
    """Reduce Hermitian A to band form (bandwidth nb): A = Q·B·Qᴴ.

    Returns (B as a HermitianBand TiledMatrix, reflectors), where
    ``reflectors`` is a list of (offset, Vs, Ts) entries, one per level
    of ``blocked.level_plan``: panel k of an entry is the block reflector
    acting on global rows ≥ offset + (k+1)·nb."""
    if A.kind not in (MatrixKind.Hermitian, MatrixKind.Symmetric):
        raise SlateError("he2hb: A must be Hermitian/Symmetric")
    n, nb = A.shape[0], A.nb
    a = unit_pad_diag(_working_copy(A), n, n)
    nt = a.shape[0] // nb
    reflectors: List[Tuple[int, torch.Tensor, torch.Tensor]] = []
    off = 0
    for kp in blocked.level_plan(nt - 1):
        Vs, Ts = _he2hb_level(a[off:, off:], nb, kp)
        reflectors.append((off, Vs, Ts))
        off += kp * nb
    band = from_dense(a, nb, kind=MatrixKind.HermitianBand, uplo=Uplo.Lower,
                      kl=nb, ku=nb, logical_shape=(n, n), device=a.device)
    return band, reflectors


@accurate_matmuls
def unmtr_he2hb(reflectors, C: torch.Tensor,
                trans: bool = False) -> torch.Tensor:
    """Q·C (or Qᴴ·C with ``trans``) for he2hb's Q = H₀·H₁·… in level
    order (slate::unmtr_he2hb). Returns a new tensor."""
    C = C.clone()
    order = reflectors if trans else list(reversed(reflectors))
    apply = (blocked.apply_block_reflectors_stacked_H if trans
             else blocked.apply_block_reflectors_stacked)
    for off, Vs, Ts in order:
        nb = Vs.shape[2]
        apply(Vs, Ts, C[off:], [(k + 1) * nb for k in range(Vs.shape[0])])
    return C


# ---------------------------------------------------------------------------
# stage 2: band → tridiagonal (bulge chasing)
# ---------------------------------------------------------------------------

def chase_hops(s: int, b: int) -> List[int]:
    """Hops of each sweep of hb2td's chase on an s × s band of width b:
    sweep j annihilates column j and chases its bulge to the bottom."""
    return [max(0, (s - 3 - j) // b + 1) for j in range(max(s - 2, 0))]


def _hb2td(a: torch.Tensor, b: int):
    """Band → tridiagonal Householder bulge chase, IN PLACE on the dense
    s × s band ``a`` (the reference's ``_hb2td_jit``; SLATE's hb2st).

    Hop t of sweep j reflects rows [p, p + b), p = j + 1 + t·b, inside
    the 3b × 3b window at w0 = clip(p − b, 0, s − 3b): from the column
    being annihilated (j at t = 0, else the bulge's column p − b), then
    two-sided. Every hop of ``chase_hops`` has p ≤ s − 2, so none is the
    reference's masked no-op. Returns (d, e, Vh, Th, phase)."""
    s = a.shape[0]
    w = 3 * b
    hops = chase_hops(s, b)
    max_hops = -(-s // b)
    Vh = a.new_zeros((max(s - 2, 1), max_hops, b))
    Th = a.new_zeros((max(s - 2, 1), max_hops))
    for j, nh in enumerate(hops):
        for t in range(nh):
            p = j + 1 + t * b
            c_col = j if t == 0 else p - b
            w0 = min(max(p - b, 0), s - w)
            q = p - w0
            hi = min(q + b, w)  # the reflector's rows, clipped at the bottom
            W = a[w0:w0 + w, w0:w0 + w]
            col = W[q:hi, c_col - w0]
            beta, tau, scale = larfg(col[0], abs2(col[1:]).sum())
            v = Vh[j, t, :hi - q]
            v[0] = 1
            v[1:] = col[1:] * scale
            # W ← Hᴴ·W·H, H = I − τ·v·vᴴ on rows/cols [q, hi)
            rows = W[q:hi]
            rows -= torch.outer(tau.conj() * v, v.conj() @ rows)
            cols = W[:, q:hi]
            cols -= torch.outer(tau * (cols @ v), v.conj())
            Th[j, t] = tau
    d = a.diagonal().real.clone()
    # the chase leaves a complex subdiagonal in general; scale it real
    # with the diagonal similarity Dᴴ·T·D (LAPACK zhbtrd): phase = diag(D)
    # must premultiply the tridiagonal eigenvectors
    ec = a.diagonal(-1)
    mag = ec.abs()
    pu = torch.where(mag > 0, ec / torch.where(mag > 0, mag, 1),
                     torch.ones_like(ec))
    phase = torch.cat([torch.ones(1, dtype=a.dtype, device=a.device),
                       torch.cumprod(pu, 0)])
    return d, mag.to(d.dtype), Vh, Th, phase


@accurate_matmuls
def hb2td(B: TiledMatrix):
    """Tridiagonalize a Hermitian band matrix: (d, e, Vh, Th, phase) with
    (Q₂·D)ᴴ·B·(Q₂·D) = tridiag(d, e) on the padded size, D = diag(phase).
    Use unmtr_hb2td to apply Q₂·D. The padding is used as stored (a band
    from he2hb carries its reduced pad block)."""
    if B.kind is not MatrixKind.HermitianBand:
        raise SlateError("hb2td: B must be a Hermitian band matrix")
    a = _working_copy(B)
    nb = B.kl
    if a.shape[0] < 3 * nb:
        raise SlateError(
            f"hb2td: padded size {a.shape[0]} < 3·bandwidth {3 * nb}; "
            "use the dense path for tiny problems")
    return _hb2td(a, nb)


@accurate_matmuls
def unmtr_hb2td(Vh: torch.Tensor, Th: torch.Tensor, C: torch.Tensor,
                phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C ← Q₂·D·C for hb2td's (Q₂, phase = diag(D)) (SLATE's
    unmtr_hb2st). Sweeps apply in reverse; the hops of one sweep have
    disjoint row supports, so each sweep is one batched update of its
    rows. Returns a new tensor."""
    n_sweeps, _, b = Vh.shape
    s, c = C.shape
    Zp = C.new_zeros((s + b, c), dtype=Vh.dtype)
    Zp[:s] = C
    if phase is not None:
        Zp[:s] *= phase[:, None]
    hops = chase_hops(s, b)
    for j in reversed(range(min(n_sweeps, len(hops)))):
        nh = hops[j]
        if nh == 0:
            continue
        seg = Zp[j + 1:j + 1 + nh * b].view(nh, b, c)
        V = Vh[j, :nh]
        coef = torch.einsum("hb,hbc->hc", V.conj(), seg)
        seg -= (Th[j, :nh, None] * coef)[:, None, :] * V[:, :, None]
    return Zp[:s]


# ---------------------------------------------------------------------------
# direct blocked tridiagonalization
# ---------------------------------------------------------------------------

def _he2td(a: torch.Tensor, b: int = _TD_PANEL):
    """Blocked Householder tridiagonalization Qᴴ·A·Q = tridiag(d, e),
    IN PLACE on the padded Hermitian ``a`` (LAPACK's sytrd/latrd, the
    reference's ``_he2td_jit``).

    Column jj of panel k: its entries from row jj, corrected by the
    panel's earlier columns (A − V·Wᴴ − W·Vᴴ), give d[jj] and, by larfg
    below row jj + 1, e[jj] and the reflector v; then x = (A − V·Wᴴ −
    W·Vᴴ)·v on the trailing rows and w = τ·x − ½|τ|²(vᴴx)·v. After the
    panel the trailing block takes the rank-2b update. The last column
    (jj = npad − 1) has no reflector: its V column and tau stay zero, as
    the reference's guard leaves them. Returns (d real, e real, Vs (k,
    npad, b), Ts (k, b, b)); Q = P₀·P₁·… with Pₖ = I − VₖTₖVₖᴴ."""
    npad = a.shape[0]
    n_panels = max(1, -(-(npad - 1) // b))
    rdt = a.real.dtype if a.is_complex() else a.dtype
    d = torch.zeros(npad, dtype=rdt, device=a.device)
    e = torch.zeros(max(npad - 1, 0), dtype=rdt, device=a.device)
    Vs = a.new_zeros((n_panels, npad, b))
    Taus = a.new_zeros((n_panels, b))
    for k in range(n_panels):
        j0 = k * b
        V = Vs[k]
        W = a.new_zeros((npad, b))
        ncols = min(b, npad - 1 - j0)
        for j in range(ncols):
            jj = j0 + j
            col = a[jj:, jj] - V[jj:, :j] @ W[jj, :j].conj() \
                - W[jj:, :j] @ V[jj, :j].conj()
            d[jj] = col[0].real
            beta, tau, scale = larfg(col[1], abs2(col[2:]).sum())
            e[jj] = beta.real
            v = V[jj + 1:, j]
            v[0] = 1
            v[1:] = col[2:] * scale
            Vt, Wt = V[jj + 1:, :j], W[jj + 1:, :j]
            x = a[jj + 1:, jj + 1:] @ v - Vt @ (Wt.mH @ v) - Wt @ (Vt.mH @ v)
            sx = torch.vdot(v, x)
            W[jj + 1:, j] = tau * x - (0.5 * tau * tau.conj() * sx) * v
            Taus[k, j] = tau
        j1 = j0 + ncols
        a22, V2, W2 = a[j1:, j1:], V[j1:], W[j1:]
        a22 -= V2 @ W2.mH + W2 @ V2.mH
    d[npad - 1] = a[npad - 1, npad - 1].real
    Ts = blocked.larft_b(Vs, Taus)
    return d, e, Vs, Ts


@accurate_matmuls
def he2td(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS):
    """Tridiagonalize Hermitian A: (d, e, Vs, Ts) with
    Q = ∏ₖ(I − VₖTₖVₖᴴ) and Qᴴ·A·Q = tridiag(d, e) on the padded size.
    The logical entries are d[:n], e[:n−1] (the padding is a decoupled
    identity block)."""
    n = A.shape[0]
    return _he2td(unit_pad_diag(_working_copy(A), n, n))


@accurate_matmuls
def unmtr_he2td(Vs: torch.Tensor, Ts: torch.Tensor,
                C: torch.Tensor) -> torch.Tensor:
    """Q·C for he2td's Q (the back-transform of the tridiagonal
    eigenvectors): one gemm triple per panel, last panel first, each on
    the rows from its reflectors' first (k·b + 1). Returns a new
    tensor."""
    b = Vs.shape[2]
    return blocked.apply_block_reflectors_stacked(
        Vs, Ts, C.clone(), [k * b + 1 for k in range(Vs.shape[0])])


# ---------------------------------------------------------------------------
# tridiagonal eigensolvers (host)
# ---------------------------------------------------------------------------

_I64 = ctypes.c_int64
_PD = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _steqr_lib() -> ctypes.CDLL:
    """The port's host steqr library (``csrc/host/steqr.cc``), built with
    g++ at first use; a failed build raises ``SlateError``."""
    lib = _build.load_host("steqr")
    lib.st_steqr_nt.argtypes = [_I64, _PD, _PD, _PD, _I64, _I64, _I64]
    lib.st_steqr_nt.restype = _I64
    return lib


def _steqr_host(d, e, compute_z: bool, max_sweeps: int):
    """The host library on (d, e): ascending (w, z or None). Its OpenMP
    threads are bounded by torch's intra-op thread count."""
    d = np.array(d, np.float64, copy=True)
    n = d.size
    ee = np.zeros(max(n, 1), np.float64)
    ee[:n - 1] = np.asarray(e, np.float64)
    d, ee, sigma = _steqr_prescale(d, ee)
    z = np.eye(n) if compute_z else np.zeros((1, 1))
    rc = _steqr_lib().st_steqr_nt(n, d, ee, z, 1 if compute_z else 0,
                                  int(max_sweeps) * n,
                                  torch.get_num_threads())
    if rc != 0:
        raise SlateError("steqr: QR iteration did not converge within "
                         f"{max_sweeps}*n sweeps ({rc} off-diagonals "
                         "remain)")
    order = np.argsort(d, kind="stable")
    return sigma * d[order], (z[:, order] if compute_z else None)


def steqr(d, e, compute_z: bool = True,
          max_sweeps: int = 60) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Implicit-shift QR iteration on a symmetric tridiagonal matrix with
    optional eigenvector accumulation (the lapack::steqr role), on the
    host library ``csrc/host/steqr.cc``. Above ``_STEQR_MAX_N`` it
    refuses: QR iteration with vectors is Θ(n³) at rotation rates.
    Returns ascending (w, z) as float64 numpy arrays."""
    n = np.asarray(d).size
    if n > _STEQR_MAX_N:
        raise SlateError(
            f"steqr: n={n} exceeds the QR-iteration cutoff "
            f"({_STEQR_MAX_N}) — use MethodEig.DC (stedc divide & "
            "conquer) for large tridiagonals")
    if n > 1:
        return _steqr_host(d, e, compute_z, max_sweeps)
    return _steqr_py(d, e, compute_z, max_sweeps)


def sterf(d, e):
    """Eigenvalues of a real symmetric tridiagonal matrix, ascending (the
    lapack::sterf role): the host steqr without vectors. A tensor d gives
    a tensor of its dtype on its device, else float64 numpy."""
    dn = np.asarray(torch.as_tensor(d).detach().cpu(), np.float64)
    en = np.asarray(torch.as_tensor(e).detach().cpu(), np.float64)
    w = _steqr_host(dn, en, False, 60)[0] if dn.size > 1 else dn.copy()
    if isinstance(d, torch.Tensor):
        return torch.as_tensor(w, device=d.device).to(d.dtype)
    return w


def _steqr_prescale(d, e):
    """Scale (d, e) into mid exponent range before QR iteration and
    return (d', e', sigma) with eigenvalues(T) = sigma * eigenvalues(T').
    The shift computes ab*ab (overflows for |T| > ~1e154) and the
    deflation products denormalize below ~1e-154; one global scale is
    LAPACK dsteqr's per-block dlascl brackets in one step."""
    anrm = max(np.abs(d).max(initial=0.0), np.abs(e).max(initial=0.0))
    if anrm == 0.0 or 1e-120 < anrm < 1e120:
        return d, e, 1.0
    return d / anrm, e / anrm, anrm


def _laev2(a, b, c):
    """Symmetric 2x2 [[a, b], [b, c]] eigendecomposition (LAPACK dlaev2's
    formulas): (rt1, rt2, cs1, sn1) with [cs1, sn1] the unit eigenvector
    of rt1. Mirrors ``laev2`` in csrc/host/steqr.cc."""
    sm, df = a + c, a - c
    adf, tb = abs(df), b + b
    ab = abs(tb)
    acmx, acmn = (a, c) if abs(a) > abs(c) else (c, a)
    if adf > ab:
        rt = adf * np.sqrt(1.0 + (ab / adf) ** 2)
    elif adf < ab:
        rt = ab * np.sqrt(1.0 + (adf / ab) ** 2)
    else:
        rt = ab * np.sqrt(2.0)
    if sm < 0.0:
        rt1, sgn1 = 0.5 * (sm - rt), -1
        rt2 = (acmx / rt1) * acmn - (b / rt1) * b
    elif sm > 0.0:
        rt1, sgn1 = 0.5 * (sm + rt), 1
        rt2 = (acmx / rt1) * acmn - (b / rt1) * b
    else:
        rt1, rt2, sgn1 = 0.5 * rt, -0.5 * rt, 1
    if df >= 0.0:
        cs, sgn2 = df + rt, 1
    else:
        cs, sgn2 = df - rt, -1
    acs = abs(cs)
    if acs > ab:
        ct = -tb / cs
        sn1 = 1.0 / np.sqrt(1.0 + ct * ct)
        cs1 = ct * sn1
    elif ab == 0.0:
        cs1, sn1 = 1.0, 0.0
    else:
        tn = -cs / tb
        cs1 = 1.0 / np.sqrt(1.0 + tn * tn)
        sn1 = tn * cs1
    if sgn1 == sgn2:
        cs1, sn1 = -sn1, cs1
    return rt1, rt2, cs1, sn1


def _steqr_py(d, e, compute_z: bool = True, max_sweeps: int = 60):
    """The plain version of the host library's recurrence (the tests
    hold the library to it; ``steqr`` runs it only at n ≤ 1)."""
    d = np.asarray(d, dtype=np.float64).copy()
    e = np.asarray(e, dtype=np.float64).copy()
    n = d.size
    z = np.eye(n) if compute_z else None
    if n == 1:
        return d, z
    d, e, sigma = _steqr_prescale(d, e)

    def givens(f, g):
        if g == 0:
            return 1.0, 0.0, f
        if f == 0:
            return 0.0, 1.0, g
        r = np.hypot(f, g)
        return f / r, g / r, r

    eps = np.finfo(np.float64).eps
    safmin = np.finfo(np.float64).tiny
    converged = False
    for _ in range(max_sweeps * n):
        for i in range(n - 1):
            if e[i] == 0.0:
                continue
            tol = (eps * np.sqrt(abs(d[i])) * np.sqrt(abs(d[i + 1]))
                   + safmin)
            if abs(e[i]) <= tol:
                e[i] = 0.0
        hi = n - 1
        while hi > 0 and e[hi - 1] == 0.0:
            hi -= 1
        if hi == 0:
            converged = True
            break
        lo = hi - 1
        while lo > 0 and e[lo - 1] != 0.0:
            lo -= 1
        if hi - lo == 1:
            rt1, rt2, c2, s2 = _laev2(d[lo], e[lo], d[hi])
            d[lo], d[hi], e[lo] = rt1, rt2, 0.0
            if compute_z:
                zi = z[:, lo].copy()
                z[:, lo] = c2 * zi + s2 * z[:, hi]
                z[:, hi] = -s2 * zi + c2 * z[:, hi]
            continue
        a11, a22 = d[hi - 1], d[hi]
        ab = e[hi - 1]
        delta = (a11 - a22) / 2.0
        denom = delta + np.sign(delta if delta != 0 else 1.0) * np.hypot(
            delta, ab)
        mu = a22 - (ab * ab) / denom if denom != 0 else a22 - ab
        f, g = d[lo] - mu, e[lo]
        for i in range(lo, hi):
            c, s, r = givens(f, g)
            if i > lo:
                e[i - 1] = r
            m11, m12, m22 = d[i], e[i], d[i + 1]
            d[i] = c * c * m11 + 2 * c * s * m12 + s * s * m22
            d[i + 1] = s * s * m11 - 2 * c * s * m12 + c * c * m22
            e[i] = (c * c - s * s) * m12 + c * s * (m22 - m11)
            if i < hi - 1:
                bulge = s * e[i + 1]
                e[i + 1] = c * e[i + 1]
                f, g = e[i], bulge
            if compute_z:
                zi = z[:, i].copy()
                z[:, i] = c * zi + s * z[:, i + 1]
                z[:, i + 1] = -s * zi + c * z[:, i + 1]
    if not converged and np.any(e != 0.0):
        raise SlateError("steqr: QR iteration did not converge within "
                         f"{max_sweeps}*n sweeps")
    order = np.argsort(d)
    d = sigma * d[order]
    if compute_z:
        z = z[:, order]
    return d, z


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def _real_dtype(dtype):
    return torch.empty((), dtype=dtype).real.dtype


def _heev_band_dense(A: TiledMatrix, want_vectors: bool):
    """Auto below ``_DC_MIN_N``: he2hb, then a dense eigh of the band's
    logical block (as the reference, outside any kernel). The padding
    block is exactly decoupled from it, so the reference's shift of the
    padded diagonal past a Gershgorin bound (a fixed-shape eigh's need)
    is not needed; it would also scale eigh's absolute error by the
    bound, about 50·‖A‖ at n = 2000, nb = 256. A non-finite band gives
    NaN eigenpairs, as the reference's eigh returns them (torch's
    raises)."""
    n, nb = A.shape[0], A.nb
    band, reflectors = he2hb(A)
    bfull = band.full_dense_canonical()
    npad = bfull.shape[0]
    if not bool(torch.isfinite(bfull).all()):
        return _nan_eigenpairs(A, want_vectors)
    blk = bfull[:n, :n]
    if not want_vectors:
        return torch.linalg.eigvalsh(blk), None
    w, zb = torch.linalg.eigh(blk)
    zt = torch.zeros((npad, n), dtype=A.dtype, device=A.device)
    zt[:n] = zb
    z = unmtr_he2hb(reflectors, zt)
    return w, from_dense(z[:n], nb, logical_shape=(n, n), device=A.device)


def _nan_eigenpairs(A: TiledMatrix, want_vectors: bool):
    """NaN eigenvalues (and vectors) of A's order: what heev returns when
    the reduced operator is not finite (hegv after a failed potrf), where
    eigh would raise and steqr could not converge."""
    n = A.shape[0]
    w = torch.full((n,), float("nan"), dtype=_real_dtype(A.dtype),
                   device=A.device)
    if not want_vectors:
        return w, None
    z = torch.full((n, n), float("nan"), dtype=A.dtype, device=A.device)
    return w, from_dense(z, A.nb, logical_shape=(n, n), device=A.device)


def _heev_td(A: TiledMatrix, opts: Options, want_vectors: bool,
             use_steqr: bool):
    """The tridiagonal path: he2td (or he2hb + hb2td when
    ``opts.eig_stage1`` is "two_stage" and n ≥ 3·nb), stedc on A's device
    (or the host steqr with ``use_steqr``), then the back-transform on the
    device."""
    n, nb = A.shape[0], A.nb
    two_stage = opts.eig_stage1 == "two_stage" and n >= 3 * nb
    if two_stage:
        band, refl = he2hb(A, opts)
        d, e, Vh, Th, phase = hb2td(band)
    else:
        d, e, Vs, Ts = he2td(A, opts)
    dn = d[:n].double().cpu().numpy()
    en = e[:n - 1].double().cpu().numpy()
    if not (np.isfinite(dn).all() and np.isfinite(en).all()):
        return _nan_eigenpairs(A, want_vectors)
    if use_steqr:
        w, z = steqr(dn, en, compute_z=want_vectors)
    else:
        w, z = stedc(dn, en, compute_z=want_vectors, device=A.device)
    w = torch.as_tensor(w, device=A.device).to(_real_dtype(A.dtype))
    if not want_vectors:
        return w, None
    npad = d.shape[0]
    zt = torch.zeros((npad, n), dtype=A.dtype, device=A.device)
    zt[:n] = torch.as_tensor(z, device=A.device).to(A.dtype)
    if two_stage:
        Zfull = unmtr_he2hb(refl, unmtr_hb2td(Vh, Th, zt, phase))
    else:
        Zfull = unmtr_he2td(Vs, Ts, zt)
    return w, from_dense(Zfull[:n], nb, logical_shape=(n, n),
                         device=A.device)


def _heev_method(n: int, opts: Options = DEFAULT_OPTIONS) -> MethodEig:
    """The method heev runs at order n under ``opts``, from n alone and
    before any device work: DC for MethodEig.DC and for Auto at
    n ≥ ``_DC_MIN_N``; QR above ``_STEQR_MAX_N`` warns as the reference
    does and runs DC; otherwise the method asked for (Auto below
    ``_DC_MIN_N`` is the band-dense path)."""
    method = opts.method_eig
    if method is MethodEig.Auto and n >= _DC_MIN_N:
        return MethodEig.DC
    if method is MethodEig.QR and n > _STEQR_MAX_N:
        warnings.warn(
            f"heev: MethodEig.QR capped at n={_STEQR_MAX_N} "
            f"(QR iteration with vectors is Θ(n³) at rotation "
            f"rates); redirecting n={n} to MethodEig.DC",
            RuntimeWarning, stacklevel=3)
        return MethodEig.DC
    return method


@accurate_matmuls
def heev(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS,
         want_vectors: bool = True
         ) -> Tuple[torch.Tensor, Optional[TiledMatrix]]:
    """Hermitian eigensolver (slate::heev): scale, reduce, tridiagonal
    eigensolver, back-transform, rescale, with the reference's MethodEig
    dispatch (``_heev_method``): MethodEig.DC (and Auto at n ≥
    ``_DC_MIN_N``, and QR above ``_STEQR_MAX_N`` after a warning) runs
    he2td (or two_stage) + stedc + the back-transform on the device;
    MethodEig.QR the same with the host steqr; Auto below ``_DC_MIN_N``
    he2hb + a dense eigh of the band. Returns (Lambda ascending, Z or
    None) on A's device."""
    n, nb = A.shape[0], A.nb
    if n == 0:
        return torch.zeros((0,), dtype=torch.float32, device=A.device), None
    method = _heev_method(n, opts)
    # scale into the safe range, on the device: LAPACK's (and SLATE's
    # heev.cc) rmin = √(tiny/ε), rmax = 1/rmin. The reference scales to
    # √tiny and √max, where a reflector's |x|² under- or overflows
    # (ROADMAP queue 3)
    rdt = _real_dtype(A.dtype)
    fi = torch.finfo(rdt)
    anorm = norm(A, Norm.Max)
    rmin = (fi.tiny / fi.eps) ** 0.5
    rmax = 1.0 / rmin
    do_scale = (anorm > 0) & ((anorm < rmin) | (anorm > rmax))
    sigma = torch.where(do_scale, torch.where(anorm < rmin, rmin / anorm,
                                              rmax / anorm),
                        torch.ones((), dtype=rdt, device=A.device))
    if A.op.value == "n":
        A = dataclasses.replace(A, data=A.data * sigma)
    else:
        A = from_dense(A.dense_canonical() * sigma, nb, kind=A.kind,
                       uplo=A.uplo, logical_shape=A.shape, device=A.device)
    if method in (MethodEig.QR, MethodEig.DC):
        w, Z = _heev_td(A, opts, want_vectors,
                        use_steqr=method is MethodEig.QR)
    else:
        w, Z = _heev_band_dense(A, want_vectors)
    return w / sigma, Z


@accurate_matmuls
def hegst(A: TiledMatrix, L: TiledMatrix, opts: Options = DEFAULT_OPTIONS,
          itype: int = 1) -> TiledMatrix:
    """Reduce a generalized Hermitian-definite problem to standard form
    (slate::hegst, all three LAPACK itypes), on the port's trsm (the
    block recursion over P1-inverted diagonal blocks) and trmm.

    itype 1 (A·x = λ·B·x): A ← L⁻¹·A·L⁻ᴴ for a Lower factor (B = L·Lᴴ)
    or A ← U⁻ᴴ·A·U⁻¹ for an Upper one (B = UᴴU). itype 2/3 (A·B·x = λ·x,
    B·A·x = λ·x): A ← Lᴴ·A·L (Lower) or U·A·Uᴴ (Upper). The factor's
    padded diagonal is set to 1, so the padding rows stay inert."""
    if itype not in (1, 2, 3):
        raise ValueError(f"hegst: itype must be 1, 2, or 3, got {itype}")
    n = A.shape[0]
    a = A.full_dense_canonical()
    lmat = unit_pad_diag(_working_copy(L), n, n)
    lower = L.uplo is Uplo.Lower
    base = min(A.nb, a.shape[0])
    if itype == 1:
        if lower:
            x = blocked.trsm_rec(lmat, a, lower=True, base=base)
            y = blocked.trsm_rec(lmat, x, left=False, lower=True,
                                 trans_a=True, conj_a=True, base=base)
        else:
            x = blocked.trsm_rec(lmat, a, lower=False, trans_a=True,
                                 conj_a=True, base=base)
            y = blocked.trsm_rec(lmat, x, left=False, lower=False,
                                 base=base)
    else:
        tri = torch.tril(lmat) if lower else torch.triu(lmat)
        y = tri.mH @ a @ tri if lower else tri @ a @ tri.mH
    y = 0.5 * (y + y.mH)
    return from_dense(y, A.nb, kind=A.kind, uplo=Uplo.Lower,
                      logical_shape=(n, n), device=y.device)


def hegv(A: TiledMatrix, B: TiledMatrix, opts: Options = DEFAULT_OPTIONS,
         want_vectors: bool = True, itype: int = 1
         ) -> Tuple[torch.Tensor, Optional[TiledMatrix], torch.Tensor]:
    """Generalized Hermitian-definite eigensolver (slate::hegv = potrf(B)
    + hegst + heev + trsm/trmm back-transform; itype 1: A·x = λ·B·x,
    2: A·B·x = λ·x, 3: B·A·x = λ·x). Returns (Lambda, X or None, info);
    info > 0 when B is not positive definite (potrf's code), and then
    the results are NaN, as the reference's."""
    from .cholesky import potrf
    # decided (and QR's redirect warned) once, before potrf
    opts = dataclasses.replace(opts,
                               method_eig=_heev_method(A.shape[0], opts))
    Lb, info = potrf(B, opts)
    As = hegst(A, Lb, opts, itype=itype)
    w, Z = heev(As, opts, want_vectors=want_vectors)
    if not want_vectors:
        return w, None, info
    lower = Lb.uplo is Uplo.Lower
    if itype in (1, 2):
        # x = L⁻ᴴ·z (Lower factor) or U⁻¹·z (Upper factor)
        X = blas3.trsm(Side.Left, 1.0, Lb.H if lower else Lb, Z, opts)
    else:
        # itype 3: x = L·z (Lower) or Uᴴ·z (Upper)
        X = blas3.trmm(Side.Left, 1.0, Lb if lower else Lb.H, Z, opts)
    return w, X, info
