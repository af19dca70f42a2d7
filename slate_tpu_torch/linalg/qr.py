"""QR/LQ/least-squares family: geqrf, unmqr, gelqf, unmlq, cholqr, tsqr,
gels (counterpart of ``slate_tpu/linalg/qr.py``).

Panels are factored by ``blocked.panel_geqrf_with_t`` at their pow2
height bucket (zero rows below a panel are inert for Householder QR),
with the K3/K4 kernels at the bottom of the panel recursion; the trailing
update is C ← C − V·(Tᴴ·(Vᴴ·C)) by cuBLAS gemms. The reference's
lookahead-1 order is the one order here: the next panel's columns are
reflected first, that panel is factored from them, then the remaining
columns are reflected. ``Options.lookahead`` is accepted and ignored.
Each call clones the operand ONCE into a working copy; the reference's
functional updates are in-place slice writes on it.

``cholqr`` (and so ``MethodGels.CholQR`` and ``tsqr``'s second pass) is
syrk/herk, potrf and trsm: a Gram matrix with more than 64 block columns
takes potrf's 2×2 recursion, whose trailing updates are the K5 kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense, unit_pad_diag, zeros
from ..core.types import MatrixKind, MethodGels, Options, Side, Uplo, \
    DEFAULT_OPTIONS
from ..ops import blocked
from . import blas3
from .cholesky import potrf


@dataclasses.dataclass(frozen=True)
class QRFactors:
    """Packed blocked-Householder factors.

    ``vr``: (mpad, npad) — V (unit lower trapezoid, by panel) below the
    diagonal, R on and above it. ``t``: (npanels, nb, nb) upper-triangular
    T factors, one per panel."""

    vr: torch.Tensor
    t: torch.Tensor
    m: int
    n: int
    nb: int

    @property
    def r_matrix(self) -> TiledMatrix:
        """R as an upper triangular matrix (logical min(m,n) × n)."""
        k = min(self.m, self.n)
        r = torch.triu(self.vr[: self.vr.shape[1], :])
        return from_dense(r, self.nb, kind=MatrixKind.Triangular,
                          uplo=Uplo.Upper, logical_shape=(k, self.n),
                          device=r.device)


def _apply_block_reflector_H(v, t, c):
    """C ← (I − V·T·Vᴴ)ᴴ·C = C − V·Tᴴ·(Vᴴ·C), in place (Qᴴ·C)."""
    return c.sub_(v @ (t.mH @ (v.mH @ c)))


def _apply_block_reflector(v, t, c):
    """C ← (I − V·T·Vᴴ)·C = C − V·T·(Vᴴ·C), in place (Q·C)."""
    return c.sub_(v @ (t @ (v.mH @ c)))


def _factor_panel(panel: torch.Tensor, nb: int):
    """QR of one (rows × w) panel at its pow2 height bucket → (vr cut to
    rows, T)."""
    rows, w = panel.shape
    hb = blocked.bucket_pow2(rows, nb)
    if hb > rows:
        panel = torch.cat([panel, panel.new_zeros((hb - rows, w))])
    vr, _, t = blocked.panel_geqrf_with_t(panel)
    return vr[:rows], t


@accurate_matmuls
def geqrf(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS) -> QRFactors:
    """Blocked Householder QR A = Q·R in the lookahead-1 order: at step
    k the trailing block's Z = Tᴴ·(Vᴴ·C) is one product, the next
    panel's columns are updated first (C − V·Z), panel k+1 is factored
    from them, then the remaining columns are updated."""
    m, n = A.shape
    nb = A.nb
    # the one working copy of this call: every update below writes it
    a = A.dense_canonical().clone(memory_format=torch.contiguous_format)
    a = unit_pad_diag(a.resolve_conj(), m, n)
    mpad, npad = a.shape
    kt = -(-min(m, n) // nb)  # panels covering the logical diagonal
    t_all = a.new_zeros((kt, nb, nb))
    ahead = None  # panel k's (vr, t), factored at step k − 1
    for k in range(kt):
        k0, k1 = k * nb, min((k + 1) * nb, npad)
        w = k1 - k0
        if ahead is None:
            vr, t = _factor_panel(a[k0:, k0:k1], nb)
        else:
            (vr, t), ahead = ahead, None
        a[k0:, k0:k1] = vr
        t_all[k, :w, :w] = t
        if k1 >= npad:
            continue
        v = blocked._split_v(vr, w)
        c = a[k0:, k1:]
        z = t.mH @ (v.mH @ c)
        k2 = min(k1 + nb, npad)
        c[:, :k2 - k1].addmm_(v, z[:, :k2 - k1], alpha=-1)
        if k + 1 < kt:
            ahead = _factor_panel(a[k1:, k1:k2], nb)
        if k2 < npad:
            c[:, k2 - k1:].addmm_(v, z[:, k2 - k1:], alpha=-1)
    return QRFactors(a, t_all, m, n, nb)


@accurate_matmuls
def unmqr(side: Side, QR: QRFactors, C: TiledMatrix, trans: bool = False,
          opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """Multiply by Q from geqrf: side=Left gives Q·C (trans=False) or
    Qᴴ·C; side=Right gives C·Q or C·Qᴴ. Q = H₀·H₁·…, so Qᴴ·C and C·Q
    apply the block reflectors first to last, Q·C and C·Qᴴ last to
    first."""
    nb = QR.nb
    mpad, npad = QR.vr.shape
    kt = QR.t.shape[0]
    c = C.dense_canonical()
    # the one working copy, padded to Q's order along the side it meets
    left = side is Side.Left
    shape = (mpad, c.shape[1]) if left else (c.shape[0], mpad)
    if c.shape[0 if left else 1] > mpad:
        raise SlateError(f"unmqr: C {tuple(C.shape)} does not fit Q of "
                         f"order {QR.m}")
    work = c.new_zeros(shape)
    work[: c.shape[0], : c.shape[1]] = c
    forward = trans == left
    for k in (range(kt) if forward else range(kt - 1, -1, -1)):
        k0 = k * nb
        w = min(k0 + nb, npad) - k0
        v = blocked._split_v(QR.vr[k0:, k0:k0 + w], w)
        t = QR.t[k, :w, :w]
        if left:
            blk = work[k0:, :]
            (_apply_block_reflector_H if trans else
             _apply_block_reflector)(v, t, blk)
        else:
            blk = work[:, k0:]  # C·H = C − (C·V)·T·Vᴴ
            blk.sub_(((blk @ v) @ (t.mH if trans else t)) @ v.mH)
    rows, cols = -(-C.shape[0] // nb) * nb, -(-C.shape[1] // nb) * nb
    return from_dense(work[:rows, :cols], nb, logical_shape=C.shape,
                      device=work.device)


def qr_multiply_explicit(QR: QRFactors) -> TiledMatrix:
    """The thin Q (m × min(m, n)) as a matrix (ungqr analog)."""
    k = min(QR.m, QR.n)
    eye = torch.eye(QR.vr.shape[0], -(-k // QR.nb) * QR.nb,
                    dtype=QR.vr.dtype, device=QR.vr.device)
    I = from_dense(eye, QR.nb, logical_shape=(QR.m, k), device=eye.device)
    return unmqr(Side.Left, QR, I, trans=False)


# -- LQ --------------------------------------------------------------------

def gelqf(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS) -> QRFactors:
    """LQ factorization A = L·Q as the QR of Aᴴ."""
    return geqrf(A.H, opts)


def unmlq(side: Side, LQ: QRFactors, C: TiledMatrix, trans: bool = False,
          opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """Multiply by Q from gelqf (Q of the LQ = Qᴴ of the QR of Aᴴ):
    side=Left applies it (trans=False) or its adjoint."""
    return unmqr(side, LQ, C, trans=not trans, opts=opts)


# -- CholQR / TSQR ---------------------------------------------------------

@accurate_matmuls
def cholqr(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS
           ) -> Tuple[TiledMatrix, TiledMatrix]:
    """Cholesky QR: the Gram matrix G = Aᴴ·A on its upper triangle
    (syrk, herk for complex A), R = the upper Cholesky factor of G
    (potrf), Q = A·R⁻¹ (trsm). Returns (Q, R); m ≥ n."""
    m, n = A.shape
    if m < n:
        raise SlateError("cholqr needs m >= n")
    cplx = A.dtype.is_complex
    C = zeros(n, n, A.nb, A.dtype, device=A.device, uplo=Uplo.Upper,
              kind=MatrixKind.Hermitian if cplx else MatrixKind.Symmetric)
    G = (blas3.herk if cplx else blas3.syrk)(1.0, A.H, 0.0, C, opts)
    R, _ = potrf(TiledMatrix(G.data, n, n, A.nb, kind=MatrixKind.Hermitian,
                             uplo=Uplo.Upper), opts)
    return blas3.trsm(Side.Right, 1.0, R, A, opts), R


def _qr_r(blocks: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(blocks, mode="r").R


@accurate_matmuls
def tsqr(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS
         ) -> Tuple[TiledMatrix, TiledMatrix]:
    """Tall-skinny QR by a binary tree: row chunks of max(npad, nb) rows
    are QR'd together (one batched ``torch.linalg.qr``, where the
    reference vmaps ``jnp.linalg.qr``), then the R factors combine
    pairwise up the tree. R's diagonal is made non-negative, Q = A·R⁻¹,
    and one CholQR pass restores orthogonality (CholeskyQR2). Returns
    (Q, R); m ≥ n."""
    m, n = A.shape
    if m < n:
        raise SlateError("tsqr needs m >= n")
    a = unit_pad_diag(
        A.dense_canonical().clone(memory_format=torch.contiguous_format),
        m, n)
    mpad, npad = a.shape
    chunk = max(npad, A.nb)
    nchunks = -(-mpad // chunk)
    a_p = a.new_zeros((nchunks * chunk, npad))
    a_p[:mpad] = a
    rs = _qr_r(a_p.reshape(nchunks, chunk, npad))
    while rs.shape[0] > 1:
        if rs.shape[0] % 2 == 1:
            rs = torch.cat([rs, rs.new_zeros((1, npad, npad))])
        rs = _qr_r(rs.reshape(rs.shape[0] // 2, 2 * npad, npad))
    r = rs[0]
    r = r * torch.where(r.diagonal().real < 0, -1.0, 1.0).to(r.dtype)[:, None]
    Rm = from_dense(r, A.nb, kind=MatrixKind.Triangular, uplo=Uplo.Upper,
                    logical_shape=(n, n), device=r.device)
    Q2, R2 = cholqr(blas3.trsm(Side.Right, 1.0, Rm, A, opts), opts)
    Rf = from_dense(R2.dense_canonical() @ r, A.nb,
                    kind=MatrixKind.Triangular, uplo=Uplo.Upper,
                    logical_shape=(n, n), device=r.device)
    return Q2, Rf


# -- least squares ---------------------------------------------------------

@accurate_matmuls
def gels_using_factor(QR: QRFactors, B: TiledMatrix,
                      opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """Overdetermined least-squares solve from resident geqrf factors:
    X = R⁻¹·(Qᴴ·B)[:n]."""
    n = QR.n
    qtb = unmqr(Side.Left, QR, B, trans=True, opts=opts).dense_canonical()
    top = from_dense(qtb[: -(-n // QR.nb) * QR.nb], QR.nb,
                     logical_shape=(n, B.shape[1]), device=qtb.device)
    return blas3.trsm(Side.Left, 1.0, QR.r_matrix, top, opts)


@accurate_matmuls
def gels(A: TiledMatrix, B: TiledMatrix, opts: Options = DEFAULT_OPTIONS
         ) -> TiledMatrix:
    """Least squares min‖A·X − B‖ (m ≥ n, by QR, or by CholQR with
    ``MethodGels.CholQR``: X = R⁻¹·(Qᴴ·B)) or the minimum-norm solution
    (m < n, by LQ: A = L·Q, X = Qᴴ·L⁻¹·B)."""
    m, n = A.shape
    if m >= n:
        if opts.method_gels is MethodGels.CholQR:
            Q, R = cholqr(A, opts)
            qtb = Q.dense_canonical().mH @ B.dense_canonical()
            QtB = from_dense(qtb, A.nb, logical_shape=(n, B.shape[1]),
                             device=qtb.device)
            return blas3.trsm(Side.Left, 1.0, R, QtB, opts)
        return gels_using_factor(geqrf(A, opts), B, opts)
    LQ = gelqf(A, opts)
    Y = blas3.trsm(Side.Left, 1.0, LQ.r_matrix.H, B, opts)
    y = Y.dense_canonical()
    y_full = y.new_zeros((-(-n // A.nb) * A.nb, y.shape[1]))
    y_full[: y.shape[0]] = y
    Yf = from_dense(y_full, A.nb, logical_shape=(n, B.shape[1]),
                    device=y.device)
    return unmlq(Side.Left, LQ, Yf, trans=True, opts=opts)
