"""QR/LQ/least-squares family: geqrf, unmqr, gelqf, unmlq, gels
(counterpart of ``slate_tpu/linalg/qr.py``).

Panels are factored by ``blocked.panel_geqrf_with_t`` at their pow2
height bucket (zero rows below a panel are inert for Householder QR),
with the K3/K4 kernels at the bottom of the panel recursion; the trailing
update is C ← C − V·(Tᴴ·(Vᴴ·C)) by cuBLAS gemms. The reference's
lookahead-1 order is the one order here: the next panel's columns are
reflected first, that panel is factored from them, then the remaining
columns are reflected. ``Options.lookahead`` is accepted and ignored.
Each call clones the operand ONCE into a working copy; the reference's
functional updates are in-place slice writes on it.

``cholqr``, ``tsqr`` and ``MethodGels.CholQR`` need ``syrk``/``herk``
and are not ported yet (ROADMAP Queue 1 item 3): they raise.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense, unit_pad_diag
from ..core.types import MatrixKind, MethodGels, Options, Side, Uplo, \
    DEFAULT_OPTIONS
from ..ops import blocked
from . import blas3


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

def _cholqr_not_ported(what: str):
    raise NotImplementedError(
        f"{what} needs syrk/herk, which are not ported yet (ROADMAP Queue "
        "1 item 3)")


def cholqr(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS):
    _cholqr_not_ported("cholqr")


def tsqr(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS):
    _cholqr_not_ported("tsqr")


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
    """Least squares min‖A·X − B‖ (m ≥ n, by QR) or the minimum-norm
    solution (m < n, by LQ: A = L·Q, X = Qᴴ·L⁻¹·B)."""
    m, n = A.shape
    if m >= n:
        if opts.method_gels is MethodGels.CholQR:
            _cholqr_not_ported("gels with MethodGels.CholQR")
        return gels_using_factor(geqrf(A, opts), B, opts)
    LQ = gelqf(A, opts)
    Y = blas3.trsm(Side.Left, 1.0, LQ.r_matrix.H, B, opts)
    y = Y.dense_canonical()
    y_full = y.new_zeros((-(-n // A.nb) * A.nb, y.shape[1]))
    y_full[: y.shape[0]] = y
    Yf = from_dense(y_full, A.nb, logical_shape=(n, B.shape[1]),
                    device=y.device)
    return unmlq(Side.Left, LQ, Yf, trans=True, opts=opts)
