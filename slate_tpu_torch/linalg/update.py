"""Incremental factor maintenance (counterpart of
``slate_tpu/linalg/update.py``): rank-k Cholesky up/downdates and QR row
append, served against a resident factor at O(n²k) instead of the O(n³)
refactor.

- **Cholesky rank-k update/downdate** (Gill–Golub–Murray–Saunders method
  C1/C2 in Davis and Hager's multiple-rank sweep): for A' = A ± W·Wᴴ one
  sweep over L's columns, each of the k vectors contributing one plane
  rotation per column (Givens for an update, hyperbolic for a downdate).
  A downdate whose rotation does not exist (A − W·Wᴴ not positive
  definite along the sweep) reports ``info`` = the 1-based column and
  freezes the sweep there, so the values stay finite; the factor is then
  to be discarded.
- **QR row append** (GGMS Q4): appending p rows U to a factored A costs the
  structured QR of [R; U], one reflector v = [e_j; w_j] per column; the
  base factors are never touched. ``appended_gels`` applies the base Qᴴ
  (the port's own ``unmqr``) to the top rows, the appended reflectors to
  [c_top; d], and solves against the appended R.

The sweeps are the port's kernels P6 (``chol_update_sweep``), P7
(``qr_append_build``) and P8 (``qr_append_apply``) in
``ops/hopper_ops.py``: one launch per call where the reference scans the
columns. Zero update vectors and zero appended rows are exactly inert, so
ranks and row counts pad to pow2 buckets (``bucket_k``). Unlike the
reference, whose functions are pure, ``inplace=True`` writes the updated
factor into the input's storage (the Session keeps its warmed solve graphs
valid that way).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense
from ..core.types import MatrixKind, Options, Side, Uplo, DEFAULT_OPTIONS
from ..ops import blocked
from ..ops import hopper_ops as ho
from . import blas3
from .qr import QRFactors, unmqr


def bucket_k(k: int) -> int:
    """Pow2 bucket of an update rank or appended-row count (zero padding
    lanes are exactly inert)."""
    return blocked.bucket_pow2(max(int(k), 1), 1)


# -- Cholesky rank-k up/downdate --------------------------------------------


def chol_update_dense(l: torch.Tensor, w: torch.Tensor, sign: int,
                      n: Optional[int] = None, inplace: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rotation sweep over a dense lower factor: A' = A + sign·W·Wᴴ.

    ``l``: (npad, npad) lower-triangular factor (zero above the diagonal
    and beyond the logical ``n``). ``w``: (npad, kb) update vectors,
    zero beyond n and the live rank, kb a pow2 bucket ≤ 16. Returns
    ``(l', info)``: info 0, or the 1-based column where a downdate first
    failed (l' must then be discarded; it stays finite). ``l'`` is a new
    tensor, or ``l`` itself with ``inplace``."""
    out = l if inplace else l.clone()
    return out, ho.chol_update_sweep(out, w, sign, n)


def chol_update_factor(L: TiledMatrix, w: torch.Tensor, sign: int,
                       inplace: bool = False
                       ) -> Tuple[TiledMatrix, torch.Tensor]:
    """Rank-k up/downdate of a resident potrf factor (lower storage). ``w``
    is the (npad, kb) padded vector block (see :func:`chol_update_dense`).
    Returns ``(L', info)`` with L' of the same kind, uplo, nb and logical
    shape; with ``inplace`` L' is L, its storage updated."""
    data, info = chol_update_dense(L.data, w, sign, n=L.shape[1],
                                   inplace=inplace)
    return (L if inplace else dataclasses.replace(L, data=data)), info


def chol_update_batched(l: torch.Tensor, w: torch.Tensor, sign: int,
                        inplace: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (B, n, n) stack of small resident factors, each up/downdated by its
    own (n, kb) vector block (the Kalman-filter/RLS lane) → (l', info
    (B,)), one P6 launch; each item's bits are its B = 1 run's."""
    return chol_update_dense(l, w, sign, inplace=inplace)


# -- QR row append ----------------------------------------------------------


def qr_append_build(vr: torch.Tensor, u: torch.Tensor, n: int,
                    out: Optional[Tuple] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Structured QR of [R; U] for R = triu(vr) (the resident factor's
    packed V\\R storage) and U a (P, npad) block of appended rows, zero
    beyond the live rows and n. Returns ``(w, tau, r)``: the reflector
    tails (P, npad), the scalars (npad,) and the appended upper factor r
    (npad, npad); columns beyond n stay zero/identity. ``out``: the
    (w, tau, r) tensors to write them into (a Session's append slots)."""
    npad = vr.shape[1]
    r0 = torch.triu(vr[:npad, :npad])
    if out is None:
        r = r0
        w, tau = ho.qr_append_build(r, u, n)
    else:
        w, tau, r = out
        r.copy_(r0)
        ho.qr_append_build(r, u, n, w=w, tau=tau)
    return w, tau, r


def qr_append_factor(qr: QRFactors, u: torch.Tensor,
                     out: Optional[Tuple] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append factors against a resident geqrf result (see
    :func:`qr_append_build`); ``u`` is (P, npad) zero-padded."""
    return qr_append_build(qr.vr, u, qr.n, out)


@accurate_matmuls
def appended_gels(payload: Tuple, B: TiledMatrix,
                  opts: Options = DEFAULT_OPTIONS) -> TiledMatrix:
    """Least-squares solve against an appended QR resident: ``payload`` is
    the 5-tuple ``(qr, u, w, tau, r)`` (qr: the untouched base factors; u:
    the raw appended rows; w, tau, r: the append factors) and B has the
    base's m rows plus the appended ones. X = R'⁻¹·(Q'ᴴ·B)[:n], Q'ᴴ applied
    as the base Qᴴ on the top m rows (``unmqr``) and then the appended
    reflectors' forward sweep over [c_top; d] (P8)."""
    qr, _u, w, tau, r = payload
    nb, n, m = qr.nb, qr.n, qr.m
    q = B.shape[1]
    bd = B.dense_canonical()
    btop = from_dense(bd[:m], nb, logical_shape=(m, q), device=bd.device)
    c = unmqr(Side.Left, qr, btop, trans=True, opts=opts)
    npad = r.shape[0]
    ct = c.dense_canonical()[:npad]
    p_log = B.shape[0] - m
    d = bd.new_zeros((w.shape[0], bd.shape[1]))
    d[:p_log] = bd[m:m + p_log]
    ho.qr_append_apply(ct, d, w, tau, n)
    rtm = from_dense(r, nb, kind=MatrixKind.Triangular, uplo=Uplo.Upper,
                     logical_shape=(n, n), device=r.device)
    ct_tm = from_dense(ct, nb, logical_shape=(n, q), device=ct.device)
    return blas3.trsm(Side.Left, 1.0, rtm, ct_tm, opts)
