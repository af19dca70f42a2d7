"""TiledMatrix of the port: one padded dense tensor on one device.

Counterpart of ``slate_tpu/core/tiled_matrix.py`` (single-device part).
The matrix is an ``(m × n)`` logical matrix stored as a zero-padded
``(mt·nb, nt·nb)`` tensor in NoTrans orientation; ``op`` is a view flag
applied lazily. Multi-device grids are not ported yet: a non-trivial
``grid`` raises.

Entry points that create tensors take an explicit ``device`` that
defaults to ``"cuda"``; without a card they raise instead of quietly
running on the CPU (pass ``device="cpu"`` for that).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .exceptions import SlateError
from .types import Diag, MatrixKind, Op, Uplo


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. ``"cuda"`` (the
    default) without a visible card raises a clear error."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SlateError(
                "slate_tpu_torch: no CUDA device is visible; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def num_tiles(n: int, nb: int) -> int:
    return -(-n // nb)


def as_tensor(a, device) -> torch.Tensor:
    """A tensor on ``device`` from a numpy array or tensor (no copy when
    it is already there)."""
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    arr = np.asarray(a)
    if not arr.flags.writeable:  # torch tensors cannot be read-only
        arr = arr.copy()
    return torch.as_tensor(arr, device=dev)


@dataclasses.dataclass(frozen=True)
class TiledMatrix:
    """An (m × n) matrix stored as padded (mt·nb × nt·nb) dense data.

    Padding rows/cols beyond (m, n) are zero. Band kinds carry their
    bandwidths (kl, ku) and are stored as masked dense."""

    data: torch.Tensor
    m: int
    n: int
    nb: int
    kind: MatrixKind = MatrixKind.General
    uplo: Uplo = Uplo.General
    op: Op = Op.NoTrans
    diag: Diag = Diag.NonUnit
    kl: int = 0
    ku: int = 0

    @property
    def shape(self):
        return (self.m, self.n) if self.op is Op.NoTrans else (self.n, self.m)

    @property
    def logical_shape(self):
        return self.shape

    @property
    def mt(self) -> int:
        return num_tiles(self.shape[0], self.nb)

    @property
    def nt(self) -> int:
        return num_tiles(self.shape[1], self.nb)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    # -- views (metadata flips, like the reference) ------------------------
    def transpose(self) -> "TiledMatrix":
        """Aᵀ as a view: the op flag and the stored triangle flip."""
        if self.op is Op.ConjTrans:  # (Aᴴ)ᵀ = conj(A)
            return dataclasses.replace(
                self, data=self.data.conj().resolve_conj(), op=Op.NoTrans,
                uplo=self.uplo.flipped(), kl=self.ku, ku=self.kl)
        new_op = Op.NoTrans if self.op is Op.Trans else Op.Trans
        return dataclasses.replace(self, op=new_op, uplo=self.uplo.flipped(),
                                   kl=self.ku, ku=self.kl)

    @property
    def T(self) -> "TiledMatrix":
        return self.transpose()

    def conj_transpose(self) -> "TiledMatrix":
        """Aᴴ as a view: the op flag and the stored triangle flip."""
        new_op = Op.NoTrans if self.op is Op.ConjTrans else Op.ConjTrans
        if self.op is Op.Trans:  # (Aᵀ)ᴴ = conj(A)
            return dataclasses.replace(
                self, data=self.data.conj().resolve_conj(), op=Op.NoTrans,
                uplo=self.uplo.flipped(), kl=self.ku, ku=self.kl)
        return dataclasses.replace(self, op=new_op, uplo=self.uplo.flipped(),
                                   kl=self.ku, ku=self.kl)

    @property
    def H(self) -> "TiledMatrix":
        return self.conj_transpose()

    # -- materialization ---------------------------------------------------
    def dense(self) -> torch.Tensor:
        """Padded storage with op applied (a view, no copy)."""
        if self.op is Op.NoTrans:
            return self.data
        if self.op is Op.Trans:
            return self.data.mT
        return self.data.mH

    def dense_canonical(self) -> torch.Tensor:
        """Padded view at the canonical (mt·nb, nt·nb) size."""
        a = self.dense()
        rows, cols = self.mt * self.nb, self.nt * self.nb
        if tuple(a.shape) != (rows, cols):
            raise SlateError(f"TiledMatrix storage {tuple(a.shape)} is not "
                             f"the canonical {(rows, cols)}")
        return a

    def full_dense(self) -> torch.Tensor:
        """The canonical-size matrix with its implicit structure made
        explicit, as a new tensor: Symmetric/Hermitian mirror the stored
        triangle (a Hermitian diagonal is taken as real),
        Triangular/Trapezoid zero the other triangle and put 1 on the
        whole diagonal when ``Diag.Unit``. A HermitianBand keeps the band
        of width kl = ku = its bandwidth around the diagonal and mirrors
        its stored triangle (the reference's masked dense; its diagonal is
        used as stored). A General matrix has no implicit structure: its
        padded view is returned, not a copy. Band and TriangularBand are a
        later slice."""
        if self.kind in (MatrixKind.Band, MatrixKind.TriangularBand):
            raise NotImplementedError(
                "full_dense: band kinds are not ported yet (ROADMAP Queue 1 "
                "item 9)")
        a = self.dense_canonical()
        if self.kind is MatrixKind.HermitianBand:
            kb = self.kl or self.ku
            r = torch.arange(a.shape[0], device=a.device)[:, None]
            c = torch.arange(a.shape[1], device=a.device)[None, :]
            a = torch.where((c - r <= kb) & (r - c <= kb), a, 0)
            if self.uplo is Uplo.Upper:
                return torch.triu(a) + torch.triu(a, 1).mH
            return torch.tril(a) + torch.tril(a, -1).mH
        lower = self.uplo is Uplo.Lower
        if self.kind in (MatrixKind.Symmetric, MatrixKind.Hermitian):
            tri = torch.tril(a) if lower else torch.triu(a)
            strict = torch.tril(a, -1) if lower else torch.triu(a, 1)
            if self.kind is MatrixKind.Hermitian:
                out = tri + strict.mH
                if out.is_complex():
                    out.diagonal().imag.zero_()
                return out
            return tri + strict.mT
        if self.kind in (MatrixKind.Triangular, MatrixKind.Trapezoid):
            out = torch.tril(a) if lower else torch.triu(a)
            if self.diag is Diag.Unit:
                out.diagonal().fill_(1)
            return out
        return a

    def full_dense_canonical(self) -> torch.Tensor:
        """``full_dense`` (always at the canonical padded size here)."""
        return self.full_dense()

    def to_numpy(self) -> np.ndarray:
        """Crop padding and return the logical (view-shaped) matrix. numpy
        has no bfloat16: a bfloat16 matrix comes back as float32 (exact)."""
        mm, nn = self.shape
        x = self.dense()[:mm, :nn].detach().resolve_conj()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def from_dense(a, nb: int, *, kind: MatrixKind = MatrixKind.General,
               uplo: Uplo = Uplo.General, diag: Diag = Diag.NonUnit,
               kl: int = 0, ku: int = 0, logical_shape=None, grid=None,
               device="cuda") -> TiledMatrix:
    """Wrap a dense array (numpy or tensor) as a TiledMatrix on
    ``device``, zero-padded to whole tiles (band kinds carry their
    bandwidths ``kl``/``ku``). With ``logical_shape``
    smaller than the array, storage beyond it is zeroed (the invariant
    the factorizations rely on). A tensor already on ``device`` with the
    canonical shape and no masking needed is wrapped without a copy."""
    if grid is not None and getattr(grid, "size", 1) > 1:
        raise SlateError("slate_tpu_torch: multi-device grids are not "
                         "ported yet (ROADMAP Queue 1 item 12)")
    t = as_tensor(a, device)
    if t.ndim != 2:
        raise SlateError("from_dense expects a 2-D array")
    m, n = logical_shape if logical_shape is not None else tuple(t.shape)
    rows, cols = num_tiles(m, nb) * nb, num_tiles(n, nb) * nb
    if tuple(t.shape) != (rows, cols):
        out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
        r, c = min(rows, t.shape[0]), min(cols, t.shape[1])
        out[:r, :c] = t[:r, :c]
        t = out
    elif m < rows or n < cols:
        t = t.clone()  # masking below must not write the caller's array
    if m < rows or n < cols:
        t[m:, :] = 0
        t[:, n:] = 0
    return TiledMatrix(t, m, n, nb, kind=kind, uplo=uplo, diag=diag, kl=kl,
                       ku=ku)


def hermitian(a, nb: int, uplo: Uplo, *, device="cuda") -> TiledMatrix:
    return from_dense(a, nb, kind=MatrixKind.Hermitian, uplo=uplo,
                      device=device)


def symmetric(a, nb: int, uplo: Uplo, *, device="cuda") -> TiledMatrix:
    return from_dense(a, nb, kind=MatrixKind.Symmetric, uplo=uplo,
                      device=device)


def triangular(a, nb: int, uplo: Uplo, diag: Diag = Diag.NonUnit, *,
               device="cuda") -> TiledMatrix:
    return from_dense(a, nb, kind=MatrixKind.Triangular, uplo=uplo,
                      diag=diag, device=device)


def zeros(m: int, n: int, nb: int, dtype=torch.float32, *, device="cuda",
          **kw) -> TiledMatrix:
    """An (m × n) zero matrix; ``kw`` sets kind, uplo and diag."""
    data = torch.zeros((num_tiles(m, nb) * nb, num_tiles(n, nb) * nb),
                       dtype=dtype, device=resolve_device(device))
    return TiledMatrix(data, m, n, nb, **kw)


def pad_mask(t: TiledMatrix) -> torch.Tensor:
    """Boolean mask of the logical (non-padding) entries at the canonical
    padded size (matches ``full_dense``)."""
    mm, nn = t.shape
    r = torch.arange(t.mt * t.nb, device=t.device)[:, None] < mm
    c = torch.arange(t.nt * t.nb, device=t.device)[None, :] < nn
    return r & c


def unit_pad_diag(a: torch.Tensor, m_log: int, n_log: int) -> torch.Tensor:
    """Set 1 on the diagonal of the padding region (rows/cols beyond the
    logical (m_log, n_log)) IN PLACE and return ``a``: the padded system
    is then block-diagonal [[A, 0], [0, I]]. Callers pass their own
    working copy."""
    k = min(a.shape)
    start = min(m_log, n_log)
    if start < k:
        a.diagonal()[start:k] = 1
    return a
