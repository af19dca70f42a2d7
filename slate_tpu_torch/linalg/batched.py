"""Batched small-problem drivers: many (B, n, n) systems per call.

Counterpart of ``slate_tpu/linalg/batched.py`` (its full-precision
drivers) over the batched blocked engine in ``ops/blocked.py``, whose
column loops are the port-only kernels P1, P3, P4 and P5: a factor or a
solve of the whole stack is a fixed, small number of launches whatever B
is. Per-item ``info`` follows LAPACK (0 = ok, k > 0 = the first failing
column or leading minor); one singular or non-SPD item flags itself and
leaves its neighbours' bits untouched, because every kernel computes each
item alone.

Device: a torch tensor stays on its device; anything else (numpy, lists)
goes to ``device``, "cuda" unless the caller asks for "cpu". The
right-hand sides and perms follow the factor's device. Every driver and
verb takes float32, float64, complex64 and complex128 (Hermitian
positive definite items for the Cholesky ones).

Not ported, because they exist for XLA's compile cache: the per-bucket
program cache and its statistics (``_run_bucket``, ``bucket_stats``,
``bucket_hlo``, ``clear_programs``, ``suppress_accounting``), the pow2
batch padding (``batch_bucket`` and the identity/zero pads) and the
two-column minimum of the right-hand sides. The tuning table behind
``resolved_nb`` is ROADMAP Queue 1 item 11; the mixed-precision drivers
are item 6.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import resolve_device
from ..ops import blocked

# one panel for n ≤ 32 (the whole factorization is one kernel launch),
# 32-wide panels above it
DEFAULT_NB = 32


def default_nb(n: int) -> int:
    return n if n <= DEFAULT_NB else DEFAULT_NB


def resolved_nb(n: int, nb: Optional[int] = None) -> int:
    """The panel width of one call: the caller's nb, else ``default_nb``."""
    return default_nb(n) if nb is None else nb


def _tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(device)
    else:
        arr = np.asarray(x)
        if not arr.flags.writeable:  # torch tensors cannot be read-only
            arr = arr.copy()
        t = torch.as_tensor(arr, device=resolve_device(device or "cuda"))
    return t if dtype is None else t.to(dtype)


def _as_stack(A, what: str, device="cuda") -> torch.Tensor:
    """A (B, m, n) floating-point or complex stack on its device."""
    a = _tensor(A, None if isinstance(A, torch.Tensor) else device)
    if a.ndim != 3:
        raise SlateError(f"{what}: expected a [B, m, n] stack, got "
                         f"shape {tuple(a.shape)}")
    if not (a.is_floating_point() or a.is_complex()):
        raise SlateError(f"{what}: expected a floating-point stack, got "
                         f"{a.dtype}")
    return a


def _rhs_stack(B, bsz: int, rows: int, like: torch.Tensor, what: str
               ) -> Tuple[torch.Tensor, bool]:
    """Right-hand sides as a (B, rows, k) stack on ``like``'s device and
    type; returns (stack, vector) where ``vector`` restores (B, rows)
    inputs."""
    b = _tensor(B, like.device, like.dtype)
    vector = b.ndim == 2
    if vector:
        b = b[:, :, None]
    if b.ndim != 3 or b.shape[0] != bsz or b.shape[1] != rows:
        raise SlateError(f"{what}: rhs stack must be [B, {rows}, k] or "
                         f"[B, {rows}], got {tuple(b.shape)}")
    return b, vector


def _square(a: torch.Tensor, what: str) -> int:
    bsz, m, n = a.shape
    if m != n:
        raise SlateError(f"{what}: items must be square")
    return n


def _out(x: torch.Tensor, vector: bool) -> torch.Tensor:
    return x[:, :, 0] if vector else x


# -- factorization drivers --------------------------------------------------


@accurate_matmuls
def getrf_batched(A, nb: Optional[int] = None, device="cuda"):
    """Batched partial-pivot LU of a (B, n, n) stack → (LU, perm int32,
    info (B,)) with gather-semantics perms (a[perm] = L·U per item)."""
    a = _as_stack(A, "getrf_batched", device)
    n = _square(a, "getrf_batched")
    return blocked.getrf_batched(a, resolved_nb(n, nb))


@accurate_matmuls
def potrf_batched(A, nb: Optional[int] = None, device="cuda"):
    """Batched lower Cholesky of a symmetric (B, n, n) stack → (tril L,
    info (B,)). Only the lower triangles are read."""
    a = _as_stack(A, "potrf_batched", device)
    n = _square(a, "potrf_batched")
    return blocked.potrf_batched(a, resolved_nb(n, nb))


@accurate_matmuls
def geqrf_batched(A, nb: Optional[int] = None, device="cuda"):
    """Batched Householder QR of a (B, m, n) stack (m ≥ n) → (packed V\\R,
    taus (B, n), Ts (B, ceil(n/nb), nb, nb))."""
    a = _as_stack(A, "geqrf_batched", device)
    if a.shape[1] < a.shape[2]:
        raise SlateError("geqrf_batched: items must have m >= n")
    return blocked.geqrf_batched(a, resolved_nb(a.shape[2], nb))


# -- solve-using-factor drivers (the Session's batched path) ----------------


@accurate_matmuls
def getrs_batched(LU, perm, B, device="cuda"):
    """Batched solve from ``getrf_batched`` factors → (B, n, k), or (B, n)
    for (B, n) right-hand sides."""
    lu = _as_stack(LU, "getrs_batched", device)
    bsz, n, _ = lu.shape
    b, vector = _rhs_stack(B, bsz, n, lu, "getrs_batched")
    p = _tensor(perm, lu.device)
    return _out(blocked.getrs_batched(lu, p, b), vector)


@accurate_matmuls
def potrs_batched(L, B, device="cuda"):
    """Batched solve from ``potrf_batched`` factors."""
    l = _as_stack(L, "potrs_batched", device)
    bsz, n, _ = l.shape
    b, vector = _rhs_stack(B, bsz, n, l, "potrs_batched")
    return _out(blocked.potrs_batched(l, b), vector)


@accurate_matmuls
def gels_batched_using_factor(VR, taus, Ts, B, nb: Optional[int] = None,
                              device="cuda"):
    """Batched least-squares solve from ``geqrf_batched`` factors →
    (B, n, k) (or (B, n)) minimizers. ``nb`` defaults to the T factors'
    width; ``taus`` is accepted for the reference's signature (the T
    factors carry them)."""
    vr = _as_stack(VR, "gels_batched_using_factor", device)
    bsz, m, _ = vr.shape
    ts = _tensor(Ts, vr.device, vr.dtype)
    nb = int(ts.shape[-1]) if nb is None else nb
    b, vector = _rhs_stack(B, bsz, m, vr, "gels_batched_using_factor")
    return _out(blocked.gels_qr_solve_batched(vr, ts, b, nb), vector)


# -- factor + solve drivers ---------------------------------------------------


@accurate_matmuls
def gesv_batched(A, B, nb: Optional[int] = None, device="cuda"):
    """Batched A·X = B → (X, info (B,))."""
    a = _as_stack(A, "gesv_batched", device)
    n = _square(a, "gesv_batched")
    b, vector = _rhs_stack(B, a.shape[0], n, a, "gesv_batched")
    lu, perm, info = blocked.getrf_batched(a, resolved_nb(n, nb))
    return _out(blocked.getrs_batched(lu, perm, b), vector), info


@accurate_matmuls
def posv_batched(A, B, nb: Optional[int] = None, device="cuda"):
    """Batched Hermitian-positive-definite A·X = B (lower storage) → (X,
    info (B,))."""
    a = _as_stack(A, "posv_batched", device)
    n = _square(a, "posv_batched")
    b, vector = _rhs_stack(B, a.shape[0], n, a, "posv_batched")
    l, info = blocked.potrf_batched(a, resolved_nb(n, nb))
    return _out(blocked.potrs_batched(l, b), vector), info


@accurate_matmuls
def gels_batched(A, B, nb: Optional[int] = None, device="cuda"):
    """Batched least squares min‖A·X − B‖ (m ≥ n) → (X (B, n, k), info
    (B,), always 0: QR of a full stack never fails structurally)."""
    a = _as_stack(A, "gels_batched", device)
    bsz, m, n = a.shape
    if m < n:
        raise SlateError("gels_batched: items must have m >= n")
    nb = resolved_nb(n, nb)
    b, vector = _rhs_stack(B, bsz, m, a, "gels_batched")
    vr, _, ts = blocked.geqrf_batched(a, nb)
    x = blocked.gels_qr_solve_batched(vr, ts, b, nb)
    return _out(x, vector), torch.zeros(bsz, dtype=torch.int32,
                                         device=a.device)
