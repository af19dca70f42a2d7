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
two-column minimum of the right-hand sides, and in the mixed-precision
drivers ``_lo_cast_up``'s optimization barrier (an XLA fusion
workaround). The tuning table behind ``resolved_nb`` is ROADMAP Queue 1
item 11.

The mixed-precision drivers (the reference's ``batched.py:560-800``)
factor the stack in a lower precision (``getrf/potrf_mixed_batched``: the
cast, then the batched factor, so the factors come back in the factor
type) and refine every item to the working precision with the engine's
per-item-masked loop (``refine/engine.batched_ir_loop``): a converged lane
is never written again, and a lane that does not converge, or whose low
factor is singular, flags only itself.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import resolve_device
from ..ops import blocked
from ..refine import engine as _refine
from ..refine.policy import canonical_dtype_name, check_cast_kinds, \
    torch_dtype

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


# -- mixed-precision drivers ------------------------------------------------


def _guard_mixed_dtype(work_dtype, lo, what: str) -> torch.dtype:
    """The factor type of a mixed driver: real with real and complex with
    complex (a complex→real cast would discard the imaginary part: the
    factor of Re(A), info = 0, never convergent)."""
    try:
        check_cast_kinds(work_dtype, lo, what)
    except ValueError as e:
        raise SlateError(str(e))
    return torch_dtype(canonical_dtype_name(lo))


def _herm_full(a: torch.Tensor) -> torch.Tensor:
    """The full Hermitian stack from lower storage: the residual gemms
    read all of A (potrf/potrs read only the lower triangles)."""
    return torch.tril(a) + torch.tril(a, -1).mH


def _getrs_refined(a, lu, perm, b, max_iters: int, tol):
    work = a.dtype

    def apply_lo(r):
        return blocked.getrs_batched(lu, perm, r.to(lu.dtype)).to(work)

    return _refine.batched_ir_loop(a, b, apply_lo(b), apply_lo,
                                   _refine.batched_cte(a, tol), max_iters)


def _potrs_refined(a, l, b, max_iters: int, tol):
    work = a.dtype
    af = _herm_full(a)

    def apply_lo(r):
        return blocked.potrs_batched(l, r.to(l.dtype)).to(work)

    return _refine.batched_ir_loop(af, b, apply_lo(b), apply_lo,
                                   _refine.batched_cte(af, tol), max_iters)


@accurate_matmuls
def getrf_mixed_batched(A, factor_dtype="bfloat16", nb: Optional[int] = None,
                        device="cuda"):
    """Batched LOW-precision LU of a working-precision (B, n, n) stack →
    (LU_lo, perm, info (B,)), the factors in ``factor_dtype``: the
    residents a Session keeps for refined small operators."""
    a = _as_stack(A, "getrf_mixed_batched", device)
    n = _square(a, "getrf_mixed_batched")
    lo = _guard_mixed_dtype(a.dtype, factor_dtype, "getrf_mixed_batched")
    return blocked.getrf_batched(a.to(lo), resolved_nb(n, nb))


@accurate_matmuls
def potrf_mixed_batched(A, factor_dtype="bfloat16", nb: Optional[int] = None,
                        device="cuda"):
    """Batched low-precision lower Cholesky → (L_lo, info (B,))."""
    a = _as_stack(A, "potrf_mixed_batched", device)
    n = _square(a, "potrf_mixed_batched")
    lo = _guard_mixed_dtype(a.dtype, factor_dtype, "potrf_mixed_batched")
    return blocked.potrf_batched(a.to(lo), resolved_nb(n, nb))


@accurate_matmuls
def getrs_refined_batched(A, LU_lo, perm, B, max_iters: int = 30,
                          tol: Optional[float] = None, device="cuda"):
    """Batched refined solve from resident LOW-precision LU factors: the
    initial low-precision solve and the per-item-masked refinement loop.
    ``A`` is the working-precision operand stack the residual gemms read.
    Returns (x, iters (B,), converged (B,)); iters counts each item's
    residual checks."""
    a = _as_stack(A, "getrs_refined_batched", device)
    bsz, n, _ = a.shape
    lu = _tensor(LU_lo, a.device)
    b, vector = _rhs_stack(B, bsz, n, a, "getrs_refined_batched")
    x, iters, conv = _getrs_refined(a, lu, _tensor(perm, a.device), b,
                                    max_iters, tol)
    return _out(x, vector), iters, conv


@accurate_matmuls
def potrs_refined_batched(A, L_lo, B, max_iters: int = 30,
                          tol: Optional[float] = None, device="cuda"):
    """Batched refined solve from resident low-precision Cholesky factors
    (``A`` in lower storage) → (x, iters (B,), converged (B,))."""
    a = _as_stack(A, "potrs_refined_batched", device)
    bsz, n, _ = a.shape
    b, vector = _rhs_stack(B, bsz, n, a, "potrs_refined_batched")
    x, iters, conv = _potrs_refined(a, _tensor(L_lo, a.device), b,
                                    max_iters, tol)
    return _out(x, vector), iters, conv


@accurate_matmuls
def gesv_mixed_batched(A, B, nb: Optional[int] = None,
                       factor_dtype="bfloat16", max_iters: int = 30,
                       tol: Optional[float] = None, device="cuda"):
    """Batched mixed-precision A·X = B: low-precision LU and per-item
    refinement → (X, info (B,), iters (B,)); iters[i] < 0: item i did not
    converge (its X is the last iterate; the caller owns the fallback,
    see ``api.gesv_mixed_batched``)."""
    a = _as_stack(A, "gesv_mixed_batched", device)
    n = _square(a, "gesv_mixed_batched")
    lo = _guard_mixed_dtype(a.dtype, factor_dtype, "gesv_mixed_batched")
    b, vector = _rhs_stack(B, a.shape[0], n, a, "gesv_mixed_batched")
    lu, perm, info = blocked.getrf_batched(a.to(lo), resolved_nb(n, nb))
    x, iters, conv = _getrs_refined(a, lu, perm, b, max_iters, tol)
    return _out(x, vector), info, torch.where(conv, iters, -iters)


@accurate_matmuls
def posv_mixed_batched(A, B, nb: Optional[int] = None,
                       factor_dtype="bfloat16", max_iters: int = 30,
                       tol: Optional[float] = None, device="cuda"):
    """Batched mixed-precision Hermitian positive definite solve (lower
    storage): low-precision Cholesky and per-item refinement → (X,
    info (B,), iters (B,)); iters < 0: not converged."""
    a = _as_stack(A, "posv_mixed_batched", device)
    n = _square(a, "posv_mixed_batched")
    lo = _guard_mixed_dtype(a.dtype, factor_dtype, "posv_mixed_batched")
    b, vector = _rhs_stack(B, a.shape[0], n, a, "posv_mixed_batched")
    l, info = blocked.potrf_batched(a.to(lo), resolved_nb(n, nb))
    x, iters, conv = _potrs_refined(a, l, b, max_iters, tol)
    return _out(x, vector), info, torch.where(conv, iters, -iters)
