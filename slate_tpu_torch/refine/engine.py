"""Unified iterative-refinement engine: the loop behind the Session's
refined operators and the batched mixed verbs (counterpart of
``slate_tpu/refine/engine.py:60-330``).

Reference lineage: ``slate::gesv_mixed`` / ``posv_mixed`` (factor cheap,
refine the residual in the working precision) and the ``*_mixed_gmres``
GMRES-IR variants. The engine splits the loop into three seams the
Session runs independently:

* :func:`make_factor_fn`  — operand → low-precision resident factor (the
  cast happens inside, so the resident's bytes are the factor type's);
* :func:`make_start_fn` / :func:`make_step_fn` — the initial
  low-precision solve and ONE refinement step (working-precision
  residual gemm, low-precision factor apply, update, and the fused
  (‖R‖max, ‖X‖max) pair). Each is a plain function of its tensors, so
  the Session can capture it as a CUDA graph and replay it;
* :func:`drive` — the host convergence loop (one read of the norm pair
  per step, the reference's ‖r‖ ≤ ‖x‖·‖A‖·ε·√n criterion).

Strategies: classic IR and GMRES-IR (:func:`gmres_solve`, the FGMRES
cycle of ``linalg/gmres.py`` with the resident factor as its
preconditioner). The batched engine runs the same per-item semantics
through :func:`batched_ir_loop`, a Python loop with a per-item mask on
the device: a converged lane is never written again, so a B = 1 run
equals its lane of a larger batch. Non-convergence is a result
(``converged=False``), never an exception: the Session turns it into a
counted working-precision fallback.

Every step runs under ``full_precision`` (TF32 off, bf16 products
reduced in float32), as the reference runs its steps at HIGHEST.

The linalg verbs ``gesv_mixed``/``posv_mixed`` keep the reference's own
loop and its ‖·‖∞ criterion on purpose (their iteration counts are held
to the reference's drivers); this engine is the loop of the Session's
refined operators, the GMRES-IR strategy and the batched verbs.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ..core.precision import full_precision
from ..core.tiled_matrix import TiledMatrix
from ..core.types import MatrixKind, Uplo
from .policy import RefinePolicy, canonical_dtype_name, torch_dtype

# Session op kinds the dense engine refines (QR least squares and band
# solves have no reference mixed driver; the batched engine covers the
# *_small kinds through batched_ir_loop)
REFINE_OPS = ("lu", "chol")


# the column strips a Hermitian operand's residual product reads its
# stored triangle in (its temporaries are O(n·(strip + cols)))
_RESIDUAL_STRIP = 1024


def _residual(A: TiledMatrix, X: TiledMatrix, B: TiledMatrix, rdt
              ) -> TiledMatrix:
    """R = B − A·X in the residual type ``rdt``, reading A's storage where
    it lies. A General A is one product (by column strips when it is
    cast). A Hermitian or Symmetric A is read from its stored triangle,
    one strip of ``_RESIDUAL_STRIP`` columns at a time: the strip's
    diagonal block mirrored, the part beyond it used once as stored and
    once (conjugate-)transposed. No n² temporary is made, where hemm
    builds the full operand (3·n² of a captured step's pool)."""
    a = A.dense_canonical()
    x = X.dense_canonical().to(rdt)
    b = B.dense_canonical().to(rdt)
    n = a.shape[0]
    sym = A.kind in (MatrixKind.Hermitian, MatrixKind.Symmetric)
    if not sym and a.dtype == rdt:
        return TiledMatrix(b - a @ x, B.shape[0], B.shape[1], B.nb)
    herm = A.kind is MatrixKind.Hermitian
    lower = A.uplo is Uplo.Lower
    y = torch.zeros_like(b)
    for j0 in range(0, n, _RESIDUAL_STRIP):
        j1 = min(j0 + _RESIDUAL_STRIP, n)
        if not sym:
            y.addmm_(a[:, j0:j1].to(rdt), x[j0:j1])
            continue
        d = a[j0:j1, j0:j1].to(rdt)
        tri, strict = ((torch.tril(d), torch.tril(d, -1)) if lower
                       else (torch.triu(d), torch.triu(d, 1)))
        full = tri + (strict.mH if herm else strict.mT)
        if herm and full.is_complex():
            full.diagonal().imag.zero_()
        y[j0:j1].addmm_(full, x[j0:j1])
        if j1 == n:
            break
        # A[j1:, j0:j1] as a view of the stored triangle
        if lower:
            below = a[j1:, j0:j1].to(rdt)
        else:
            right = a[j0:j1, j1:].to(rdt)
            below = right.mH if herm else right.mT
        y[j1:].addmm_(below, x[j0:j1])
        y[j0:j1].addmm_(below.mH if herm else below.mT, x[j1:])
    return TiledMatrix(b - y, B.shape[0], B.shape[1], B.nb)


def _apply_factor(op: str, payload, R_lo, opts):
    """Low-precision factor apply M⁻¹·R through the public
    ``*_solve_using_factor`` verbs."""
    from .. import api
    if op == "lu":
        LU_lo, perm = payload
        return api.lu_solve_using_factor(LU_lo, perm, R_lo, opts)
    return api.chol_solve_using_factor(payload[0], R_lo, opts)


def make_factor_fn(op: str, opts, policy: RefinePolicy):
    """A (working precision) → (payload_lo, info): the cast to the factor
    type, then the factor, one function per (op, opts, policy)."""
    lo = torch_dtype(policy.factor_dtype)

    def factor(A):
        from .. import api
        from ..linalg import elementwise as ew
        A_lo = ew.copy(A, dtype=lo)
        if op == "lu":
            LU, perm, info = api.lu_factor(A_lo, opts)
            return (LU, perm), info
        L, info = api.chol_factor(A_lo, opts)
        return (L,), info

    factor.__name__ = f"refine_{op}_factor_{policy.factor_dtype}"
    return factor


def make_start_fn(op: str, opts, policy: RefinePolicy, work_dtype):
    """(payload_lo, B) → X0: the initial low-precision solve of every
    right-hand side at once, cast up to the working precision."""
    lo = torch_dtype(policy.factor_dtype)

    def start(payload, B):
        from ..linalg import elementwise as ew
        with full_precision():
            X0 = _apply_factor(op, payload, ew.copy(B, dtype=lo), opts)
            return ew.copy(X0, dtype=work_dtype)

    start.__name__ = f"refine_{op}_start"
    return start


def make_step_fn(op: str, opts, policy: RefinePolicy, work_dtype):
    """(payload_lo, A, B, X) → (X_new, norms (2,)): ONE refinement step —
    R = B − A·X in the residual precision (:func:`_residual`: from the
    stored triangle of a Hermitian or Symmetric operand), D = M⁻¹R in the
    factor type, X + D, and the pair (‖R‖max, ‖X‖max) stacked so the
    host check costs one device read per step."""
    lo = torch_dtype(policy.factor_dtype)
    rdt = torch_dtype(policy.residual_dtype or canonical_dtype_name(
        work_dtype))

    def step(payload, A, B, X):
        from ..linalg import elementwise as ew
        with full_precision():
            R = _residual(A, X, B, rdt)
            norms = torch.stack([R.dense_canonical().abs().max(),
                                 X.dense_canonical().abs().max()])
            D = _apply_factor(op, payload, ew.copy(R, dtype=lo), opts)
            X_new = ew.add(1.0, ew.copy(D, dtype=work_dtype), 1.0, X, opts)
            return X_new, norms

    step.__name__ = f"refine_{op}_step"
    return step


def convergence_threshold(anorm: float, n: int, work_dtype,
                          policy: RefinePolicy) -> float:
    """The reference criterion's constant: ‖r‖ ≤ cte·‖x‖ with
    cte = ‖A‖_inf · tol, tol defaulting to eps(working)·√n."""
    eps = float(torch.finfo(torch_dtype(canonical_dtype_name(
        work_dtype))).eps)
    tol = policy.tol if policy.tol is not None else eps * math.sqrt(n)
    return float(anorm) * tol


def drive(start_fn: Callable, step_fn: Callable, payload, A, B,
          anorm: float, policy: RefinePolicy, work_dtype,
          on_start: Optional[Callable] = None,
          on_step: Optional[Callable] = None,
          fault_hook: Optional[Callable] = None
          ) -> Tuple[object, int, bool]:
    """The host convergence loop over the start and step functions (eager
    or graph replays). Returns (X, iters, converged): ``iters`` counts
    residual checks (convergence on the first check is iters = 1 with no
    update applied), a step whose check converges returns the PRE-update
    X, and non-convergence returns ``converged=False`` with the last X.
    ``on_start()`` / ``on_step(it)`` fire after each call.
    ``fault_hook`` (a zero-argument bool callable, evaluated once after
    the initial solve): True simulates a stagnating refinement — the loop
    exits at once with ``converged=False`` and drives the same counted
    fallback a non-convergent operand takes."""
    cte = convergence_threshold(anorm, A.shape[0], work_dtype, policy)
    X = start_fn(payload, B)
    if on_start is not None:
        on_start()
    if fault_hook is not None and fault_hook():
        return X, 0, False
    iters = 0
    converged = False
    for it in range(1, policy.max_iters + 1):
        X_new, norms = step_fn(payload, A, B, X)
        if on_step is not None:
            on_step(it)
        rnorm, xnorm = norms.tolist()
        iters = it
        if rnorm <= cte * xnorm:
            converged = True
            break
        X = X_new
    return X, iters, converged


def gmres_solve(A, B, payload, op: str, policy: RefinePolicy, opts
                ) -> Tuple[object, int, bool]:
    """GMRES-IR strategy: FGMRES in the working precision,
    right-preconditioned by the resident low-precision factor, under this
    policy's (max_iters, tol). Returns (X, iters, converged)."""
    from ..core.tiled_matrix import unit_pad_diag
    from ..linalg import gmres as gmres_mod

    opts2 = opts.replace(max_iterations=policy.max_iters,
                         tolerance=policy.tol)
    with full_precision():
        if op == "lu":
            LU_lo, perm = payload
            fac = unit_pad_diag(LU_lo.dense_canonical().clone(),
                                *LU_lo.shape)
            X, iters = gmres_mod._ir_gmres(A, B, opts2, fac, perm, "lu")
        else:
            L_lo = payload[0]
            fac = unit_pad_diag(torch.tril(L_lo.dense_canonical()),
                                *L_lo.shape)
            X, iters = gmres_mod._ir_gmres(A, B, opts2, fac, None, "chol")
    return X, min(abs(iters), policy.max_iters), iters >= 0


def solve_refined(A, B, op: str = "lu", opts=None,
                  policy: Optional[RefinePolicy] = None
                  ) -> Tuple[object, int, int, bool]:
    """Eager end-to-end engine solve: factor low, refine to working
    accuracy. Returns (X, info, iters, converged), running the same
    factor/start/step functions the Session serves."""
    from ..core.types import DEFAULT_OPTIONS, Norm
    from ..linalg.norms import norm
    opts = DEFAULT_OPTIONS if opts is None else opts
    if policy is None:
        policy = RefinePolicy()
    policy.validate_for(A.dtype)
    if op not in REFINE_OPS:
        raise ValueError(f"solve_refined: op must be one of {REFINE_OPS}")
    payload, info = make_factor_fn(op, opts, policy)(A)
    if int(info) != 0:
        return B, int(info), 0, False
    anorm = float(norm(A, Norm.Inf))
    if policy.strategy == "gmres":
        X, iters, converged = gmres_solve(A, B, payload, op, policy, opts)
    else:
        X, iters, converged = drive(
            make_start_fn(op, opts, policy, A.dtype),
            make_step_fn(op, opts, policy, A.dtype), payload, A, B, anorm,
            policy, A.dtype)
    return X, int(info), iters, converged


# -- the batched engine's loop (per-item masks) ------------------------------


def batched_ir_loop(a, b, x0, apply_lo: Callable, cte, max_iters: int):
    """ONE refinement loop over a (B, n, n) stack with :func:`drive`'s
    per-item semantics: an iteration is the residual, the check and a
    masked update; ``iters[i]`` counts item i's residual checks; an item
    whose check passes freezes (its lane is never written again), and an
    item still active when the budget runs out reports
    ``converged[i]=False`` (a NaN residual never compares converged, so a
    singular low-precision factor poisons only its own lane). The loop
    ends when no lane is active, read on the host once per iteration.

    ``apply_lo(r) -> d`` is the caller's low-precision factor apply (cast
    down, batched triangular solves, cast up); ``cte`` the per-item (B,)
    convergence constant. Returns (x, iters (B,) int32, converged (B,))."""
    bsz = a.shape[0]
    x = x0
    active = torch.ones(bsz, dtype=torch.bool, device=a.device)
    iters = torch.zeros(bsz, dtype=torch.int32, device=a.device)
    for _ in range(max_iters):
        if not bool(active.any()):
            break
        r = b - a @ x
        conv = r.abs().amax(dim=(1, 2)) <= cte * x.abs().amax(dim=(1, 2))
        iters = iters + active.to(torch.int32)
        still = active & ~conv
        x = torch.where(still[:, None, None], x + apply_lo(r), x)
        active = still
    return x, iters, ~active


def batched_cte(a, tol: Optional[float]):
    """Per-item convergence constant (B,): ‖A_i‖_inf · tol with tol
    defaulting to eps(working)·√n (the constant :func:`drive` uses)."""
    n = a.shape[1]
    anorm = a.abs().sum(dim=2).amax(dim=1)
    t = (float(tol) if tol is not None
         else float(torch.finfo(anorm.dtype).eps) * math.sqrt(n))
    return anorm * t
