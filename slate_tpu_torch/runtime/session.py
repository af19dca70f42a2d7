"""Resident-factor solve service (counterpart of the dense single-device
core of ``slate_tpu/runtime/session.py``).

A Session registers operators, factors each once on first use, keeps
the factor resident under a byte budget (LRU eviction, refactor on
miss) and serves solves from it. The ported slices cover dense
``TiledMatrix`` operators under ``op`` "chol", "lu" and "qr" (tall
least-squares operators: ``solve`` takes m-row right-hand sides and
returns n-row solutions) and the small-problem operators "lu_small" and
"chol_small": a plain dense (n, n) numpy array or tensor, factored and
solved by the batched engine (``linalg/batched.py``) at B = 1 per
request, or many requests at once through ``solve_small_batched``.

``warmup`` factors an operator off the request path and, on a CUDA
device, captures its dense solve as a ``torch.cuda.CUDAGraph`` (the
card's counterpart of the reference's AOT-compiled solve program):
``solve_matrix`` replays it whenever a request's padded right-hand side
matches. The Batcher and Executor (``batching.py``, ``executor.py``) sit
above this class; ``faults`` injects failures at its seams.

Mixed precision: ``register(..., refine=True | RefinePolicy)`` keeps a
LOW-precision factor resident for an lu/chol operator (dense or small;
its bytes are the factor type's, so a bf16 resident of an f32 operator
costs half) and refines every solve to working accuracy through the
refine engine (``refine/engine.py``): classic IR or GMRES-IR. A refined
dense operator's warmup captures the engine's ``start`` and ``step``
functions as two CUDA graphs, which ``drive`` replays (GMRES-IR stays
eager). A low-precision factor that fails, or a solve that does not
converge, takes the counted working-precision fallback
(``refine_fallbacks_total``; the operator is served unrefined from then
on), or raises when the policy disables fallback.
``demote_to_working_precision`` is the Executor's ``working_precision``
rung.

Incremental updates: ``update`` serves a mutated operand against the
resident factor at O(n²k) (``linalg/update.py``): a rank-k up/downdate of
a chol or chol_small operator, rows appended to or deleted from a qr
operator, and ``update_small_batched`` for many chol_small operators at
once. A chol factor is updated in its own storage, so the solve graphs
captured on it stay valid; a qr append writes its factors into the
resident's append slots, which ``warmup(update_k=...)`` makes at the
bucket and captures the appended solve on. Every degraded path
(a failed downdate, a deleted base row, an injected ``update_abort``, the
update budget coming due) is a counted refactor of the committed operand.

Spectral serving: an "eig" operator (a square Hermitian/Symmetric
TiledMatrix) or an "svd" operator (a tall or square one) keeps its
two-stage decomposition resident (``spectral/``: ``heev_staged`` or
``svd_staged``, always info = 0), and ``apply`` serves every function of
its catalog as two gemms and a diagonal scale: X = L·diag(f(Λ, θ))·Rᴴ·b.
``solve`` serves the catalog's "solve" at θ = 0, so the Batcher and
Executor serve a spectral handle unchanged; ``eigvals`` reads the
resident spectrum. ``warmup`` captures one CUDA graph per catalog
function at the warmed width; θ lives in a static 0-d tensor of the
operand's real type, filled before each replay, so a request at any θ
replays with no new capture.

Meshes, band operators, tenants, SLOs, attribution, the numerics probe,
the recorder and tracing are later slices: they raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import traceback
from collections import OrderedDict
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from .. import api
from ..core.exceptions import SlateError
from ..core.precision import full_precision
from ..linalg.qr import QRFactors
from .. import spectral as _spectral
from ..spectral.types import EigFactors, SVDFactors
from ..core.tiled_matrix import (TiledMatrix, from_dense, num_tiles,
                                 resolve_device)
from ..core.types import MatrixKind, Norm, Options, DEFAULT_OPTIONS
from ..linalg import batched as _batched
from ..linalg import update as _upd
from ..linalg.norms import norm
from ..obs import flops as _flops
from ..obs import numerics as _num
from ..ops import hopper_ops as ho
from ..refine import engine as _refine
from ..refine.policy import (PolicyTable, RefinePolicy,
                             canonical_dtype_name, default_factor_dtype)
from .metrics import Metrics

SMALL_OPS = ("lu_small", "chol_small")
# the resident spectral decompositions (spectral/), served by ``apply``
SPECTRAL_OPS = ("eig", "svd")
OPS = ("lu", "chol", "qr") + SMALL_OPS + SPECTRAL_OPS
# the op kinds with an incremental-update form (Session.update)
UPDATE_OPS = ("chol", "chol_small", "qr")
# the op kinds a refine policy covers
REFINE_KINDS = _refine.REFINE_OPS + SMALL_OPS
# op kinds of the reference Session that later slices port
LATER_OPS = ("band_lu", "band_chol")
# where the reference Session's other serving features are queued
_TENANTS_LATER = "tenants and tenant policies are not ported yet (ROADMAP " \
                 "Queue 1 item 11)"
_OBS_LATER = "is not ported yet (observability: ROADMAP Queue 1 item 10)"


@dataclasses.dataclass
class _Operator:
    A: object  # a TiledMatrix, or an (n, n) tensor for the small ops
    op: str
    opts: Options
    m: int
    n: int
    # the refine policy serving this operator; None: working precision
    # (set to None for good by a refine fallback or a demotion)
    refine: Optional[RefinePolicy] = None
    anorm: Optional[float] = None  # ‖A‖∞, taken at the first refined solve
    # updates applied since the last fresh factor, and their accumulated
    # weight (obs/numerics.py's budget)
    updates: int = 0
    update_weight: float = 0.0
    # the operand's storage is the Session's (a committed update made it),
    # so a later update may write it in place
    owned: bool = False


@dataclasses.dataclass
class _SolveGraph:
    """One captured dense solve: replaying ``graph`` solves the static
    right-hand side ``b`` into the static solution ``x`` (a TiledMatrix
    whose storage lives in the graph's memory pool). A spectral apply's
    graph also reads the static 0-d ``theta``. ``nbytes``: the static
    inputs plus the pool the capture reserved."""
    graph: object
    b: torch.Tensor
    x: TiledMatrix
    nbytes: int
    theta: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _RefineGraphs:
    """The two captured programs of a refined dense solve on one resident
    low-precision factor: replaying ``start`` solves the static right-hand
    side ``b`` into ``x0``; replaying ``step`` takes ``b`` and the static
    iterate ``x`` to ``x_new`` and the norm pair ``norms``. ``nbytes``:
    the static tensors plus the pools the captures reserved."""
    start: object
    step: object
    b: torch.Tensor
    x: torch.Tensor
    x0: TiledMatrix
    x_new: TiledMatrix
    norms: torch.Tensor
    nbytes: int


@dataclasses.dataclass
class _Resident:
    # the *_solve_using_factor arguments, or an EigFactors / SVDFactors
    payload: object
    info: int
    nbytes: int  # the payload's bytes plus its graphs'
    # the CUDA graphs of the warmed solves on this factor, by key
    # (``_key_kind``); they go with the factor
    graphs: Dict[Tuple, _SolveGraph] = dataclasses.field(
        default_factory=dict)
    # a qr resident's append slots (u, w, tau, r) at one row bucket: every
    # append writes its factors there (an appended payload is the base
    # with the slots), so the appended solve's graphs stay valid
    slots: Optional[Tuple] = None


def _payload_nbytes(payload) -> int:
    if isinstance(payload, EigFactors):
        return _tensor_bytes((payload.v.data, payload.lam))
    if isinstance(payload, SVDFactors):
        return _tensor_bytes((payload.u.data, payload.s, payload.v.data))
    total = 0
    for p in payload:
        if isinstance(p, QRFactors):
            tensors = (p.vr, p.t)
        else:
            tensors = (p.data if isinstance(p, TiledMatrix) else p,)
        total += sum(t.numel() * t.element_size() for t in tensors)
    return total


def _small_factor(op: str, stack: torch.Tensor,
                  policy: Optional[RefinePolicy] = None):
    """The batched factor of a (B, n, n) stack of small operators →
    (per-item payloads, info (B,)), in the refine policy's factor type
    when one is given. Each payload is a copy of its item, not a view: a
    view would keep the whole stack allocated while any item of it stays
    cached, and the byte budget counts each item alone."""
    if op == "lu_small":
        lus, perms, info = (
            _batched.getrf_batched(stack) if policy is None else
            _batched.getrf_mixed_batched(stack, policy.factor_dtype))
        return [(lu.clone(), p.clone()) for lu, p in zip(lus, perms)], info
    ls, info = (_batched.potrf_batched(stack) if policy is None else
                _batched.potrf_mixed_batched(stack, policy.factor_dtype))
    return [(l.clone(),) for l in ls], info


def _small_solve(op: str, payloads, b: torch.Tensor) -> torch.Tensor:
    """One batched solve of the stacked per-item payloads against the
    (B, n, k) or (B, n) right-hand sides ``b``."""
    if op == "lu_small":
        return _batched.getrs_batched(torch.stack([p[0] for p in payloads]),
                                      torch.stack([p[1] for p in payloads]),
                                      b)
    return _batched.potrs_batched(torch.stack([p[0] for p in payloads]), b)


def _small_refined(op: str, a: torch.Tensor, payloads, b: torch.Tensor,
                   policy: RefinePolicy):
    """One batched refined solve of the (B, n, n) working-precision
    operands ``a`` from their stacked low-precision payloads → (x, iters
    (B,), converged (B,))."""
    if op == "lu_small":
        return _batched.getrs_refined_batched(
            a, torch.stack([p[0] for p in payloads]),
            torch.stack([p[1] for p in payloads]), b,
            max_iters=policy.max_iters, tol=policy.tol)
    return _batched.potrs_refined_batched(
        a, torch.stack([p[0] for p in payloads]), b,
        max_iters=policy.max_iters, tol=policy.tol)


def _make_factor_fn(op: str, opts: Options,
                    policy: Optional[RefinePolicy] = None):
    """The factor verb as an A -> (payload, info) function (the small ops:
    the B = 1 run of the batched factor), in the refine policy's factor
    type when one is given."""
    if op in SMALL_OPS:
        def factor(A):
            payloads, info = _small_factor(op, A[None], policy)
            return payloads[0], info[0]
    elif op == "eig":
        # the staged two-stage pipeline ends in stedc, which has no
        # failure to report: a spectral resident is always info = 0
        def factor(A):
            lam, V = _spectral.heev_staged(A, opts)
            return EigFactors(V, lam), 0
    elif op == "svd":
        def factor(A):
            s, U, V = _spectral.svd_staged(A, opts)
            return SVDFactors(U, s, V), 0
    elif policy is not None:
        factor = _refine.make_factor_fn(op, opts, policy)
    elif op == "lu":
        def factor(A):
            LU, perm, info = api.lu_factor(A, opts)
            return (LU, perm), info
    elif op == "chol":
        def factor(A):
            L, info = api.chol_factor(A, opts)
            return (L,), info
    else:
        def factor(A):
            return (api.qr_factor(A, opts),), 0
    return factor


def _make_solve_fn(op: str, opts: Options):
    """The *_solve_using_factor verb as a (payload, B) -> X function (a
    spectral operator is served by its catalog: ``_dispatch_spectral``)."""
    if op == "lu":
        def solve(payload, B):
            LU, perm = payload
            return api.lu_solve_using_factor(LU, perm, B, opts)
    elif op == "chol":
        def solve(payload, B):
            return api.chol_solve_using_factor(payload[0], B, opts)
    elif op != "qr":
        raise SlateError(f"Session: op {op!r} has no *_solve_using_factor "
                         "verb")
    else:
        def solve(payload, B):
            if _appended(payload):
                return _upd.appended_gels(payload, B, opts)
            return api.least_squares_solve_using_factor(payload[0], B,
                                                        opts)
    return solve


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _appended(payload) -> bool:
    """Is ``payload`` an appended-rows qr resident's (base, u, w, tau, r)?"""
    return (isinstance(payload, tuple) and isinstance(payload[0], QRFactors)
            and len(payload) > 1)


def _key_kind(key: Tuple) -> str:
    """The kind of a solve graph's key: (rows, cols, dtype) is a "base"
    solve, (rows, cols, dtype, "append") a qr resident's appended solve and
    (rows, cols, dtype, "spectral", fname) a spectral resident's apply of
    the catalog function ``fname``."""
    return key[3] if len(key) > 3 else "base"


def _spectrum(payload) -> torch.Tensor:
    """A spectral resident's Λ (eig) or Σ (svd)."""
    return payload.lam if isinstance(payload, EigFactors) else payload.s


def _norm1(t: torch.Tensor) -> float:
    """‖t‖₁ of a plain (rows, cols) tensor: the largest column sum of |t|."""
    return float(t.abs().sum(0).max()) if t.numel() else 0.0


def _failing_call(e: BaseException) -> str:
    """The innermost frame of ``e``'s traceback as "function (file:line)"."""
    frames = traceback.extract_tb(e.__traceback__)
    if not frames:
        return "?"
    f = frames[-1]
    return f"{f.name} ({os.path.basename(f.filename)}:{f.lineno})"


class Session:
    """Resident-factorization solve service with a byte-budget LRU cache.

    ``hbm_budget`` bounds the device bytes of CACHED FACTORS and their
    solve graphs (the registered operators are the caller's and are not
    charged); ``None`` is unbounded. A factor larger than the whole
    budget is kept (serving needs it) and counted in
    ``budget_overflows``. ``device`` defaults to "cuda" and raises
    without a card unless "cpu" is asked for. Public methods are
    thread-safe (one lock, held across device work); ``op_meta``,
    ``degrade_class``, ``small_group_key`` and ``recompute_cost`` read
    without it, so an enqueue never waits on a solve."""

    def __init__(self, hbm_budget: Optional[int] = None,
                 opts: Options = DEFAULT_OPTIONS,
                 metrics: Optional[Metrics] = None, device="cuda",
                 refine_policies: Optional[PolicyTable] = None,
                 tenant_policies=None, tracer=None):
        if tenant_policies is not None:
            raise NotImplementedError(f"Session: {_TENANTS_LATER}")
        if tracer is not None:
            raise NotImplementedError(f"Session: tracing {_OBS_LATER}")
        self.hbm_budget = hbm_budget
        self.opts = opts
        # register(..., refine=True) resolves its RefinePolicy here per
        # (op, n, working dtype); with no rule, the one-tier-down ladder
        self.refine_policies = refine_policies or PolicyTable()
        self.device = resolve_device(device)
        self.metrics = metrics or Metrics()
        # a FaultInjector (enable_faults); None: every seam is one check
        self.faults = None
        self._lock = threading.RLock()
        self._ops: Dict[Hashable, _Operator] = {}
        self._cache: "OrderedDict[Hashable, _Resident]" = OrderedDict()
        self._cached_total = 0  # the bytes of the residents in _cache
        # the graph keys warmup asked for, per handle: a refactored
        # resident captures them again on its first matching solve
        self._warm: Dict[Hashable, set] = {}
        self._seq = 0

    # -- registration ------------------------------------------------------
    @staticmethod
    def _infer_op(A) -> str:
        if not hasattr(A, "kind"):
            return "lu_small"  # plain arrays: the small-problem engine
        if A.kind in (MatrixKind.Hermitian, MatrixKind.Symmetric):
            return "chol"
        if A.shape[0] != A.shape[1]:
            return "qr"
        return "lu"

    def register(self, A, op: str = "auto",
                 handle: Optional[Hashable] = None,
                 opts: Optional[Options] = None,
                 tenant: Optional[str] = None,
                 refine=None) -> Hashable:
        """Register an operator; returns its handle (an int unless
        given). ``op`` is "chol", "lu", "qr", "lu_small", "chol_small",
        "eig", "svd" or "auto" (a plain array → lu_small;
        Hermitian/Symmetric → chol, square general → lu, non-square →
        qr). A "qr" or "svd" operator must be tall or square (m ≥ n), an
        "eig" one square and Hermitian/Symmetric; the others need a
        square one. The dense and spectral ops take a
        ``TiledMatrix`` on the session's device; the small ops a plain
        (n, n) numpy array or tensor of a float or complex type, which
        the session puts on its device.

        ``refine`` (lu/chol operators, dense or small): a RefinePolicy,
        or True to resolve one from ``refine_policies`` by (op, n, dtype)
        — a matched rule whose policy is None registers the operator
        unrefined, and with no matching rule the one-tier-down ladder
        decides (complex64 has no lower type and raises). The factor
        type must differ from the working one and agree with it in
        real/complex kind; GMRES-IR covers the dense ops only."""
        if tenant is not None:
            raise NotImplementedError(f"Session.register: {_TENANTS_LATER}")
        if op == "auto":
            op = self._infer_op(A)
        refining = refine is not None and refine is not False
        if refining and op not in REFINE_KINDS:
            raise SlateError(
                f"Session.register: refine covers lu/chol operators "
                f"(dense or small), not {op!r}")
        if op in LATER_OPS:
            raise NotImplementedError(
                f"Session.register: op {op!r} is not ported yet (ROADMAP "
                "Queue 1 item 9)")
        if op not in OPS:
            raise SlateError(f"Session.register: unknown op {op!r}")
        if (op in SMALL_OPS) == isinstance(A, TiledMatrix):
            want = ("plain dense [n, n] array" if op in SMALL_OPS
                    else "TiledMatrix")
            raise SlateError(f"Session.register: op {op!r} requires a "
                             f"{want} operand, got {type(A).__name__}")
        if op in SMALL_OPS:
            A = self._small_operand(A)
        elif A.device != self.device:
            raise SlateError(f"Session.register: operand on {A.device}, "
                             f"session on {self.device}")
        m, n = A.shape
        if op == "qr":
            if m < n:
                # gels_using_factor covers only the overdetermined case;
                # the minimum-norm path needs LQ factors
                raise SlateError(
                    "Session.register: wide (m < n) operators are not "
                    "servable via resident QR; use least_squares_solve "
                    "per call")
        elif op == "eig":
            if A.kind not in (MatrixKind.Hermitian,
                              MatrixKind.Symmetric) or m != n:
                raise SlateError(
                    "Session.register: op 'eig' requires a square "
                    "Hermitian/Symmetric TiledMatrix operand")
        elif op == "svd":
            if m < n:
                raise SlateError(
                    "Session.register: wide (m < n) operators are not "
                    "servable via resident SVD; register the transpose "
                    "(api.svd handles wide per call)")
        elif m != n:
            raise SlateError(f"Session.register: {op} needs a square "
                             f"operand, got {(m, n)}")
        policy = self._resolve_refine(refine, op, n, A.dtype) \
            if refining else None
        with self._lock:
            if handle is None:
                self._seq += 1
                while self._seq in self._ops:
                    self._seq += 1
                handle = self._seq
            if handle in self._ops:
                raise SlateError(f"Session.register: handle {handle!r} "
                                 "already registered (unregister first)")
            self._ops[handle] = _Operator(A, op, opts or self.opts, m, n,
                                          refine=policy)
        return handle

    def _resolve_refine(self, refine, op: str, n: int,
                        wd) -> Optional[RefinePolicy]:
        """The policy ``register(refine=...)`` asked for, validated
        against the working dtype ``wd`` (the reference's rules and
        messages)."""
        if refine is True:
            matched, policy = self.refine_policies.lookup(
                op.replace("_small", ""), n, wd)
            if not matched:
                lo = default_factor_dtype(wd)
                if lo is None:
                    raise SlateError(
                        f"Session.register: no refine policy resolves for "
                        f"(op={op!r}, n={n}, "
                        f"dtype={canonical_dtype_name(wd)}) — no lower factor "
                        "precision exists on the dtype ladder")
                policy = RefinePolicy(factor_dtype=lo)
        else:
            policy = refine
        if policy is not None:
            try:
                policy.validate_for(wd)
            except ValueError as e:
                raise SlateError(f"Session.register: {e}")
            if policy.strategy == "gmres" and op in SMALL_OPS:
                raise SlateError(
                    "Session.register: GMRES-IR serving covers "
                    "single-device dense operators; use strategy='ir' for "
                    "mesh or small-problem operators")
        return policy

    def _small_operand(self, A) -> torch.Tensor:
        """A small operator as a square floating-point or complex tensor
        on the session's device (the reference's validation: square, plain
        dense)."""
        t = A if isinstance(A, torch.Tensor) else torch.as_tensor(
            np.ascontiguousarray(A))
        if t.ndim != 2 or t.shape[0] != t.shape[1]:
            raise SlateError("Session.register: small-problem operators "
                             f"must be square, got {tuple(t.shape)}")
        if not (t.is_floating_point() or t.is_complex()):
            raise SlateError("Session.register: small-problem operators "
                             f"need a floating-point or complex type, got "
                             f"{t.dtype}")
        return t.to(self.device)

    def unregister(self, handle: Hashable):
        """Drop an operator, its cached factor and its graphs (no error
        if absent)."""
        with self._lock:
            self._ops.pop(handle, None)
            self._warm.pop(handle, None)
            self._drop(handle)

    def __contains__(self, handle: Hashable) -> bool:
        with self._lock:
            return handle in self._ops

    def handles(self):
        with self._lock:
            return list(self._ops)

    def op_meta(self, handle: Hashable) -> Optional[Tuple[str, int]]:
        """(op, n) of a registered handle, or None. Lock-free (a dict
        read is atomic under the GIL; entries are immutable after
        register): the Batcher and Executor call it on the request path,
        and the session lock is held across device work."""
        entry = self._ops.get(handle)
        return None if entry is None else (entry.op, entry.n)

    def degrade_class(self, handle: Hashable) -> Optional[str]:
        """The ``faults.DEGRADATION_LADDER`` family of a handle's serving
        path: "mixed" while a refine policy serves it, else "dense"; None
        for unknown handles ("mesh" arrives with ROADMAP item 12; grouped
        small buckets classify themselves). Lock-free, as ``op_meta``."""
        entry = self._ops.get(handle)
        if entry is None:
            return None
        return "mixed" if entry.refine is not None else "dense"

    def demote_to_working_precision(self, handle: Hashable) -> bool:
        """The mixed → working_precision rung of the degradation ladder
        (walked by the Executor's circuit breaker): drop the refine policy
        and evict the low-precision resident, so the next solve refactors
        at working precision. Counted in ``refine_demotions_total``.
        False when the handle is unknown or not refined."""
        with self._lock:
            entry = self._ops.get(handle)
            if entry is None or entry.refine is None:
                return False
            entry.refine = None
            self._drop(handle)
            self.metrics.inc("refine_demotions_total")
            return True

    # -- cache -------------------------------------------------------------
    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return self._cached_total

    def cached_handles(self):
        """LRU → MRU order."""
        with self._lock:
            return list(self._cache)

    def _drop(self, handle) -> bool:
        res = self._cache.pop(handle, None)
        if res is not None:
            res.graphs.clear()  # the graphs' pools go with the factor
            self._cached_total -= res.nbytes
            self.metrics.inc("evictions")
            self.metrics.inc("evicted_bytes", res.nbytes)
        self.metrics.set_gauge("resident_bytes", self.cached_bytes)
        return res is not None

    def evict(self, handle: Hashable) -> bool:
        """Drop a cached factor and its graphs (the operator stays
        registered; a warmed one captures again after its refactor)."""
        with self._lock:
            return self._drop(handle)

    def clear_cache(self):
        """Drop every cached factor and its graphs (counted as
        evictions)."""
        with self._lock:
            n, nbytes = len(self._cache), self._cached_total
            for res in self._cache.values():
                res.graphs.clear()
            self._cache.clear()
            self._cached_total = 0
            self.metrics.set_gauge("resident_bytes", 0)
        self.metrics.inc("evictions", n)
        self.metrics.inc("evicted_bytes", nbytes)

    def _insert(self, handle: Hashable, res: _Resident):
        """Cache a new factor (MRU), then evict to the budget. A fresh
        factor zeroes the operator's update accrual."""
        self._cache[handle] = res
        self._cached_total += res.nbytes
        entry = self._ops.get(handle)
        if entry is not None:
            entry.updates = 0
            entry.update_weight = 0.0
        self._evict_to_budget(keep=handle)

    def _evict_to_budget(self, keep: Hashable):
        budget = self.hbm_budget
        if self.faults is not None and self._fault("hbm"):
            # injected HBM exhaustion: the budget collapses to zero for
            # this insert, so eviction under pressure runs for real and
            # ``keep`` counts a budget overflow
            budget = 0
        if budget is not None:
            used = self.cached_bytes
            for h in list(self._cache):
                if used <= budget:
                    break
                if h != keep:
                    used -= self._cache[h].nbytes
                    self._drop(h)
            if used > budget:
                self.metrics.inc("budget_overflows")
        self.metrics.set_gauge("resident_bytes", self.cached_bytes)

    def recompute_cost(self, handle: Hashable, ncols: int = 1) -> float:
        """Model flops paid again if a request is shed and retried: one
        solve against a resident factor, factor + solve otherwise (the
        load shedder's cheapest-first key). Lock-free, as ``op_meta``:
        the Batcher calls it under its own lock."""
        entry = self._ops.get(handle)
        if entry is None:
            return 0.0
        cost = _flops.solve_flops(entry.op, entry.m, entry.n,
                                  max(ncols, 1))
        if handle not in self._cache:
            cost += _flops.factor_flops(entry.op, entry.m, entry.n)
        return cost

    def factor(self, handle: Hashable) -> _Resident:
        """Resident factor for ``handle``: cache hit, or factor on miss
        (LRU touch either way, evict to budget on insert)."""
        with self._lock:
            entry = self._entry(handle)
            res = self._cache.get(handle)
            if res is not None:
                self._cache.move_to_end(handle)
                self.metrics.inc("cache_hits")
                return res
            self.metrics.inc("cache_misses")
            t0 = time.perf_counter()
            payload, info = self._factor_payload(handle, entry)
            res = _Resident(payload, info, _payload_nbytes(payload))
            self._sync()  # the QR factor has no info sync
            self.metrics.observe("factor_latency", time.perf_counter() - t0)
            self.metrics.inc("factors_total")
            fl = _flops.factor_flops(entry.op, entry.m, entry.n)
            self.metrics.inc("flops_total", fl)
            self.metrics.inc("factor_flops_total", fl)
            self._insert(handle, res)
            return res

    def _factor_payload(self, handle: Hashable, entry: _Operator):
        """Caller holds the lock. (payload, info) of ``entry``'s factor: in
        its refine policy's factor type, or — when that factor fails, or
        the ``refine.lo_factor`` fault fires — the counted
        working-precision fallback (``refine_fallbacks_total``; the
        operator is unrefined from then on), or SlateError when the
        policy disables fallback."""
        policy = entry.refine
        payload, info = _make_factor_fn(entry.op, entry.opts,
                                        policy)(entry.A)
        info = int(info)
        if policy is None:
            return payload, info
        if (info == 0 and self.faults is not None
                and self._fault("refine.lo_factor")):
            info = 1  # an injected failure of the low-precision factor
        if info == 0:
            return payload, info
        self._refine_fallback(
            handle, entry, policy,
            f"low-precision factor of {handle!r} failed (info={info})")
        payload, info = _make_factor_fn(entry.op, entry.opts)(entry.A)
        return payload, int(info)

    def factor_info(self, handle: Hashable) -> int:
        with self._lock:
            res = self._cache.get(handle)
            return res.info if res is not None else self.factor(handle).info

    # -- faults ------------------------------------------------------------
    def enable_faults(self, plan=None, seed: int = 1):
        """Attach a ``FaultInjector`` built from ``plan`` (a FaultPlan or
        its dict; default ``faults.default_plan(seed)``) and return it. A
        second call replaces the injector."""
        from .faults import FaultInjector, FaultPlan, default_plan
        if plan is None:
            plan = default_plan(seed)
        elif isinstance(plan, dict):
            plan = FaultPlan.from_dict(plan)
        self.faults = FaultInjector(plan)
        return self.faults

    def _fault(self, site: str):
        """One fault opportunity at ``site`` (the caller checked
        ``self.faults is not None``): count what fired, sleep the
        latency-shaped kinds first, then raise for ``dispatch_error``.
        Returns the fired specs (the hbm seam branches on them)."""
        from .faults import TransientDispatchError
        fired = self.faults.fire(site)
        for spec in fired:
            self.metrics.inc("faults_injected_total")
            self.metrics.inc("fault:" + spec.kind)
            if spec.latency_s:
                time.sleep(spec.latency_s)
        for spec in fired:
            if spec.kind == "dispatch_error":
                raise TransientDispatchError(
                    f"injected transient dispatch failure at {site!r}")
        return fired

    # -- observability: later slices -----------------------------------------
    def enable_slo(self, *args, **kwargs):
        raise NotImplementedError(f"Session.enable_slo {_OBS_LATER}")

    def enable_attribution(self, *args, **kwargs):
        raise NotImplementedError(f"Session.enable_attribution {_OBS_LATER}")

    def enable_recorder(self, *args, **kwargs):
        raise NotImplementedError(f"Session.enable_recorder {_OBS_LATER}")

    # -- solves ------------------------------------------------------------
    def _entry(self, handle: Hashable) -> _Operator:
        entry = self._ops.get(handle)
        if entry is None:
            raise SlateError(f"Session: unknown handle {handle!r}")
        return entry

    def solve_matrix(self, handle: Hashable, B: TiledMatrix,
                     tenant: Optional[str] = None,
                     spectral_fn: str = "solve",
                     theta: float = 0.0) -> TiledMatrix:
        """Solve with the resident factor; B is a TiledMatrix on the
        session's device. Raises on factorization failure (info > 0).
        A warmed operator replays its captured graph (a refined one: its
        start and step graphs) when B's padded shape and type match it.
        A spectral operator serves ``spectral_fn`` of its catalog at
        ``theta`` (``apply``). ``solve_latency`` ends when the device has
        finished."""
        if tenant is not None:
            raise NotImplementedError(
                f"Session.solve_matrix: {_TENANTS_LATER}")
        with self._lock:
            entry = self._entry(handle)
            if entry.op in SMALL_OPS:
                raise SlateError("Session.solve_matrix: small-problem "
                                 "operators take arrays; use solve")
            spectral = entry.op in SPECTRAL_OPS
            fname = spectral_fn if spectral else None
            if spectral:
                self._check_spectral_rhs(entry, fname, B)
            res = self._factored(handle)
            graph = self._graph_for(handle, entry, res, B, fname)
            if self.faults is not None:
                self._fault("dispatch")
            t0 = time.perf_counter()
            if spectral:
                X = self._dispatch_spectral(entry, res, B, graph, fname,
                                            theta)
            elif entry.refine is not None:
                X = self._dispatch_refined(handle, entry, res, B, graph)
            else:
                X = self._dispatch_plain(entry, res, B, graph)
            self._sync()
            self._count_solve(entry.op, entry.m, entry.n, int(B.shape[1]),
                              time.perf_counter() - t0)
            return X

    # -- resident spectral serving (spectral/) ------------------------------
    @staticmethod
    def _rhs_rows(entry: _Operator, fname: Optional[str] = None) -> int:
        """The rows of a right-hand side: m, except n for an svd
        operator's forward functions (truncate); an eig operator has
        m = n."""
        if entry.op == "svd" and _spectral.SVD_FUNCTIONS[fname][1]:
            return entry.n
        return entry.m

    def _check_spectral_rhs(self, entry: _Operator, fname: str,
                            B: TiledMatrix):
        """A served function of the operator's catalog, on a right-hand
        side of the rows it takes (the reference's message for an unknown
        function)."""
        catalog = _spectral.function_catalog(entry.op)
        if fname not in catalog:
            raise SlateError(
                f"Session.apply: unknown function {fname!r} for op "
                f"{entry.op!r}; served functions: {sorted(catalog)}")
        rows = self._rhs_rows(entry, fname)
        if B.shape[0] != rows:
            raise SlateError(
                f"Session.apply: {entry.op} {fname!r} takes {rows}-row "
                f"right-hand sides, got {B.shape[0]}")

    def _spectral_theta(self, entry: _Operator, theta) -> torch.Tensor:
        """θ as a 0-d tensor of the operand's real type on the device
        (the eager apply's; a graph's lives in its static tensor)."""
        rdt = torch.empty((), dtype=entry.A.dtype).real.dtype
        return torch.full((), float(theta), dtype=rdt, device=self.device)

    def _dispatch_spectral(self, entry: _Operator, res: _Resident,
                           B: TiledMatrix, graph, fname: str,
                           theta) -> TiledMatrix:
        """One served spectral apply, X = L·diag(f(spectrum, θ))·Rᴴ·B
        against the resident decomposition: the captured graph's replay
        (θ filled into its static tensor), or the eager apply."""
        if graph is None:
            return _spectral.make_apply_fn(entry.op, fname, entry.opts)(
                res.payload, B, self._spectral_theta(entry, theta))
        self.metrics.inc("graph_replays")
        return self._replay(graph, B, theta)

    def apply(self, handle: Hashable, b, fn: str = "solve",
              theta: float = 0.0, tenant: Optional[str] = None
              ) -> np.ndarray:
        """A served matrix function of a resident spectral operator,
        x = f(A)·b: solve-with-shift ((A − θI)⁻¹b), psd_project, whiten,
        truncate (``spectral/types.py`` has each op's catalog). Array in,
        array out, as ``solve``; ``theta`` is the function's scalar
        parameter, and any value replays the warmed graph. svd: the
        forward function (truncate) takes n-row right-hand sides, the
        pseudoinverse-direction ones (solve, whiten) m-row ones."""
        if tenant is not None:
            raise NotImplementedError(f"Session.apply: {_TENANTS_LATER}")
        with self._lock:
            entry = self._entry(handle)
            if entry.op not in SPECTRAL_OPS:
                raise SlateError(
                    f"Session.apply: operator {handle!r} is {entry.op!r}, "
                    "not a spectral (eig/svd) resident")
            bt = self._rhs(entry, b)
            vector = bt.ndim == 1
            B = from_dense(bt[:, None] if vector else bt, entry.A.nb,
                           device=self.device)
            x = self.solve_matrix(handle, B, spectral_fn=fn,
                                  theta=theta).to_numpy()
            return x[:, 0] if vector else x

    def eigvals(self, handle: Hashable) -> np.ndarray:
        """The resident spectrum: Λ ascending for an eig operator, Σ
        descending for an svd one (factored on a miss: a spectrum read is
        a serve and warms the resident like any other)."""
        with self._lock:
            entry = self._entry(handle)
            if entry.op not in SPECTRAL_OPS:
                raise SlateError(
                    f"Session.eigvals: operator {handle!r} is {entry.op!r}, "
                    "not a spectral (eig/svd) resident")
            return _spectrum(self._factored(handle).payload).cpu().numpy()

    def _dispatch_plain(self, entry: _Operator, res: _Resident,
                        B: TiledMatrix, graph) -> TiledMatrix:
        """The working-precision solve: the captured graph's replay, or
        the eager ``*_solve_using_factor``."""
        if graph is None:
            return _make_solve_fn(entry.op, entry.opts)(res.payload, B)
        self.metrics.inc("graph_replays")
        return self._replay(graph, B)

    def _dispatch_refined(self, handle: Hashable, entry: _Operator,
                          res: _Resident, B: TiledMatrix,
                          graph) -> TiledMatrix:
        """Caller holds the lock. One solve from the LOW-precision
        resident: the refine engine's ``drive`` over the start and step
        functions (their graph replays when ``graph`` is given), with the
        ``refine.converge`` fault hook, or GMRES-IR. Observes
        ``refine_iterations`` and counts ``refine_flops_total`` (each
        iteration's residual gemm and factor apply). A solve that does
        not converge is the counted fallback: the low-precision resident
        is evicted, the operator is refactored at working precision and
        served unrefined from then on (or SlateError when the policy
        disables fallback) — never a wrong answer."""
        policy = entry.refine
        k = int(B.shape[1])
        if entry.anorm is None:
            entry.anorm = float(norm(entry.A, Norm.Inf))
        if policy.strategy == "gmres":
            X, iters, converged = _refine.gmres_solve(
                entry.A, B, res.payload, entry.op, policy, entry.opts)
        else:
            if graph is None:
                start = _refine.make_start_fn(entry.op, entry.opts, policy,
                                              entry.A.dtype)
                step = _refine.make_step_fn(entry.op, entry.opts, policy,
                                            entry.A.dtype)
            else:
                start, step = self._refine_replays(graph)
                self.metrics.inc("graph_replays")
            X, iters, converged = _refine.drive(
                start, step, res.payload, entry.A, B, entry.anorm, policy,
                entry.A.dtype, fault_hook=(
                    None if self.faults is None else
                    (lambda: bool(self._fault("refine.converge")))))
            if graph is not None:
                X = dataclasses.replace(X, n=k)
        self._count_refine(entry, iters, k)
        if converged:
            self.metrics.inc("refine_converged_total")
            return X
        self._refine_fallback(handle, entry, policy)
        res2 = self.factor(handle)
        if res2.info != 0:
            raise SlateError(
                f"Session: operator {handle!r} working-precision fallback "
                f"factorization failed (info={res2.info})")
        return self._dispatch_plain(entry, res2, B, self._graph_for(
            handle, entry, res2, B))

    def _count_refine(self, entry: _Operator, iters: int, k: int):
        """The refinement work of one solve: ``iters`` residual gemms and
        factor applies."""
        self.metrics.observe("refine_iterations", float(iters))
        extra = iters * (_flops.gemm(entry.n, k, entry.n)
                         + _flops.solve_flops(entry.op, entry.m, entry.n, k))
        self.metrics.inc("refine_flops_total", extra)
        self.metrics.inc("flops_total", extra)

    def solve(self, handle: Hashable, b,
              tenant: Optional[str] = None) -> np.ndarray:
        """Array in, array out: ``b`` of shape (m,) or (m, k) (numpy or
        tensor); returns the solution as numpy with the same rank (n
        rows; m = n except for "qr" and "svd" operators). A spectral
        operator serves its catalog's "solve" at θ = 0."""
        if tenant is not None:
            raise NotImplementedError(f"Session.solve: {_TENANTS_LATER}")
        with self._lock:
            entry = self._entry(handle)
            bt = self._rhs(entry, b)
            vector = bt.ndim == 1
            b2 = bt[:, None] if vector else bt
            if entry.op in SMALL_OPS:
                x = self._solve_small(handle, entry, b2)
            else:
                B = from_dense(b2, entry.A.nb, device=self.device)
                x = self.solve_matrix(handle, B).to_numpy()
            return x[:, 0] if vector else x

    def _rhs(self, entry: _Operator, b) -> torch.Tensor:
        bt = (b if isinstance(b, torch.Tensor)
              else torch.as_tensor(np.asarray(b)))
        return bt.to(self.device, entry.A.dtype)

    def _factored(self, handle: Hashable) -> _Resident:
        """The resident factor; raises on factorization failure."""
        res = self.factor(handle)
        if res.info != 0:
            raise SlateError(f"Session: operator {handle!r} factorization "
                             f"failed (info={res.info})")
        return res

    def _count_solve(self, op: str, m: int, n: int, k: int, seconds: float):
        self.metrics.observe("solve_latency", seconds)
        fl = _flops.solve_flops(op, m, n, k)
        self.metrics.inc("solves_total", k)
        self.metrics.inc("dispatches_total")
        self.metrics.inc("flops_total", fl)
        self.metrics.inc("solve_flops_total", fl)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- warmup and the solve graphs -----------------------------------------
    def warmup(self, handle: Hashable, nrhs: int = 1,
               update_k: Optional[int] = None):
        """Factor ``handle`` now, off the request path. Small ops then
        run one zero right-hand-side solve at B = 1 (not counted as a
        solve). Dense ops on a CUDA device capture the solve of an
        (m, nrhs) right-hand side as a CUDA graph (``aot_compiles``,
        ``warmup_compile_latency``): right-hand sides are tile-padded,
        so nrhs = 1 covers every width up to the operator's nb. A
        refined dense operator factors its low-precision resident and
        captures two graphs, the refine engine's ``start`` and ``step``
        (a GMRES-IR one captures nothing). The graphs belong to the
        resident factor; their bytes join the factor's in the budget. A
        CPU session captures nothing. A failed capture raises SlateError
        naming the op and the failing call.

        ``update_k`` prepares ``update`` at ``bucket_k(update_k)``. The
        port's kernels are built once per process, so there is nothing to
        compile: chol and chol_small operators only load the sweep's
        library. A qr operator on a CUDA device also gets append slots
        (u, w, tau, r at the bucket, zero, so inert; their bytes join the
        resident's) and the appended solve's graphs on them, one per
        padded row count of m + 1 … m + bucket rows: an append of up to
        the bucket's rows writes the slots in place and its solves replay
        those graphs. A warmed shape is its columns and type: its rows
        follow the operator's, which updates change (a graph for a new row
        count is captured at its first solve, counted).

        A spectral operator factors its two-stage decomposition, then on
        a CUDA device captures one graph per function of its catalog at
        the warmed width, each on the rows that function takes (θ is a
        static tensor in the graph: every θ replays it)."""
        with self._lock:
            entry = self._entry(handle)
            res = self.factor(handle)
            if (update_k is not None and entry.op in UPDATE_OPS
                    and self.device.type == "cuda"):
                ho.preload("qr_append_build" if entry.op == "qr"
                           else "chol_update_sweep")
            if entry.op in SMALL_OPS:
                if res.info == 0:
                    b0 = torch.zeros((1, entry.n, nrhs),
                                     dtype=entry.A.dtype, device=self.device)
                    if entry.refine is None:
                        _small_solve(entry.op, [res.payload], b0)
                    else:
                        _small_refined(entry.op, entry.A[None],
                                       [res.payload], b0, entry.refine)
                    self._sync()
                return
            if (self.device.type != "cuda" or res.info != 0 or (
                    entry.refine is not None
                    and entry.refine.strategy == "gmres")):
                return
            nb = entry.A.nb
            cols = num_tiles(nrhs, nb) * nb
            if entry.op in SPECTRAL_OPS:
                keys = [(num_tiles(self._rhs_rows(entry, f), nb) * nb, cols,
                         entry.A.dtype, "spectral", f)
                        for f in _spectral.function_catalog(entry.op)]
            else:
                keys = [(num_tiles(entry.m, nb) * nb, cols, entry.A.dtype)
                        + (("append",) if _appended(res.payload) else ())]
            if update_k is not None and entry.op == "qr":
                base_m = res.payload[0].m
                if res.slots is None or (res.slots[0].shape[0]
                                         < _upd.bucket_k(update_k)):
                    self._add_slots(res, _upd.bucket_k(update_k))
                top = base_m + res.slots[0].shape[0]
                keys += [(t * nb, cols, entry.A.dtype, "append") for t in
                         range(num_tiles(base_m + 1, nb),
                               num_tiles(top, nb) + 1)]
            for key in keys:
                self._warm.setdefault(handle, set()).add(key)
                if key not in res.graphs:
                    self._capture(handle, entry, res, key)

    def _add_slots(self, res: _Resident, P: int):
        """Give a cached qr resident zero append slots of P rows (caller
        holds the lock), charged to its bytes. Slots it had before, and
        the appended graphs that read them, are dropped."""
        if res.slots is not None:
            nbytes = _tensor_bytes(res.slots)
            res.nbytes -= nbytes
            self._cached_total -= nbytes
            self._clear_graphs(res, appended_only=True)
        base = res.payload[0]
        npad = base.vr.shape[1]
        u = base.vr.new_zeros((P, npad))
        res.slots = (u, torch.zeros_like(u), base.vr.new_zeros(npad),
                     torch.triu(base.vr[:npad, :npad]))
        nbytes = _tensor_bytes(res.slots)
        res.nbytes += nbytes
        self._cached_total += nbytes

    @staticmethod
    def _graph_payload(res: _Resident, key: Tuple):
        """The payload a graph of ``key`` is captured on: the resident's
        own, or for an appended key the base with the append slots (an
        appended payload is exactly that)."""
        return res.payload if _key_kind(key) != "append" else (
            (res.payload[0],) + res.slots)

    def _clear_graphs(self, res: _Resident, appended_only: bool = False):
        """Drop a cached resident's graphs, or only its appended solves'
        (their bytes leave the budget); a warmed operator captures them
        again on its next matching solve."""
        gone = [k for k in res.graphs
                if not appended_only or _key_kind(k) == "append"]
        nbytes = sum(res.graphs.pop(k).nbytes for k in gone)
        res.nbytes -= nbytes
        self._cached_total -= nbytes

    def _graph_for(self, handle, entry: _Operator, res: _Resident,
                   B: TiledMatrix, fname: Optional[str] = None
                   ) -> Optional[_SolveGraph]:
        """The graph that serves B on this resident factor (for a
        spectral operator: its apply of ``fname``), captured now (counted)
        when warmup asked for B's padded columns and type (and
        appended-ness, or function) and the factor was refactored, or its
        rows changed, since; None: the eager solve."""
        keys = self._warm.get(handle)
        if not keys or B.shape[0] != self._rhs_rows(entry, fname) or (
                B.device != self.device) or (
                entry.refine is not None
                and entry.refine.strategy == "gmres"):
            return None
        b = B.dense_canonical()
        key = (int(b.shape[0]), int(b.shape[1]), b.dtype) + (
            ("spectral", fname) if fname is not None
            else ("append",) if _appended(res.payload) else ())
        if not any(k[1:] == key[1:] for k in keys):
            return None
        graph = res.graphs.get(key)
        return graph if graph is not None else self._capture(
            handle, entry, res, key)

    def _capture(self, handle, entry: _Operator, res: _Resident,
                 key: Tuple):
        """Capture the solve of a static (rows, cols) right-hand side on
        ``res`` (caller holds the lock): the solve, a spectral operator's
        apply of the key's function (θ a static 0-d tensor of the
        operand's real type), or for a refined operator the refine
        engine's ``start`` and ``step`` (each its own graph; ``step``
        takes a static iterate too). The static tensors' logical width is
        the padded one: no column is masked, so one capture serves every
        width up to ``cols``. An appended qr key is captured on the append
        slots with m + (slot rows) logical rows: rows past a request's are
        zero in its padded right-hand side and in the slots, so inert (at
        most ``rows``: the rows past the padded ones are zero too). Counts
        one ``aot_compiles`` per graph; their bytes join the
        resident's."""
        rows, cols, dtype = key[:3]
        kind = _key_kind(key)
        if self.faults is not None:
            self._fault("compile")
        t0 = time.perf_counter()
        payload = self._graph_payload(res, key)
        m = (min(rows, payload[0].m + payload[1].shape[0])
             if kind == "append" else self._rhs_rows(
                 entry, key[4] if kind == "spectral" else None))
        b = torch.zeros((rows, cols), dtype=dtype, device=self.device)
        B = TiledMatrix(b, m, cols, entry.A.nb)
        if kind == "spectral":
            apply = _spectral.make_apply_fn(entry.op, key[4], entry.opts)
            theta = self._spectral_theta(entry, 0.0)
            (graph,), (X,), pool = self._graphs(
                handle, entry, key, [lambda: apply(payload, B, theta)])
            sg = _SolveGraph(graph, b, X, _tensor_bytes((b, theta)) + pool,
                             theta)
        elif entry.refine is None:
            solve = _make_solve_fn(entry.op, entry.opts)
            (graph,), (X,), pool = self._graphs(
                handle, entry, key, [lambda: solve(payload, B)])
            sg = _SolveGraph(graph, b, X, b.numel() * b.element_size() + pool)
        else:
            start = _refine.make_start_fn(entry.op, entry.opts, entry.refine,
                                          dtype)
            step = _refine.make_step_fn(entry.op, entry.opts, entry.refine,
                                        dtype)
            x = torch.zeros_like(b)
            X = TiledMatrix(x, entry.m, cols, entry.A.nb)
            graphs, (X0, (X_new, norms)), pool = self._graphs(
                handle, entry, key,
                [lambda: start(res.payload, B),
                 lambda: step(res.payload, entry.A, B, X)])
            sg = _RefineGraphs(*graphs, b, x, X0, X_new, norms,
                               2 * b.numel() * b.element_size() + pool)
        res.graphs[key] = sg
        res.nbytes += sg.nbytes
        self._cached_total += sg.nbytes  # ``res`` is the cached factor
        self._evict_to_budget(keep=handle)
        self.metrics.inc("aot_compiles", 1 if entry.refine is None else 2)
        self.metrics.observe("warmup_compile_latency",
                             time.perf_counter() - t0)
        return sg

    def _graphs(self, handle, entry: _Operator, key: Tuple, calls):
        """Capture each of ``calls`` (zero-argument functions) as a CUDA
        graph with a private pool → (graphs, their outputs, the pools'
        bytes). One eager run of each on a side stream first loads the
        kernel libraries and creates the cuBLAS handles; the pools are
        measured as the growth of the reserved bytes across the captures.
        A failure raises SlateError naming the op and the failing call."""
        dev = self.device
        try:
            # CUDAGraph and torch.cuda.graph take the current device's
            # capture stream: make it the session's device
            with torch.cuda.device(dev):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for call in calls:
                        call()
                torch.cuda.current_stream(dev).wait_stream(side)
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                before = torch.cuda.memory_reserved(dev)
                graphs, outs = [], []
                for call in calls:
                    graphs.append(torch.cuda.CUDAGraph())
                    with torch.cuda.graph(graphs[-1],
                                          capture_error_mode="thread_local"):
                        outs.append(call())
                torch.cuda.synchronize(dev)
                pool = max(torch.cuda.memory_reserved(dev) - before, 0)
        except Exception as e:
            rows, cols, dtype = key[:3]
            kind = _key_kind(key)
            what = (f"{entry.op} {key[4]} apply" if kind == "spectral" else
                    ("refined " if entry.refine is not None
                     else "appended " if kind == "append" else "")
                    + f"{entry.op} solve")
            raise SlateError(
                f"Session.warmup: capturing the {what} of "
                f"operator {handle!r} at ({rows}, {cols}) {dtype} failed "
                f"in {_failing_call(e)}: {type(e).__name__}: {e}") from e
        return graphs, outs, pool

    @staticmethod
    def _refine_replays(rg: _RefineGraphs):
        """The start and step functions of ``drive`` as replays of the
        captured graphs: each copies its input in, replays, and returns
        copies of the static outputs (the norm pair is read at once)."""
        def start(payload, B):
            rg.b.copy_(B.dense_canonical())
            rg.start.replay()
            return dataclasses.replace(rg.x0, data=rg.x0.data.clone())

        def step(payload, A, B, X):
            rg.x.copy_(X.dense_canonical())
            rg.step.replay()
            return (dataclasses.replace(rg.x_new,
                                        data=rg.x_new.data.clone()),
                    rg.norms)

        return start, step

    @staticmethod
    def _replay(sg: _SolveGraph, B: TiledMatrix,
                theta: float = 0.0) -> TiledMatrix:
        """Copy B (and a spectral apply's θ) in, replay, and return a copy
        of the solution cut to B's columns (the padded columns zero, as
        the eager solve's)."""
        sg.b.copy_(B.dense_canonical())
        if sg.theta is not None:
            sg.theta.fill_(float(theta))
        sg.graph.replay()
        x = sg.x.data.clone()
        k = int(B.shape[1])
        if k < sg.x.n:
            x[:, k:] = 0
        return dataclasses.replace(sg.x, data=x, n=k)

    # -- the small-problem engine -------------------------------------------
    def small_group_key(self, handle: Hashable) -> Optional[Tuple]:
        """(op, n, dtype) for a small-problem operator, and (op, n, dtype,
        policy) for a refined one (refined operators group only with
        operators under the same policy), None otherwise: requests whose
        keys match can be served by one batched solve whichever operator
        each targets. Lock-free, as ``op_meta``."""
        entry = self._ops.get(handle)
        if entry is None or entry.op not in SMALL_OPS:
            return None
        key = (entry.op, entry.n, str(entry.A.dtype).split(".")[1])
        return key if entry.refine is None else key + (entry.refine,)

    def _solve_small(self, handle: Hashable, entry: _Operator,
                     b2: torch.Tensor) -> np.ndarray:
        """Caller holds the lock. The per-request arm: the B = 1 run of
        the batched solve against the resident factor (a refined
        operator's: the B = 1 run of the batched refined solve, and on
        non-convergence the working-precision refactor and solve)."""
        res = self._factored(handle)
        if self.faults is not None:
            self._fault("dispatch")
        t0 = time.perf_counter()
        x = None
        if entry.refine is not None:
            x = self._solve_small_refined(handle, entry, res, b2)
            if x is None:
                res = self.factor(handle)  # the working-precision refactor
                if res.info != 0:
                    raise SlateError(
                        f"Session: operator {handle!r} working-precision "
                        f"fallback factorization failed (info={res.info})")
        if x is None:
            x = _small_solve(entry.op, [res.payload], b2[None])[0]
        self._sync()
        self._count_solve(entry.op, entry.n, entry.n, int(b2.shape[1]),
                          time.perf_counter() - t0)
        return x.cpu().numpy()

    def _solve_small_refined(self, handle: Hashable, entry: _Operator,
                             res: _Resident, b2: torch.Tensor
                             ) -> Optional[torch.Tensor]:
        """Caller holds the lock. One refined B = 1 solve from the
        resident low-precision factor → the solution, or None after
        arming the fallback (``refine_fallbacks_total`` counted, the
        policy dropped, the low-precision resident evicted)."""
        policy = entry.refine
        x, its, conv = _small_refined(entry.op, entry.A[None], [res.payload],
                                      b2[None], policy)
        iters, ok = torch.stack([its[0].to(torch.int64),
                                 conv[0].to(torch.int64)]).tolist()
        self._count_refine(entry, iters, int(b2.shape[1]))
        if ok:
            self.metrics.inc("refine_converged_total")
            return x[0]
        self._refine_fallback(handle, entry, policy)
        return None

    def _refine_fallback(self, handle: Hashable, entry: _Operator,
                         policy: RefinePolicy, failure: Optional[str] = None):
        """Caller holds the lock. A refined solve did not converge, or the
        low-precision factor failed (``failure`` says what, for the
        error): count it, then drop the policy and the low-precision
        resident (or raise when the policy disables fallback)."""
        self.metrics.inc("refine_fallbacks_total")
        if not policy.fallback:
            if failure is None:
                failure = (f"refined solve of {handle!r} did not converge "
                           f"in {policy.max_iters} iterations")
            raise SlateError(
                f"Session: {failure} and the refine policy disables "
                "fallback")
        if entry.refine is not None:
            entry.refine = None
            self._drop(handle)

    def _serve_small_per_request(self, handles: List[Hashable], bs: List
                                 ) -> Tuple[np.ndarray, List[int]]:
        """Caller holds the lock. The grouped pass served request by
        request, where one batched pass is unsafe (the bucket's policies
        differ after a fallback, or a low-precision batched factor failed
        and its items must take the per-request fallback instead of being
        cached): an item whose own solve fails carries its nonzero info
        and zeros, its neighbours are served normally."""
        xs, infos = [], []
        for h, b in zip(handles, bs):
            e = self._ops[h]
            b2 = self._rhs(e, b)
            vector = b2.ndim == 1
            b2 = b2[:, None] if vector else b2
            try:
                x = self._solve_small(h, e, b2)
                infos.append(0)
            except SlateError:
                res = self._cache.get(h)
                infos.append(int(res.info) if res is not None and res.info
                             else 1)
                x = np.zeros(tuple(b2.shape), dtype=str(
                    b2.dtype).split(".")[1])
            xs.append(x[:, 0] if vector else x)
        return np.stack(xs), infos

    def solve_small_batched(self, handles: List[Hashable], bs: List
                            ) -> Tuple[np.ndarray, List[int]]:
        """One batched pass for requests against small operators of one
        (op, n, dtype) bucket (a handle may repeat): the operators not
        resident are
        factored together by one batched factor and each item's factor is
        cached (the B = 1 factor's contract); then every request's factor
        is stacked and served by one batched solve. Returns (xs (B, n, k)
        or (B, n) in request order, per-item info): a singular or non-SPD
        item flags itself, its lane holds garbage, and its neighbours are
        served as without it. ``batched_programs`` counts the batched
        calls (at most 2).

        A bucket of refined operators (one policy) factors its misses in
        the policy's factor type and serves every request by one batched
        refined solve with per-item convergence; an item that does not
        converge takes the fallback alone (working-precision refactor and
        solve of that item). A failed low-precision batched factor, or a
        bucket whose policies differ, is served request by request."""
        if not handles or len(handles) != len(bs):
            raise SlateError("solve_small_batched: handles and bs must be "
                             "equal-length and nonempty")
        with self._lock:
            entries = [self._entry(h) for h in handles]
            for h, e in zip(handles, entries):
                if e.op not in SMALL_OPS:
                    raise SlateError(f"solve_small_batched: {h!r} is op "
                                     f"{e.op!r}, not a small-problem "
                                     "operator")
            if len({self.small_group_key(h) for h in handles}) != 1:
                raise SlateError("solve_small_batched: mixed bucket "
                                 "(op/n/dtype must agree across the batch)")
            pol = entries[0].refine
            if any(e.refine != pol for e in entries[1:]):
                return self._serve_small_per_request(handles, bs)
            if self.faults is not None:
                self._fault("dispatch")
            op, n = entries[0].op, entries[0].n
            t0 = time.perf_counter()
            programs = 0
            # every factor this call serves, taken before any insert can
            # evict one; the first request against a cold operator misses
            # and every other request hits, as B per-request solves count
            unique = list(dict.fromkeys(handles))
            factors = {h: self._cache[h] for h in unique if h in self._cache}
            seen = set(factors)
            misses = [h for h in unique if h not in factors]
            if misses:
                payloads, infos = _small_factor(
                    op, torch.stack([self._ops[h].A for h in misses]), pol)
                if pol is not None and bool((infos != 0).any()):
                    return self._serve_small_per_request(handles, bs)
                fl = _flops.factor_flops(op, n, n)
                for h, payload, info in zip(misses, payloads,
                                            infos.tolist()):
                    self.metrics.inc("factors_total")
                    self.metrics.inc("flops_total", fl)
                    self.metrics.inc("factor_flops_total", fl)
                    factors[h] = _Resident(payload, info,
                                           _payload_nbytes(payload))
                    self._insert(h, factors[h])
                programs += 1
            for h in handles:
                if h in seen:
                    self.metrics.inc("cache_hits")
                    if h in self._cache:
                        self._cache.move_to_end(h)
                else:
                    self.metrics.inc("cache_misses")
                    seen.add(h)
            bstack = torch.stack([self._rhs(e, b)
                                  for e, b in zip(entries, bs)])
            infos = [factors[h].info for h in handles]
            k = int(bstack.shape[2]) if bstack.ndim == 3 else 1
            payloads = [factors[h].payload for h in handles]
            if pol is None:
                x = _small_solve(op, payloads, bstack)
            else:
                x = self._solve_small_grouped_refined(
                    handles, entries, payloads, bstack, pol, infos, k)
            self._sync()
            programs += 1
            self._count_solve(op, n, n, len(handles) * k,
                              time.perf_counter() - t0)
            self.metrics.inc("batched_programs", programs)
            return x.cpu().numpy(), infos

    def _solve_small_grouped_refined(self, handles, entries, payloads,
                                     bstack: torch.Tensor,
                                     pol: RefinePolicy, infos: List[int],
                                     k: int) -> torch.Tensor:
        """Caller holds the lock. The mixed bucket: one batched refined
        solve of the stacked low-precision residents (the working-precision
        operands feed the residual gemms), then each item that did not
        converge alone: its fallback (policy dropped, resident evicted),
        a working-precision refactor, and its lane solved again (``infos``
        takes that factor's info)."""
        op = entries[0].op
        x, its, conv = _small_refined(op, torch.stack([e.A for e in entries]),
                                      payloads, bstack, pol)
        its, conv = its.tolist(), conv.tolist()
        for e, it in zip(entries, its):
            self._count_refine(e, it, k)
        self.metrics.inc("refine_converged_total", sum(conv))
        for i, h in enumerate(handles):
            if conv[i] or infos[i] != 0:
                continue
            self._refine_fallback(h, entries[i], pol)
            res = self.factor(h)
            infos[i] = res.info
            if res.info == 0:
                x[i] = _small_solve(op, [res.payload], bstack[i][None])[0]
        return x

    # -- incremental updates (linalg/update.py) --------------------------------
    def update(self, handle: Hashable, delta=None, *, downdate: bool = False,
               delete=None, tenant: Optional[str] = None) -> dict:
        """Serve an operand mutation against the RESIDENT factor at O(n²k)
        instead of the O(n³) refactor:

        * ``chol``/``chol_small``: ``delta`` is the (n, k) vector block W
          of A' = A + W·Wᴴ (``downdate=True``: A − W·Wᴴ; a downdate that
          fails the positivity check degrades to a counted refactor of the
          committed operand, never a wrong factor);
        * ``qr``: ``delta`` is (p, n) rows to APPEND, or ``delete=`` row
          indices to remove (incremental for appended rows; deleting a base
          row degrades to a counted refactor).

        The mutated operand is staged on the device and committed as the
        Session's own storage on every path (the caller's arrays are never
        written), so the refactor of a degraded path answers from A'. A
        chol factor is updated in its own storage (P6), so its warmed
        solve graphs stay valid; a qr append builds (w, tau, r) against the
        resident R (P7), in the resident's append slots. Ranks and row
        counts pad to pow2 buckets (zero lanes are inert).

        Returns a dict: ``applied`` (the incremental path served it),
        ``refactored`` (a counted refactor ran: reason "abort",
        "downdate_indefinite", "base_delete" or "update_budget"),
        ``deferred`` (no resident to maintain: the mutation committed, the
        next factor is a plain miss), ``info``, ``op``, ``k`` and
        ``k_bucket``."""
        if tenant is not None:
            raise NotImplementedError(f"Session.update: {_TENANTS_LATER}")
        with self._lock:
            entry = self._entry(handle)
            if entry.op not in UPDATE_OPS:
                raise SlateError(
                    f"Session.update: operator kind {entry.op!r} has no "
                    f"incremental form (supported: {UPDATE_OPS}); "
                    "re-register the mutated operand instead")
            if entry.op == "qr":
                return self._update_qr(entry, handle, delta, delete)
            if delete is not None:
                raise SlateError("Session.update: delete= applies to qr "
                                 "operators only")
            return self._update_chol(entry, handle, delta, downdate)

    def _update_vectors(self, entry: _Operator, delta,
                        what: str = "Session.update") -> torch.Tensor:
        """``delta`` as the (n, k) update vectors on the device, in the
        operator's type (a vector is one column)."""
        if delta is None:
            raise SlateError(f"{what}: chol update needs delta (the (n, k) "
                             "update-vector block W)")
        w = delta if isinstance(delta, torch.Tensor) else torch.as_tensor(
            np.asarray(delta))
        if w.ndim == 1:
            w = w[:, None]
        if w.ndim != 2 or w.shape[0] != entry.n:
            raise SlateError(f"{what}: delta must be ({entry.n}, k) update "
                             f"vectors, got shape {tuple(w.shape)}")
        return w.to(self.device, entry.A.dtype)

    def _stage_chol(self, entry: _Operator, w: torch.Tensor, sign: int):
        """A' = A + sign·W·Wᴴ on the device, full precision: a small
        operand as a new tensor; a dense one written into the Session's own
        storage (a full copy of the caller's operand at the first update,
        both triangles) → (A', ‖A‖₁ of the current operand)."""
        with full_precision():
            if entry.op in SMALL_OPS:
                a = entry.A
                return a + sign * (w @ w.mH), _norm1(a)
            A, n = entry.A, entry.n
            anorm1 = float(norm(A, Norm.One))
            data = A.data if entry.owned else A.full_dense()
            if not entry.owned and data.data_ptr() == A.data.data_ptr():
                data = data.clone()
            data[:n, :n].addmm_(w, w.mH, alpha=sign)
            return dataclasses.replace(A, data=data), anorm1

    def _update_chol(self, entry: _Operator, handle: Hashable, delta,
                     downdate: bool) -> dict:
        """Caller holds the lock. Rank-k A' = A ± W·Wᴴ against the resident
        potrf factor, in its own storage: the dense factor by one P6 sweep,
        a small one by the B = 1 run of the batched sweep that
        ``update_small_batched`` uses (bit for bit its lane)."""
        small = entry.op == "chol_small"
        w = self._update_vectors(entry, delta)
        k = int(w.shape[1])
        sign = -1 if downdate else 1
        A2, anorm1 = self._stage_chol(entry, w, sign)
        self.metrics.inc("updates_total")
        # the fault seam fires before any resident byte is touched: the
        # resident stays as it was and the committed operand refactors
        if self.faults is not None and self._fault("update"):
            self.metrics.inc("update_aborts_total")
            self._update_commit(entry, handle, A2)
            return self._update_refactor(entry, handle, "abort")
        res = self._cache.get(handle)
        if res is None:
            # nothing resident: the next factor is a plain miss
            self._update_commit(entry, handle, A2)
            self.metrics.inc("updates_deferred_total")
            return {"applied": False, "refactored": False, "deferred": True,
                    "info": 0, "op": entry.op, "k": k}
        L = res.payload[0]
        kb = _upd.bucket_k(k)
        ldt = L.dtype  # the factor's type (low under a refine policy)
        if small:
            wpad = w.new_zeros((1, entry.n, kb), dtype=ldt)
            wpad[0, :, :k] = w.to(ldt)
            _, infos = _upd.chol_update_batched(L[None], wpad, sign,
                                                inplace=True)
            info = int(infos[0])
        else:
            wpad = w.new_zeros((L.data.shape[-1], kb), dtype=ldt)
            wpad[:entry.n, :k] = w.to(ldt)
            _, info = _upd.chol_update_factor(L, wpad, sign, inplace=True)
            info = int(info)
        self._update_commit(entry, handle, A2)
        if downdate and info > 0:
            # A − W·Wᴴ is not (numerically) positive definite along the
            # sweep: the updated factor is discarded and the refactor of
            # the committed operand answers (or reports its own info)
            self.metrics.inc("update_downdate_failures_total")
            return self._update_refactor(entry, handle, "downdate_indefinite")
        return self._update_finish(entry, handle, res, res.payload, kb, k,
                                   _norm1(w) ** 2, anorm1)

    def _update_qr(self, entry: _Operator, handle: Hashable, rows,
                   delete) -> dict:
        """Caller holds the lock. QR row maintenance: append (``rows``, the
        (p, n) new rows) or delete (``delete``, row indices). The base
        factors are never touched: an append rebuilds (w, tau, r) from the
        whole appended stack against the resident R (P7), in the append
        slots when they hold it; deleting a BASE row has no incremental
        form and degrades to a counted refactor of the pruned operand.
        The append factors are always written into the resident's append
        slots, made (or grown to the rows' bucket, which drops the appended
        graphs) at the first append that needs them."""
        if (rows is None) == (delete is None):
            raise SlateError("Session.update(qr): exactly one of delta (rows "
                             "to append) or delete= (row indices) per call")
        m, n, nb = entry.m, entry.n, entry.A.nb
        a = entry.A.dense_canonical()[:m, :n]
        res = self._cache.get(handle)
        base_m = res.payload[0].m if res is not None else None
        if rows is not None:
            u = rows if isinstance(rows, torch.Tensor) else torch.as_tensor(
                np.asarray(rows))
            if u.ndim == 1:
                u = u[None, :]
            if u.ndim != 2 or u.shape[1] != n:
                raise SlateError(
                    f"Session.update(qr): delta must be (p, {n}) rows to "
                    f"append, got shape {tuple(u.shape)}")
            u = u.to(self.device, entry.A.dtype)
            k_live = int(u.shape[0])
            m_new = m + k_live
            wn1_sq = _norm1(u) ** 2
            base_delete = False
            kept = None
        else:
            idx = np.unique(np.atleast_1d(np.asarray(delete, dtype=np.int64)))
            if idx.size == 0:
                raise SlateError("Session.update(qr): delete= is empty")
            if int(idx[0]) < 0 or int(idx[-1]) >= m:
                raise SlateError(f"Session.update(qr): delete= indices out "
                                 f"of range for {m} rows")
            k_live = int(idx.size)
            m_new = m - k_live
            if m_new < n:
                raise SlateError(
                    "Session.update(qr): delete would leave an "
                    f"underdetermined operator ({m_new} rows < {n} cols)")
            gone = torch.as_tensor(idx, device=self.device)
            wn1_sq = _norm1(a[gone]) ** 2
            kept = torch.ones(m, dtype=torch.bool, device=self.device)
            kept[gone] = False
            base_delete = res is None or bool((idx < base_m).any())
        data = a.new_zeros((num_tiles(m_new, nb) * nb,
                            entry.A.data.shape[1]))
        if kept is None:
            data[:m, :n] = a
            data[m:m_new, :n] = u
        else:
            data[:m_new, :n] = a[kept]
        A2 = TiledMatrix(data, m_new, n, nb)
        anorm1 = float(norm(entry.A, Norm.One))
        self.metrics.inc("updates_total")
        if self.faults is not None and self._fault("update"):
            self.metrics.inc("update_aborts_total")
            self._update_commit(entry, handle, A2, m=m_new)
            return self._update_refactor(entry, handle, "abort")
        if res is None:
            self._update_commit(entry, handle, A2, m=m_new)
            self.metrics.inc("updates_deferred_total")
            return {"applied": False, "refactored": False, "deferred": True,
                    "info": 0, "op": "qr", "k": k_live}
        if base_delete:
            self._update_commit(entry, handle, A2, m=m_new)
            return self._update_refactor(entry, handle, "base_delete")
        base = res.payload[0]
        # the rows already appended, from the resident payload itself
        prev = (res.payload[1][: m - base.m, :n] if _appended(res.payload)
                else a.new_zeros((0, n)))
        u_all = torch.cat([prev, u]) if kept is None else prev[kept[base.m:]]
        p_all = int(u_all.shape[0])
        self._update_commit(entry, handle, A2, m=m_new)
        if p_all == 0:
            # every appended row deleted: the base factors alone factor
            # the pruned operand, no device work
            return self._update_finish(entry, handle, res, (base,), 0,
                                       k_live, wn1_sq, anorm1)
        P = _upd.bucket_k(p_all)
        if res.slots is None or res.slots[0].shape[0] < p_all:
            self._add_slots(res, P)
        upad = res.slots[0]
        upad.zero_()
        upad[:p_all, :n] = u_all
        _upd.qr_append_factor(base, upad, res.slots[1:])
        return self._update_finish(entry, handle, res, (base,) + res.slots,
                                   P, k_live, wn1_sq, anorm1)

    def update_small_batched(self, handles, deltas, downdate: bool = False,
                             tenant: Optional[str] = None) -> list:
        """Grouped incremental maintenance of many chol_small operators
        (Kalman-filter/RLS fleets): one P6 launch up/downdates B residents
        at once, each item bit for bit its B = 1 ``update``, with per-item
        info isolation (a failed downdate degrades THAT item to a counted
        refactor; the rest commit). Cold handles are factored first (plain
        misses). Ranks may differ per item: zero pad columns are inert, so
        the group runs at the largest rank's bucket. One (op, n, dtype
        [, policy]) group per call. Returns one result dict per handle."""
        if tenant is not None:
            raise NotImplementedError(
                f"Session.update_small_batched: {_TENANTS_LATER}")
        handles, deltas = list(handles), list(deltas)
        if len(handles) != len(deltas):
            raise SlateError("Session.update_small_batched: handles and "
                             "deltas length mismatch")
        if not handles:
            return []
        sign = -1 if downdate else 1
        with self._lock:
            entries = [self._entry(h) for h in handles]
            for h, e in zip(handles, entries):
                if e.op != "chol_small":
                    raise SlateError(
                        "Session.update_small_batched: chol_small operators "
                        f"only (got {e.op!r} for {h!r})")
            keys = {self.small_group_key(h) for h in handles}
            if len(keys) != 1:
                raise SlateError(
                    "Session.update_small_batched: one (op, n, dtype"
                    "[, refine]) group per call, got "
                    f"{sorted(map(str, keys))}")
            n = entries[0].n
            ws = [self._update_vectors(e, d, "Session.update_small_batched")
                  for e, d in zip(entries, deltas)]
            kb = _upd.bucket_k(max(int(w.shape[1]) for w in ws))
            residents = [self.factor(h) for h in handles]
            for h, r in zip(handles, residents):
                if r.info != 0:
                    raise SlateError(f"Session: operator {h!r} factorization "
                                     f"failed (info={r.info})")
            bsz = len(handles)
            # every A' = A + sign·W·Wᴴ and the norms at once, one host read
            wide = ws[0].new_zeros((bsz, n, kb))
            for i, w in enumerate(ws):
                wide[i, :, :w.shape[1]] = w
            with full_precision():
                a = torch.stack([e.A for e in entries])
                a2s = a + sign * (wide @ wide.mH)
            an1s, wn1s = torch.stack([a.abs().sum(1).amax(1),
                                      wide.abs().sum(1).amax(1)]).tolist()
            self.metrics.inc("updates_total", bsz)
            if self.faults is not None and self._fault("update"):
                self.metrics.inc("update_aborts_total", bsz)
                outs = []
                for i, (h, e) in enumerate(zip(handles, entries)):
                    self._update_commit(e, h, a2s[i].clone())
                    outs.append(self._update_refactor(e, h, "abort"))
                return outs
            ldt = residents[0].payload[0].dtype
            wpad = wide.to(ldt)
            ls = torch.stack([r.payload[0] for r in residents])
            _, infos = _upd.chol_update_batched(ls, wpad, sign, inplace=True)
            infos = infos.tolist()
            outs = []
            for i, (h, e, res) in enumerate(zip(handles, entries, residents)):
                # a copy of the item, not a view of the stack
                self._update_commit(e, h, a2s[i].clone())
                if downdate and infos[i] > 0:
                    self.metrics.inc("update_downdate_failures_total")
                    outs.append(self._update_refactor(
                        e, h, "downdate_indefinite"))
                    continue
                res.payload[0].copy_(ls[i])
                outs.append(self._update_finish(
                    e, h, res, res.payload, kb, int(ws[i].shape[1]),
                    wn1s[i] ** 2, an1s[i]))
            return outs

    def _update_commit(self, entry: _Operator, handle: Hashable, A2,
                       m: Optional[int] = None):
        """Caller holds the lock: the mutated operand becomes the operator's
        truth (the Session's own storage) and the cached ‖A‖∞ is stale. A
        refined dense operator whose operand moved to new storage drops
        its resident's graphs, which read the old operand (captured again,
        counted, at the next matching solve)."""
        moved = (entry.op not in SMALL_OPS
                 and A2.data.data_ptr() != entry.A.data.data_ptr())
        entry.A = A2
        entry.owned = True
        if m is not None:
            entry.m = m
        entry.anorm = None
        res = self._cache.get(handle)
        if moved and entry.refine is not None and res is not None:
            self._clear_graphs(res)

    def _update_refactor(self, entry: _Operator, handle: Hashable,
                         reason: str, applied: bool = False) -> dict:
        """Caller holds the lock, mutated operand committed. The counted
        degrade path of every update failure: evict the stale or discarded
        resident (and its graphs) and refactor A', which either serves
        correctly or reports its own info."""
        self.metrics.inc("update_refactors_total")
        self._drop(handle)
        res = self.factor(handle)
        return {"applied": applied, "refactored": True, "reason": reason,
                "info": int(res.info), "op": entry.op}

    def _update_finish(self, entry: _Operator, handle: Hashable,
                       res: _Resident, payload2: Tuple, kb: int, k: int,
                       wnorm1_sq: float, anorm1: float) -> dict:
        """Caller holds the lock, operand committed. Install the maintained
        payload on the resident (cached again if a budget eviction of this
        call dropped it), credit the bucket's update flops, then accrue
        the update's weight: if the budget comes due, the resident is
        refactored now (counted), off the next request's path."""
        res.payload = payload2
        res.info = 0
        if self._cache.get(handle) is res:
            self._cache.move_to_end(handle)
        else:
            self._cache[handle] = res
            self._cached_total += res.nbytes
        if kb:
            fl = _flops.update_flops(entry.op, entry.n, kb)
            self.metrics.inc("flops_total", fl)
            self.metrics.inc("update_flops_total", fl)
        self._evict_to_budget(keep=handle)
        refactored = self._update_health(entry, handle, k, wnorm1_sq, anorm1)
        out = {"applied": True, "refactored": refactored, "info": 0,
               "op": entry.op, "k": k, "k_bucket": kb}
        if refactored:
            out["reason"] = "update_budget"
        return out

    def _update_health(self, entry: _Operator, handle: Hashable, k: int,
                       wnorm1_sq: float, anorm1: float) -> bool:
        """Caller holds the lock. Accrue the update's growth-weighted error
        mass on the operator (the numerics monitor, which would keep its
        own copy, is ROADMAP Queue 1 item 10) and consult the refactor-due
        predicate of ``obs/numerics.py``. True when the budget came due and
        a counted refactor replaced the resident."""
        entry.updates += 1
        entry.update_weight += _num.update_weight(k, wnorm1_sq, anorm1)
        if not _num.update_refactor_due(entry.update_weight,
                                        _num.DEFAULT_UPDATE_BUDGET):
            return False
        self.metrics.inc("update_budget_refactors_total")
        self._update_refactor(entry, handle, "budget", applied=True)
        return True

    # -- lifetime ------------------------------------------------------------
    def close(self):
        """Release the resident factors and their graphs (``clear_cache``)
        so their device memory returns to the allocator. The session
        stays usable: a later solve refactors. Idempotent."""
        self.clear_cache()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# -- the process-wide session ------------------------------------------------

_DEFAULT: Optional[Session] = None
_DEFAULT_LOCK = threading.Lock()
# its resident budget, in bytes, overridable through the environment (the
# reference's variable and default)
_DEFAULT_BUDGET_ENV = "SLATE_TPU_SERVE_HBM_BUDGET"
_DEFAULT_BUDGET = 4 << 30


def default_session(device="cuda") -> Session:
    """The process-wide Session, created on the first call on ``device``
    with the budget above. A later call for another device raises."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            budget = int(os.environ.get(_DEFAULT_BUDGET_ENV,
                                        _DEFAULT_BUDGET))
            _DEFAULT = Session(hbm_budget=budget, device=device)
        elif _DEFAULT.device != resolve_device(device):
            raise SlateError(f"default_session: the process-wide session "
                             f"is on {_DEFAULT.device}, not {device}")
        return _DEFAULT
