"""Resident-factor solve service (counterpart of the dense single-device
core of ``slate_tpu/runtime/session.py``).

A Session registers operators, factors each once on first use, keeps
the factor resident under a byte budget (LRU eviction, refactor on
miss) and serves solves from it. The ported slices cover dense
``TiledMatrix`` operators under ``op`` "chol", "lu" and "qr" (tall
least-squares operators: ``solve`` takes m-row right-hand sides and
returns n-row solutions). The reference's Batcher,
Executor, refinement, meshes, band and small-problem operators,
tracing and fault injection are later slices: registering such an
operator raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from .. import api
from ..core.exceptions import SlateError
from ..linalg.qr import QRFactors
from ..core.tiled_matrix import TiledMatrix, from_dense, resolve_device
from ..core.types import MatrixKind, Options, DEFAULT_OPTIONS
from ..obs import flops as _flops
from .metrics import Metrics

OPS = ("lu", "chol", "qr")
# op kinds of the reference Session that later slices port
LATER_OPS = ("band_lu", "band_chol", "lu_small", "chol_small", "eig", "svd")


@dataclasses.dataclass
class _Operator:
    A: TiledMatrix
    op: str
    opts: Options
    m: int
    n: int


@dataclasses.dataclass
class _Resident:
    payload: Tuple  # the *_solve_using_factor arguments
    info: int
    nbytes: int


def _payload_nbytes(payload) -> int:
    total = 0
    for p in payload:
        if isinstance(p, QRFactors):
            tensors = (p.vr, p.t)
        else:
            tensors = (p.data if isinstance(p, TiledMatrix) else p,)
        total += sum(t.numel() * t.element_size() for t in tensors)
    return total


def _make_factor_fn(op: str, opts: Options):
    """The dense factor verb as an A -> (payload, info) function."""
    if op == "lu":
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
    """The *_solve_using_factor verb as a (payload, B) -> X function."""
    if op == "lu":
        def solve(payload, B):
            LU, perm = payload
            return api.lu_solve_using_factor(LU, perm, B, opts)
    elif op == "chol":
        def solve(payload, B):
            return api.chol_solve_using_factor(payload[0], B, opts)
    else:
        def solve(payload, B):
            return api.least_squares_solve_using_factor(payload[0], B,
                                                        opts)
    return solve


class Session:
    """Resident-factorization solve service with a byte-budget LRU cache.

    ``hbm_budget`` bounds the device bytes of CACHED FACTORS (the
    registered operators are the caller's and are not charged); ``None``
    is unbounded. A factor larger than the whole budget is kept (serving
    needs it) and counted in ``budget_overflows``. ``device`` defaults to
    "cuda" and raises without a card unless "cpu" is asked for.
    Public methods are thread-safe (one lock)."""

    def __init__(self, hbm_budget: Optional[int] = None,
                 opts: Options = DEFAULT_OPTIONS,
                 metrics: Optional[Metrics] = None, device="cuda"):
        self.hbm_budget = hbm_budget
        self.opts = opts
        self.device = resolve_device(device)
        self.metrics = metrics or Metrics()
        self._lock = threading.RLock()
        self._ops: Dict[Hashable, _Operator] = {}
        self._cache: "OrderedDict[Hashable, _Resident]" = OrderedDict()
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

    def register(self, A: TiledMatrix, op: str = "auto",
                 handle: Optional[Hashable] = None,
                 opts: Optional[Options] = None) -> Hashable:
        """Register an operator; returns its handle (an int unless
        given). ``op`` is "chol", "lu", "qr" or "auto" (Hermitian/
        Symmetric → chol, square general → lu, non-square → qr). A "qr"
        operator must be tall (m ≥ n); chol and lu need a square one."""
        if op == "auto":
            op = self._infer_op(A)
        if op in LATER_OPS:
            raise NotImplementedError(
                f"Session.register: op {op!r} is not ported yet (ROADMAP "
                "Queue 1 items 4, 8 and 9)")
        if op not in OPS:
            raise SlateError(f"Session.register: unknown op {op!r}")
        if not isinstance(A, TiledMatrix):
            raise SlateError(f"Session.register: op {op!r} requires a "
                             f"TiledMatrix operand, got {type(A).__name__}")
        if A.device != self.device:
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
        elif m != n:
            raise SlateError(f"Session.register: {op} needs a square "
                             f"operand, got {(m, n)}")
        with self._lock:
            if handle is None:
                self._seq += 1
                while self._seq in self._ops:
                    self._seq += 1
                handle = self._seq
            if handle in self._ops:
                raise SlateError(f"Session.register: handle {handle!r} "
                                 "already registered (unregister first)")
            self._ops[handle] = _Operator(A, op, opts or self.opts, m, n)
        return handle

    def unregister(self, handle: Hashable):
        """Drop an operator and its cached factor (no error if absent)."""
        with self._lock:
            self._ops.pop(handle, None)
            self._drop(handle)

    def __contains__(self, handle: Hashable) -> bool:
        with self._lock:
            return handle in self._ops

    def handles(self):
        with self._lock:
            return list(self._ops)

    # -- cache -------------------------------------------------------------
    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return sum(r.nbytes for r in self._cache.values())

    def cached_handles(self):
        """LRU → MRU order."""
        with self._lock:
            return list(self._cache)

    def _drop(self, handle) -> bool:
        res = self._cache.pop(handle, None)
        if res is not None:
            self.metrics.inc("evictions")
            self.metrics.inc("evicted_bytes", res.nbytes)
        self.metrics.set_gauge("resident_bytes", self.cached_bytes)
        return res is not None

    def evict(self, handle: Hashable) -> bool:
        """Drop a cached factor (the operator stays registered)."""
        with self._lock:
            return self._drop(handle)

    def _evict_to_budget(self, keep: Hashable):
        budget = self.hbm_budget
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

    def factor(self, handle: Hashable) -> _Resident:
        """Resident factor for ``handle``: cache hit, or factor on miss
        (LRU touch either way, evict to budget on insert)."""
        with self._lock:
            entry = self._ops.get(handle)
            if entry is None:
                raise SlateError(f"Session: unknown handle {handle!r}")
            res = self._cache.get(handle)
            if res is not None:
                self._cache.move_to_end(handle)
                self.metrics.inc("cache_hits")
                return res
            self.metrics.inc("cache_misses")
            t0 = time.perf_counter()
            payload, info = _make_factor_fn(entry.op, entry.opts)(entry.A)
            res = _Resident(payload, int(info), _payload_nbytes(payload))
            if self.device.type == "cuda":  # the QR factor has no info sync
                torch.cuda.synchronize(self.device)
            self.metrics.observe("factor_latency", time.perf_counter() - t0)
            self.metrics.inc("factors_total")
            fl = _flops.factor_flops(entry.op, entry.m, entry.n)
            self.metrics.inc("flops_total", fl)
            self.metrics.inc("factor_flops_total", fl)
            self._cache[handle] = res
            self._evict_to_budget(keep=handle)
            return res

    def factor_info(self, handle: Hashable) -> int:
        with self._lock:
            res = self._cache.get(handle)
            return res.info if res is not None else self.factor(handle).info

    # -- solves ------------------------------------------------------------
    def solve_matrix(self, handle: Hashable, B: TiledMatrix) -> TiledMatrix:
        """Solve with the resident factor; B is a TiledMatrix on the
        session's device. Raises on factorization failure (info > 0).
        ``solve_latency`` ends when the device has finished."""
        with self._lock:
            entry = self._ops.get(handle)
            if entry is None:
                raise SlateError(f"Session: unknown handle {handle!r}")
            res = self.factor(handle)
            if res.info != 0:
                raise SlateError(f"Session: operator {handle!r} "
                                 f"factorization failed (info={res.info})")
            t0 = time.perf_counter()
            X = _make_solve_fn(entry.op, entry.opts)(res.payload, B)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.metrics.observe("solve_latency", time.perf_counter() - t0)
            k = int(B.shape[1])
            fl = _flops.solve_flops(entry.op, entry.m, entry.n, k)
            self.metrics.inc("solves_total", k)
            self.metrics.inc("dispatches_total")
            self.metrics.inc("flops_total", fl)
            self.metrics.inc("solve_flops_total", fl)
            return X

    def solve(self, handle: Hashable, b) -> np.ndarray:
        """Array in, array out: ``b`` of shape (m,) or (m, k) (numpy or
        tensor); returns the solution as numpy with the same rank (n
        rows; m = n except for "qr" operators)."""
        with self._lock:
            entry = self._ops.get(handle)
            if entry is None:
                raise SlateError(f"Session: unknown handle {handle!r}")
            bt = (b if isinstance(b, torch.Tensor)
                  else torch.as_tensor(np.asarray(b)))
            vector = bt.ndim == 1
            b2 = bt[:, None] if vector else bt
            B = from_dense(b2.to(self.device, entry.A.dtype), entry.A.nb,
                           device=self.device)
            x = self.solve_matrix(handle, B).to_numpy()
            return x[:, 0] if vector else x
