"""Declarative refinement policy: which factor precision serves which op
(the port's own copy of ``slate_tpu/refine/policy.py:1-219``).

:class:`RefinePolicy` is a frozen (hashable) value object; its dtypes are
canonical STRING names ("bfloat16", "float32") so a policy is built
without a torch dtype and two operators refined under different policies
never share a resident or a graph. :class:`PolicyTable` holds (predicate
→ policy) rules with first-match-wins resolution; :func:`default_factor_dtype`
is the one-tier-down ladder (f64→f32, f32→bf16, c128→c64) the table falls
back to, None where no lower factor precision exists (c64: there is no
complex bfloat16). :func:`torch_dtype` maps a name to its torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

# the one-tier-down factor-precision ladder. c64 has no entry: there is
# no lower complex dtype to factor in (acceptance: "c64 where the
# factor path supports it" — the supported complex pair is c128→c64).
_DTYPE_LADDER = {
    "float64": "float32",
    "float32": "bfloat16",
    "complex128": "complex64",
}

# strategies the engine implements (refine/engine.py): classic
# iterative refinement and GMRES-IR (FGMRES preconditioned by the
# low-precision factor, linalg/gmres.py's cycle)
STRATEGIES = ("ir", "gmres")


def canonical_dtype_name(dtype) -> str:
    """Any dtype spec -> its canonical string name ("bfloat16",
    "float32", ...): a torch dtype, a numpy dtype or type, or a name.
    bfloat16 is special-cased (numpy has none)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[1]
    if isinstance(dtype, str) and dtype in ("bfloat16", "bf16"):
        return "bfloat16"
    if getattr(dtype, "__name__", None) == "bfloat16" or \
            str(dtype) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


def torch_dtype(name: str) -> torch.dtype:
    """Canonical name -> torch dtype."""
    dt = getattr(torch, canonical_dtype_name(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"torch_dtype: no torch dtype named {name!r}")
    return dt


def default_factor_dtype(working) -> Optional[str]:
    """One tier down from ``working``, or None when no lower factor
    precision exists (then mixed-precision serving is not possible and
    the caller must say so explicitly rather than silently serve
    full-precision)."""
    return _DTYPE_LADDER.get(canonical_dtype_name(working))


def check_cast_kinds(working, factor, what: str):
    """Reject a complex↔real factor/working pairing: a complex→real
    cast discards the imaginary part, so a c64 operand factored "in
    bfloat16" would give a real-part-only factor the refinement can
    never converge against. Raised as ValueError — callers wrap in their
    own error type."""
    w = canonical_dtype_name(working)
    f = canonical_dtype_name(factor)
    if w.startswith("complex") != f.startswith("complex"):
        raise ValueError(
            f"{what}: factor dtype {f!r} and working dtype {w!r} must "
            "both be real or both complex (a complex->real cast "
            "silently discards the imaginary part)")


@dataclasses.dataclass(frozen=True)
class RefinePolicy:
    """How one operator's solves are refined.

    factor_dtype    precision the resident factor is computed/stored in
    residual_dtype  precision of the residual gemm (None = working —
                    the reference's convention; a WIDER dtype buys
                    extra-precise IR where the platform has one)
    max_iters       refinement-iteration budget before fallback
    strategy        "ir" (classic iterative refinement) or "gmres"
                    (FGMRES-IR — converges where plain IR stagnates,
                    Carson & Higham / src/gesv_mixed_gmres.cc)
    fallback        non-convergence falls back to a working-precision
                    refactor through the normal Session path (True,
                    the reference's Option::UseFallbackSolver) or
                    raises (False) — never a silently wrong answer
    tol             convergence tolerance; None = eps(working)·sqrt(n)
                    (the reference default, gesv_mixed.cc:34-43)
    """

    factor_dtype: str = "bfloat16"
    residual_dtype: Optional[str] = None
    max_iters: int = 30
    strategy: str = "ir"
    fallback: bool = True
    tol: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "factor_dtype",
                           canonical_dtype_name(self.factor_dtype))
        if self.residual_dtype is not None:
            object.__setattr__(self, "residual_dtype",
                               canonical_dtype_name(self.residual_dtype))
        if self.strategy not in STRATEGIES:
            raise ValueError(f"RefinePolicy: unknown strategy "
                             f"{self.strategy!r} (use one of {STRATEGIES})")
        if self.max_iters < 1:
            raise ValueError("RefinePolicy: max_iters must be >= 1")

    def validate_for(self, working) -> "RefinePolicy":
        """Check this policy against a working dtype (the factor dtype
        must be strictly NARROWER — factoring f32 "in f32" is not mixed
        precision, and the trivial path would silently skip
        refinement). Returns self for chaining."""
        wname = canonical_dtype_name(working)
        if self.factor_dtype == wname:
            raise ValueError(
                f"RefinePolicy: factor_dtype {self.factor_dtype!r} equals "
                f"the working dtype — nothing to refine")
        w_complex = wname.startswith("complex")
        f_complex = self.factor_dtype.startswith("complex")
        if w_complex != f_complex:
            raise ValueError(
                f"RefinePolicy: factor dtype {self.factor_dtype!r} and "
                f"working dtype {wname!r} must both be real or both "
                "complex")
        return self


@dataclasses.dataclass(frozen=True)
class _Rule:
    policy: Optional[RefinePolicy]   # None = explicitly NOT refined
    op: Optional[str] = None         # Session op kind, None = any
    dtype: Optional[str] = None      # working dtype name, None = any
    n_min: int = 0
    n_max: Optional[int] = None      # inclusive upper bound, None = inf

    def matches(self, op: str, n: int, dtype: str) -> bool:
        if self.op is not None and self.op != op:
            return False
        if self.dtype is not None and self.dtype != dtype:
            return False
        if n < self.n_min:
            return False
        if self.n_max is not None and n > self.n_max:
            return False
        return True


class PolicyTable:
    """First-match-wins (op, n-bucket, dtype) -> RefinePolicy rules.

    ``add(policy, op=..., dtype=..., n_min=..., n_max=...)`` appends a
    rule; ``add(None, ...)`` carves out an explicit "serve this class
    full-precision" hole in front of broader rules. ``resolve`` falls
    back to a ladder-default policy (:func:`default_factor_dtype`)
    when no rule matches and the ladder has a lower precision —
    ``resolve(..., default=False)`` disables the fallback (then None
    means "no rule says to refine this")."""

    def __init__(self, rules: Optional[List[_Rule]] = None):
        self._rules: List[_Rule] = list(rules or [])

    def add(self, policy: Optional[RefinePolicy], op: Optional[str] = None,
            dtype=None, n_min: int = 0, n_max: Optional[int] = None
            ) -> "PolicyTable":
        self._rules.append(_Rule(
            policy, op=op,
            dtype=None if dtype is None else canonical_dtype_name(dtype),
            n_min=n_min, n_max=n_max))
        return self

    def lookup(self, op: str, n: int, dtype
               ) -> Tuple[bool, Optional[RefinePolicy]]:
        """(matched, policy) of the first matching rule — ``(True,
        None)`` is an explicit full-precision hole, ``(False, None)``
        means no rule covers this class (the caller decides between
        the ladder default and an error; Session.register uses the
        distinction so a carve-out hole registers unrefined instead of
        raising a misleading no-lower-precision error)."""
        dname = canonical_dtype_name(dtype)
        for rule in self._rules:
            if rule.matches(op, int(n), dname):
                return True, rule.policy
        return False, None

    def resolve(self, op: str, n: int, dtype,
                default: bool = True) -> Optional[RefinePolicy]:
        matched, policy = self.lookup(op, n, dtype)
        if matched:
            return policy
        if not default:
            return None
        lo = default_factor_dtype(canonical_dtype_name(dtype))
        if lo is None:
            return None
        return RefinePolicy(factor_dtype=lo)

    def rules(self) -> List[Tuple]:
        """Introspection (tests / dashboards): the rule list as plain
        tuples, in match order."""
        return [(r.op, r.dtype, r.n_min, r.n_max, r.policy)
                for r in self._rules]
