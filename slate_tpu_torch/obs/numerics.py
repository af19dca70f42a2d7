"""The incremental-update budget (the port's own trimmed copy of
``slate_tpu/obs/numerics.py:159-179``): the one predicate that decides when
a resident factor maintained by ``Session.update`` has absorbed enough
updates to be refactored. The numerics monitor is a later slice (ROADMAP
Queue 1 item 10)."""

from __future__ import annotations

# Default accumulated-update weight a resident factor absorbs before the
# Session schedules a counted refactor. The weight is Σ k·max(1, ‖W‖₁²/
# ‖A‖₁) over the updates applied since the last fresh factor: each rank-1
# sweep adds O(u·‖W‖²/‖A‖) relative backward error, so small updates
# charge exactly their rank and large ones proportionally more.
DEFAULT_UPDATE_BUDGET = 64.0


def update_weight(k: int, wnorm1_sq: float, anorm1: float) -> float:
    """Accumulation charge of one rank-k update: k·max(1, ‖W‖₁²/‖A‖₁)."""
    rel = wnorm1_sq / anorm1 if anorm1 > 0.0 else 0.0
    return float(k) * max(1.0, rel)


def update_refactor_due(weight: float, budget: float) -> bool:
    """Has the accumulated update weight exceeded the budget? The weight
    is at least the number of updates by construction, so the budget
    bounds both (the reference also takes the count, and ignores it)."""
    return float(weight) > float(budget)
