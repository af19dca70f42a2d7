"""slate_tpu_torch.refine — mixed-precision iterative refinement
(counterpart of ``slate_tpu/refine``): :mod:`.policy` (RefinePolicy,
PolicyTable, the dtype ladder) and :mod:`.engine` (the factor, start and
step functions the Session runs and captures, the host convergence loop,
GMRES-IR, and the per-item-masked batched loop)."""

from .engine import (REFINE_OPS, batched_cte, batched_ir_loop,
                     convergence_threshold, drive, gmres_solve,
                     make_factor_fn, make_start_fn, make_step_fn,
                     solve_refined)
from .policy import (PolicyTable, RefinePolicy, canonical_dtype_name,
                     check_cast_kinds, default_factor_dtype, torch_dtype)

__all__ = [
    "PolicyTable", "RefinePolicy", "REFINE_OPS", "batched_cte",
    "batched_ir_loop", "canonical_dtype_name", "check_cast_kinds",
    "convergence_threshold", "default_factor_dtype", "drive",
    "gmres_solve", "make_factor_fn", "make_start_fn", "make_step_fn",
    "solve_refined", "torch_dtype",
]
