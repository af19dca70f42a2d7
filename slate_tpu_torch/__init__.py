"""slate_tpu_torch — the PyTorch/CUDA port of slate_tpu for NVIDIA Hopper.

It imports torch and numpy, never jax and nothing of ``slate_tpu``. Entry
points take an explicit ``device`` that defaults to "cuda" and raise
without a card unless "cpu" is asked for. The hand-written kernels live
in ``csrc/`` and are built with nvcc on first use (``ops/_build.py``).
"""

from .api import (chol_factor, chol_inverse_using_factor, chol_solve,
                  chol_solve_using_factor, gels_batched, geqrf_batched,
                  gesv_batched, gesv_mixed, gesv_mixed_batched,
                  gesv_mixed_gmres, least_squares_solve,
                  least_squares_solve_using_factor, lu_factor,
                  lu_inverse_using_factor, lu_solve, lu_solve_using_factor,
                  multiply, posv_batched, posv_mixed, posv_mixed_batched,
                  posv_mixed_gmres, qr_factor, rank_2k_update,
                  rank_k_update, triangular_multiply, triangular_solve)
from .core.exceptions import SlateError
from .core.tiled_matrix import (TiledMatrix, from_dense, hermitian, pad_mask,
                                resolve_device, symmetric, triangular, zeros)
from .core.types import (Diag, MatrixKind, MethodGels, MethodGemm,
                         MethodEig, MethodHemm, MethodLU, MethodSVD,
                         MethodTrsm, Norm,
                         NormScope,
                         Op, Options, Side, Uplo)
from .linalg.blas3 import (gemm, hemm, her2k, herk, symm, syr2k, syrk, trmm,
                           trsm)
from .linalg.cholesky import posv, potrf, potri, potrs, trtri, trtrm
from .linalg.eig import (hb2td, he2hb, he2td, heev, hegst, hegv, steqr,
                          sterf, unmtr_hb2td, unmtr_he2hb, unmtr_he2td)
from .linalg.elementwise import (add, copy, redistribute, scale,
                                 scale_row_col, set_lambda, set_matrix)
from .linalg.lu import (gerbt, gesv, gesv_nopiv, gesv_rbt, getrf,
                        getrf_nopiv, getrf_tntpiv, getri, getri_oop, getrs)
from .linalg.norms import col_norms, norm
from .linalg.svd import bdsqr, ge2bd, ge2tb, svd
from .linalg.qr import (QRFactors, cholqr, gelqf, gels, gels_using_factor,
                        geqrf, qr_multiply_explicit, tsqr, unmlq, unmqr)
from .runtime import (DEGRADATION_LADDER, Batcher, DeadlineExceeded,
                      Executor, FaultInjector, FaultPlan, FaultSpec,
                      Histogram, Metrics, QuotaExceeded, RequestShed,
                      ShedPolicy, TransientDispatchError, default_plan,
                      default_session)
from .refine import PolicyTable, RefinePolicy
from .runtime.session import Session
from . import spectral

__all__ = [
    "chol_factor", "chol_inverse_using_factor", "chol_solve",
    "chol_solve_using_factor", "gels_batched", "geqrf_batched",
    "gesv_batched", "gesv_mixed", "gesv_mixed_batched", "gesv_mixed_gmres",
    "posv_mixed", "posv_mixed_batched", "posv_mixed_gmres",
    "PolicyTable", "RefinePolicy", "least_squares_solve",
    "least_squares_solve_using_factor", "lu_factor",
    "lu_inverse_using_factor", "lu_solve", "lu_solve_using_factor",
    "multiply", "posv_batched", "qr_factor",
    "rank_2k_update", "rank_k_update", "triangular_multiply",
    "triangular_solve", "SlateError",
    "TiledMatrix", "from_dense", "hermitian", "pad_mask", "resolve_device",
    "symmetric", "triangular", "zeros",
    "Diag", "MatrixKind", "MethodEig", "MethodGels", "MethodGemm",
    "MethodHemm",
    "MethodLU", "MethodSVD", "MethodTrsm", "Norm", "NormScope", "Op",
    "Options",
    "Side", "Uplo", "gemm", "hemm", "her2k", "herk", "symm", "syr2k", "syrk",
    "trmm", "trsm", "add", "copy", "redistribute", "scale", "scale_row_col",
    "set_lambda", "set_matrix", "col_norms", "norm",
    "posv", "potrf", "potri", "potrs", "trtri", "trtrm", "gerbt", "gesv",
    "gesv_nopiv", "gesv_rbt", "getrf", "getrf_nopiv", "getrf_tntpiv",
    "getri", "getri_oop", "getrs",
    "QRFactors", "cholqr", "gelqf", "gels", "gels_using_factor", "geqrf",
    "qr_multiply_explicit", "tsqr", "unmlq", "unmqr", "Session",
    "hb2td", "he2hb", "he2td", "heev", "hegst", "hegv", "steqr", "sterf",
    "unmtr_hb2td", "unmtr_he2hb", "unmtr_he2td", "bdsqr", "ge2bd", "ge2tb",
    "svd",
    "Batcher", "Executor", "Histogram", "Metrics", "ShedPolicy",
    "default_session", "DEGRADATION_LADDER", "DeadlineExceeded",
    "FaultInjector", "FaultPlan", "FaultSpec", "QuotaExceeded",
    "RequestShed", "TransientDispatchError", "default_plan", "spectral",
]
