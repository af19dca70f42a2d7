"""Enums and options of the port (trimmed copy of ``slate_tpu/core/types.py``).

Only what the ported slices (dense Cholesky, LU, QR, the BLAS-3 verbs and
norms) read is kept. The names and defaults match the reference, so an
``Options`` written for one package reads the same in the other.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

class Uplo(enum.Enum):
    """Which triangle of a matrix is stored/referenced."""

    General = "g"
    Lower = "l"
    Upper = "u"

    def flipped(self) -> "Uplo":
        if self is Uplo.Lower:
            return Uplo.Upper
        if self is Uplo.Upper:
            return Uplo.Lower
        return self


class Op(enum.Enum):
    """Transposition view state (metadata, applied lazily)."""

    NoTrans = "n"
    Trans = "t"
    ConjTrans = "c"


class Diag(enum.Enum):
    NonUnit = "n"
    Unit = "u"


class Side(enum.Enum):
    Left = "l"
    Right = "r"


class Norm(enum.Enum):
    One = "1"
    Two = "2"
    Inf = "i"
    Fro = "f"
    Max = "m"


class NormScope(enum.Enum):
    Matrix = "m"
    Columns = "c"
    Rows = "r"


class MatrixKind(enum.Enum):
    General = "ge"
    Trapezoid = "tz"
    Triangular = "tr"
    Symmetric = "sy"
    Hermitian = "he"
    Band = "gb"
    TriangularBand = "tb"
    HermitianBand = "hb"


class MethodGemm(enum.Enum):
    Auto = "auto"
    A = "A"
    C = "C"
    SUMMA = "summa"


class MethodTrsm(enum.Enum):
    Auto = "auto"
    A = "A"
    B = "B"


class MethodHemm(enum.Enum):
    Auto = "auto"
    A = "A"
    C = "C"


class MethodLU(enum.Enum):
    Auto = "auto"
    PartialPiv = "ppiv"
    CALU = "calu"
    NoPiv = "nopiv"
    RBT = "rbt"


class MethodGels(enum.Enum):
    Auto = "auto"
    QR = "qr"
    CholQR = "cholqr"


class MethodEig(enum.Enum):
    Auto = "auto"
    QR = "qr"  # steqr QR iteration
    DC = "dc"  # divide & conquer (stedc, linalg/stedc.py)


class MethodSVD(enum.Enum):
    Auto = "auto"
    QR = "qr"  # the ge2tb band arms at any size
    DC = "dc"  # ge2bd + bdsqr on stedc (linalg/svd.py)


@dataclasses.dataclass(frozen=True)
class Options:
    """Per-call options bag (the fields the ported slices read).

    ``method_lu``, ``pivot_threshold`` and ``method_gels`` are read, and
    ``method_gemm`` for SUMMA (the unported methods raise); so are
    ``method_eig`` and ``eig_stage1`` (heev's tridiagonal method and its
    stage-1 reduction: "auto" and "he2td" the direct tridiagonalization,
    "two_stage" he2hb + the hb2td bulge chase), and
    ``method_svd`` (svd's dispatch: DC, and Auto from
    min(m, n) ≥ 2048, run ge2bd + bdsqr; QR, and Auto below that, the
    ge2tb band arms),
    ``max_iterations`` and ``use_fallback_solver`` (gesv_rbt's and the
    mixed-precision drivers' refinement steps and their fallbacks),
    ``tolerance`` (GMRES-IR's) and ``depth`` (the butterfly depth of
    gerbt). The others are
    accepted for parity and ignored: ``method_hemm`` and ``method_gemm``'s
    A and C because they pick the reference's data placement on a grid,
    which one device does not have; ``method_trsm`` because trsm runs one
    path, the gemm-based block recursion;
    ``update_precision`` because every factorization path runs its
    matmuls in full precision with TF32 off (core/precision.py);
    ``lookahead``, ``lu_pivot_fusion``, ``lu_tournament_batched`` and
    ``factor_iter_large`` because the port runs one path, the reference's
    default (fused pivoting, lookahead-1, batched tournament rounds, the
    iterative loop wherever it applies)."""

    lookahead: int = 1
    pivot_threshold: float = 1.0
    update_precision: str = "high"
    method_gemm: MethodGemm = MethodGemm.Auto
    method_trsm: MethodTrsm = MethodTrsm.Auto
    method_hemm: MethodHemm = MethodHemm.Auto
    method_lu: MethodLU = MethodLU.Auto
    lu_pivot_fusion: bool = True
    lu_tournament_batched: bool = True
    factor_iter_large: bool = True
    method_gels: MethodGels = MethodGels.Auto
    max_iterations: int = 30
    use_fallback_solver: bool = True
    # GMRES-IR convergence tolerance; None = eps(working)·√n
    tolerance: Optional[float] = None
    depth: int = 2  # RBT butterfly depth
    method_eig: MethodEig = MethodEig.Auto
    # stage-1 reduction of heev's tridiagonal path: "auto" (= "he2td"),
    # "he2td" or "two_stage"
    eig_stage1: str = "auto"
    method_svd: MethodSVD = MethodSVD.Auto

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)


DEFAULT_OPTIONS = Options()

