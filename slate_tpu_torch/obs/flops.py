"""Model FLOP formulas of the slice (own copy of the lawn41 conventions
in ``slate_tpu/obs/flops.py``), for GFLOP/s readouts and the Session's
flop counters."""

from __future__ import annotations


def gemm(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def rank_k(n: int, k: int) -> float:
    """n×n rank-k update (syrk/herk actual count)."""
    return float(n) * n * k


def rank_2k(n: int, k: int) -> float:
    return 2.0 * n * n * k


def tri_mm(n: int, k: int) -> float:
    """n×n triangular times n×k (trmm/trsm actual count). For
    Side.Right pass k = the OTHER operand's row count — the model is
    n²·k either way with n the triangular dimension."""
    return float(n) * n * k


def trtri(n: int) -> float:
    return n ** 3 / 3.0


def potrf(n: int) -> float:
    return n ** 3 / 3.0


def potri(n: int) -> float:
    return 2.0 * n ** 3 / 3.0


def getrf(n: int, m=None) -> float:
    return 2.0 * n ** 3 / 3.0


def getri(n: int) -> float:
    return 2.0 * n ** 3


def geqrf(m: int, n: int) -> float:
    return 2.0 * m * n * n - 2.0 * n ** 3 / 3.0


def gelqf(m: int, n: int) -> float:
    return 2.0 * m * m * n - 2.0 * m ** 3 / 3.0


def gels(m: int, n: int) -> float:
    return 2.0 * m * n * n


def heev(n: int, vectors: bool = False) -> float:
    """values: (4/3)n³ (the he2td reduction dominates); +2n³ for the
    eigenvector back-transform."""
    return (4.0 / 3.0 + (2.0 if vectors else 0.0)) * n ** 3


def heev_2stage(n: int) -> float:
    return 9.0 * n ** 3


def svd(m: int, n: int, vectors: bool = False) -> float:
    """values: (8/3)mn² (gebrd count); +4n³ for the U and V
    back-transforms (square-vectors convention of the tester)."""
    f = 8.0 * m * n * n / 3.0
    if vectors:
        f += 4.0 * n ** 3
    return f


def factor_flops(op: str, m: int, n: int) -> float:
    """Model flops of one factorization, by Session op kind (a small op
    counts as its dense kind; eig and svd are the two-stage spectral
    residents)."""
    op = op.removesuffix("_small")
    if op == "lu":
        return getrf(n)
    if op == "chol":
        return potrf(n)
    if op == "qr":
        return geqrf(m, n)
    if op == "eig":
        return heev_2stage(n)
    if op == "svd":
        return svd(m, n, vectors=True)
    raise ValueError(f"factor_flops: unsupported op {op!r}")


def solve_flops(op: str, m: int, n: int, k: int) -> float:
    """Model flops of a k-column solve against a resident factor."""
    op = op.removesuffix("_small")
    if op in ("lu", "chol"):
        return 2.0 * n * n * k
    if op == "qr":
        return (4.0 * m * n - 2.0 * n * n) * k
    if op in ("eig", "svd"):
        # a served spectral apply: two gemms against the resident bases
        # (the diagonal scale, O(nk), is below the model's resolution)
        return 4.0 * m * n * k
    raise ValueError(f"solve_flops: unsupported op {op!r}")


def update_chol(n: int, k: int) -> float:
    """Rank-k Cholesky up/downdate of a resident n×n L (the rotation
    sweep): each of the k vectors touches every column once, about 2n²
    per vector."""
    return 2.0 * n * n * k


def update_qr(n: int, k: int) -> float:
    """Append k rows to a resident QR of n columns: the structured
    factorization of [R; U], about 3n²k (the base's rows do not enter)."""
    return 3.0 * n * n * k


def update_flops(op: str, n: int, k: int) -> float:
    """Model flops of one rank-k/row-k incremental update against a
    resident factor, keyed by the Session op kind (chol/chol_small share
    the dense model; the batched dispatch credits B×)."""
    if op in ("chol", "chol_small"):
        return update_chol(n, k)
    if op == "qr":
        return update_qr(n, k)
    raise ValueError(f"update_flops: unsupported op {op!r}")
