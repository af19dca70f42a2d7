"""GMRES-IR mixed-precision solvers: gesv_mixed_gmres, posv_mixed_gmres
(counterpart of ``slate_tpu/linalg/gmres.py``).

Factor once in low precision, then run flexible GMRES (FGMRES) in the
working precision, right-preconditioned by the low-precision factor; it
converges on systems where plain iterative refinement (gesv_mixed /
posv_mixed) stagnates (Carson & Higham, the basis of SLATE's
src/gesv_mixed_gmres.cc). The reference's contract is kept:

- restart = min(30, itermax, nb − 1);
- tol defaults to eps·√n; stop when for every right-hand side column
  ‖r_j‖max ≤ tol·‖A‖inf·‖x_j‖max;
- CGS2 (classical Gram–Schmidt, twice) and an incremental Givens QR of
  the Hessenberg matrix whose rotated residual ends the cycle early;
- iter ≥ 0 converged in iter steps, −3 the low-precision factor is
  singular, −(itermax+1) no convergence; the full-precision fallback
  solve runs under ``Options.use_fallback_solver``;
- nrhs > 1 is solved column by column.

One restart cycle runs on the device with no host read: every Arnoldi
step is computed and committed under the cycle's ``active`` flag (a
finished cycle's later steps change nothing), as the reference's
fixed-length loop does. The host reads the residual norms and the
cycle's step count once per cycle.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense, unit_pad_diag
from ..core.types import Norm, Options, DEFAULT_OPTIONS
from ..ops import blocked
from . import elementwise as ew
from .norms import norm

DEFAULT_RESTART = 30


def _rotg(f: torch.Tensor, g: torch.Tensor):
    """Givens rotation (LAPACK lartg convention): (c real, s, r) with
    [c s; −conj(s) c]·[f; g] = [r; 0]."""
    af, ag = f.abs(), g.abs()
    d = torch.sqrt(af * af + ag * ag)
    one = torch.ones_like(d)
    safe_d = torch.where(d == 0, one, d)
    c = torch.where(d == 0, one, af / safe_d)
    fsign = torch.where(af == 0, torch.ones_like(f),
                        f / torch.where(af == 0, one, af).to(f.dtype))
    s = torch.where(d == 0, torch.zeros_like(f),
                    torch.where(af == 0, g.conj() / safe_d.to(g.dtype),
                                fsign * g.conj() / safe_d.to(g.dtype)))
    r = torch.where(af == 0, ag.to(f.dtype), fsign * d.to(f.dtype))
    return c, s, r


def _solve_lu(lu_lo: torch.Tensor, perm, v: torch.Tensor,
              nb: int) -> torch.Tensor:
    """Preconditioner M⁻¹v from low-precision LU factors (getrs)."""
    y = blocked.trsm_rec(lu_lo, v.index_select(0, perm), left=True,
                         lower=True, unit=True, base=nb)
    return blocked.trsm_rec(lu_lo, y, left=True, lower=False, unit=False,
                            base=nb)


def _solve_chol(l_lo: torch.Tensor, v: torch.Tensor,
                nb: int) -> torch.Tensor:
    """Preconditioner M⁻¹v from the low-precision Cholesky factor."""
    y = blocked.trsm_rec(l_lo, v, left=True, lower=True, unit=False,
                         base=nb)
    return blocked.trsm_rec(l_lo, y, left=True, lower=True, unit=False,
                            trans_a=True, conj_a=True, base=nb)


def _precond(factor, perm, kind: str, nb: int, v: torch.Tensor
             ) -> torch.Tensor:
    vl = v.to(factor.dtype)
    sol = (_solve_lu(factor, perm, vl, nb) if kind == "lu"
           else _solve_chol(factor, vl, nb))
    return sol.to(v.dtype)


def _fgmres_cycle(a: torch.Tensor, factor, perm, x: torch.Tensor,
                  b: torch.Tensor, threshold: torch.Tensor, remaining: int,
                  restart: int, kind: str, nb: int):
    """One FGMRES(restart) cycle for a single (npad, 1) right-hand side.
    Returns (x_new, steps, final rotated residual, breakdown), all on the
    device: ``steps`` counts the Arnoldi steps taken before the rotated
    residual passed ``threshold``, the basis broke down or the global
    budget ``remaining`` ran out."""
    npad = a.shape[0]
    hi = a.dtype
    rdt = a.real.dtype if a.is_complex() else a.dtype
    dev = a.device

    r0 = b - a @ x
    beta = torch.linalg.vector_norm(r0)
    breakdown = beta == 0
    beta_safe = torch.where(breakdown, torch.ones_like(beta), beta)
    V = torch.zeros((npad, restart + 1), dtype=hi, device=dev)
    V[:, 0] = (r0 / beta_safe.to(hi))[:, 0]
    W = torch.zeros((npad, restart + 1), dtype=hi, device=dev)
    H = torch.zeros((restart + 1, restart), dtype=hi, device=dev)
    S = torch.zeros(restart + 1, dtype=hi, device=dev)
    S[0] = beta.to(hi)
    cs = torch.zeros(restart, dtype=rdt, device=dev)
    sn = torch.zeros(restart, dtype=hi, device=dev)
    res = beta.to(rdt)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    active = ~breakdown & (res >= threshold) & (remaining > 0)
    idx = torch.arange(restart + 1, device=dev)

    for j in range(restart):
        w = _precond(factor, perm, kind, nb, V[:, j:j + 1])
        vnew = a @ w
        # CGS2 against V[:, :j+1] (the unset columns are zero)
        h1 = V.mH @ vnew
        vnew = vnew - V @ h1
        h2 = V.mH @ vnew
        vnew = vnew - V @ h2
        vnorm = torch.linalg.vector_norm(vnew)
        vsafe = torch.where(vnorm == 0, torch.ones_like(vnorm), vnorm)
        hcol = torch.where(idx <= j, (h1 + h2)[:, 0], 0)
        hcol[j + 1] = vnorm.to(hi)
        # the earlier rotations 0..j-1, then this step's
        for i in range(j):
            ci = cs[i].to(hi)
            hc_i, hc_i1 = hcol[i].clone(), hcol[i + 1].clone()
            hcol[i] = ci * hc_i + sn[i] * hc_i1
            hcol[i + 1] = -sn[i].conj() * hc_i + ci * hc_i1
        c_j, s_j, r_j = _rotg(hcol[j].clone(), hcol[j + 1].clone())
        hcol[j] = r_j
        hcol[j + 1] = 0
        s_next = -s_j.conj() * S[j]
        s_j_new = c_j.to(hi) * S[j] + s_j * S[j + 1]
        res2 = s_next.abs().to(rdt)
        steps2 = steps + 1
        # commit this step only while the cycle is active
        V[:, j + 1] = torch.where(active, (vnew / vsafe.to(hi))[:, 0],
                                  V[:, j + 1])
        W[:, j + 1] = torch.where(active, w[:, 0], W[:, j + 1])
        H[:, j] = torch.where(active, hcol, H[:, j])
        S[j + 1] = torch.where(active, s_next, S[j + 1])
        S[j] = torch.where(active, s_j_new, S[j])
        cs[j] = torch.where(active, c_j, cs[j])
        sn[j] = torch.where(active, s_j, sn[j])
        res = torch.where(active, res2, res)
        steps = torch.where(active, steps2, steps)
        active = active & (res2 >= threshold) & (vnorm > 0) & (
            steps2 < remaining)

    # y = H[:steps, :steps]⁻¹ S[:steps], the unused columns padded with
    # an identity diagonal so the fixed-size triangular solve is exact
    k = torch.arange(restart, device=dev)
    hsq = H[:restart].clone()
    hsq.diagonal().copy_(torch.where(k >= steps, torch.ones_like(
        hsq.diagonal()), hsq.diagonal()))
    svec = torch.where(k < steps, S[:restart], 0)
    y = torch.linalg.solve_triangular(hsq, svec[:, None], upper=True)
    return x + W[:, 1:] @ y, steps, res, breakdown


def _res_norms(a, xj, bj) -> Tuple[float, float]:
    """(‖b − a·x‖max, ‖x‖max) read together: one host read."""
    rj = bj - a @ xj
    return tuple(torch.stack([rj.abs().max(), xj.abs().max()]).tolist())


def _ir_gmres(A: TiledMatrix, B: TiledMatrix, opts: Options,
              factor, perm, kind: str) -> Tuple[TiledMatrix, int]:
    """The shared FGMRES-IR outer loop (host control, device cycles)."""
    work = A.dtype
    n = A.shape[0]
    a = unit_pad_diag(A.full_dense_canonical().clone(), n, n)
    b = B.dense_canonical().to(work)
    npad = a.shape[0]
    if b.shape[0] != npad:
        b = torch.cat([b, b.new_zeros((npad - b.shape[0], b.shape[1]))])

    eps = float(torch.finfo(work).eps)
    tol = (opts.tolerance if opts.tolerance is not None
           else eps * math.sqrt(n))
    itermax = opts.max_iterations
    restart = max(1, min(DEFAULT_RESTART, itermax, A.nb - 1))
    cte = float(norm(A, Norm.Inf)) * tol
    rdt = a.real.dtype if a.is_complex() else a.dtype

    # the initial guess: one preconditioner solve of every column at once
    x = _precond(factor, perm, kind, A.nb, b)
    total_iter = 0
    converged = True
    for j in range(b.shape[1]):
        xj, bj = x[:, j:j + 1], b[:, j:j + 1]
        iiter = 0
        col_conv = False
        while iiter < itermax:
            rnorm, xnorm = _res_norms(a, xj, bj)
            if rnorm <= cte * xnorm:
                col_conv = True
                break
            threshold = torch.tensor(cte * xnorm, dtype=rdt, device=a.device)
            xj, steps, _, breakdown = _fgmres_cycle(
                a, factor, perm, xj, bj, threshold, itermax - iiter,
                restart, kind, A.nb)
            steps, broke = torch.stack([steps.to(torch.int64),
                                        breakdown.to(torch.int64)]).tolist()
            iiter += max(steps, 1)
            if broke:
                break
        total_iter = max(total_iter, iiter)
        if not col_conv:
            # the loop may stop at itermax with the last update unchecked
            rnorm, xnorm = _res_norms(a, xj, bj)
            col_conv = rnorm <= cte * xnorm
        converged = converged and col_conv
        x[:, j:j + 1] = xj

    X = from_dense(x[: B.dense_canonical().shape[0]], B.nb,
                   logical_shape=B.shape, device=x.device)
    return X, (total_iter if converged else -(itermax + 1))


@accurate_matmuls
def gesv_mixed_gmres(A: TiledMatrix, B: TiledMatrix,
                     opts: Options = DEFAULT_OPTIONS,
                     factor_dtype=torch.float32
                     ) -> Tuple[TiledMatrix, torch.Tensor, int]:
    """Solve A·X = B by GMRES-IR: LU in ``factor_dtype``, FGMRES in the
    working precision (slate::gesv_mixed_gmres). Returns (X, info, iter);
    iter < 0: not converged (−3: the low factor is singular,
    −(itermax+1): out of iterations), with the full-precision fallback
    applied under ``opts.use_fallback_solver``."""
    from . import lu as lu_mod

    if A.dtype == factor_dtype:
        X, info = lu_mod.gesv(A, B, opts)
        return X, info, 0
    LU, perm, info = lu_mod.getrf(ew.copy(A, dtype=factor_dtype), opts)
    if int(info) != 0:
        if opts.use_fallback_solver:
            X, info2 = lu_mod.gesv(A, B, opts)
            return X, info2, -3
        return B, info, -3
    lu_pad = unit_pad_diag(LU.dense_canonical().clone(), *LU.shape)
    X, iters = _ir_gmres(A, B, opts, lu_pad, perm, "lu")
    if iters < 0 and opts.use_fallback_solver:
        X, info = lu_mod.gesv(A, B, opts)
    return X, info, iters


@accurate_matmuls
def posv_mixed_gmres(A: TiledMatrix, B: TiledMatrix,
                     opts: Options = DEFAULT_OPTIONS,
                     factor_dtype=torch.float32
                     ) -> Tuple[TiledMatrix, torch.Tensor, int]:
    """Solve Hermitian positive definite A·X = B by GMRES-IR: Cholesky in
    ``factor_dtype``, FGMRES in the working precision
    (slate::posv_mixed_gmres)."""
    from . import cholesky as chol_mod

    if A.dtype == factor_dtype:
        X, info = chol_mod.posv(A, B, opts)
        return X, info, 0
    L_lo, info = chol_mod.potrf(ew.copy(A, dtype=factor_dtype), opts)
    if int(info) != 0:
        if opts.use_fallback_solver:
            X, info2 = chol_mod.posv(A, B, opts)
            return X, info2, -3
        return B, info, -3
    lmat = unit_pad_diag(torch.tril(L_lo.dense_canonical()), *L_lo.shape)
    X, iters = _ir_gmres(A, B, opts, lmat, None, "chol")
    if iters < 0 and opts.use_fallback_solver:
        X, info = chol_mod.posv(A, B, opts)
    return X, info, iters
