"""stedc — divide & conquer eigensolver of a symmetric tridiagonal matrix
(counterpart of ``slate_tpu/linalg/stedc.py``).

T = diag(T1, T2) + ρ·v·vᵀ is split at m = n // 2 with ρ = e[m − 1], the
halves are solved recursively, and each merge deflates (small z
components and near-equal eigenvalue pairs, rotated by Givens), solves
the secular equation for the k undeflated roots, forms the Gu/Eisenstat
revised ẑ and the k × k eigenvector matrix V, and updates the basis by
one column transform T: Q_new = blkdiag(Q1, Q2)·T, computed as the upper
rows Q1·T[:n1] and the lower rows Q2·T[n1:] (the zero blocks are not
formed). The numerical backbone is LAPACK's dlaed0..4, as the
reference's.

Where each stage runs:

- the leaves (n ≤ ``_SMALL_N``) are numpy's dense ``eigh`` on the host,
  as the reference's;
- the O(n) bookkeeping of a merge stays on the host in numpy: the sort,
  z's normalisation, the deflation loop with its Givens list, and the
  sparse columns of a rotated merge's transform, uploaded once;
- the secular roots (``hopper_ops.secular_roots``: P9 on a CUDA tensor,
  its plain version on a CPU one), ẑ, V, T and the basis products are
  float64 torch on the merge's device;
- subtrees below ``min_k`` run wholly on the host (CPU tensors) and their
  basis crosses to the device once. Each node mirrors its basis's first
  and last rows on the host in float64, so z needs no download of a
  basis: a merge downloads O(k) (the roots and the two new rows).

The basis is float64 for every input type: the reference's float32 basis
on accelerators and its double-single secular sweep (``ops/doublefloat``)
are TPU workarounds, so the port deflates at 8·ε₆₄ as the reference's
CPU path does. ``compute_z=False`` carries only each node's two boundary
rows (O(n) state); its merges take their roots on the device too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.exceptions import SlateError
from ..ops import hopper_ops

_EPS = np.finfo(np.float64).eps
_SMALL_N = 32       # leaf size: numpy's dense eigh of the tridiagonal
_CHUNK = 2048       # ẑ rows and V columns a pass takes (k × chunk temporaries)
# subtrees below this order run wholly on the host: the leaves and small
# merges cost a few host round trips each on the card (the CUDA value is
# chosen by measurement: PERF.md §5)
_MIN_K = {"cpu": 256, "cuda": 64}


class _Node:
    """A solved subtree: its basis ``q`` (n × n float64 tensor, None for
    values only) and the host mirror ``br`` (2 × n) of its first and
    last rows."""

    __slots__ = ("q", "br")

    def __init__(self, q: Optional[torch.Tensor], br: np.ndarray):
        self.q = q
        self.br = br


def _tridiag_eigh_base(d: np.ndarray, e: np.ndarray):
    t = np.diag(d)
    if d.size > 1:
        t += np.diag(e, 1) + np.diag(e, -1)
    return np.linalg.eigh(t)


def _roots(delta: np.ndarray, z2: np.ndarray, rho: float,
           dev: torch.device):
    """The secular roots on ``dev``: (shift, μ) on the host and on dev."""
    up_t, mu_t = hopper_ops.secular_roots(
        torch.as_tensor(delta, device=dev), torch.as_tensor(z2, device=dev),
        rho)
    k = delta.size
    shift_t = torch.arange(k, device=dev) + up_t.long()
    return shift_t.cpu().numpy(), mu_t.cpu().numpy(), shift_t, mu_t


def _revised_z(delta: torch.Tensor, shift: torch.Tensor, mu: torch.Tensor,
               rho: float) -> torch.Tensor:
    """Gu/Eisenstat ẑ: |ẑᵢ|² = Π_j(λ_j − δᵢ) / (ρ·Π_{j≠i}(δ_j − δᵢ)),
    λ_j = δ[shift_j] + μ_j, by log-sums over row chunks; positive by
    interlacing."""
    k = delta.numel()
    dshift = delta[shift]
    logz2 = torch.empty_like(delta)
    for c0 in range(0, k, _CHUNK):
        c1 = min(c0 + _CHUNK, k)
        di = delta[c0:c1]
        # λ_j − δᵢ = (δ[shift_j] − δᵢ) + μ_j: no catastrophic subtraction
        lam_minus = (dshift[None, :] - di[:, None]) + mu[None, :]
        lam_minus = torch.where(lam_minus == 0, 1e-300, lam_minus)
        pole_diff = delta[None, :] - di[:, None]
        rows = torch.arange(c1 - c0, device=delta.device)
        pole_diff[rows, rows + c0] = 1.0  # j == i excluded
        logz2[c0:c1] = (lam_minus.abs().log().sum(dim=1)
                        - pole_diff.abs().log().sum(dim=1))
    return torch.exp(logz2 - float(np.log(rho))).sqrt()


def _vectors(delta: np.ndarray, zu: np.ndarray, rho: float,
             shift_t: torch.Tensor, mu_t: torch.Tensor) -> torch.Tensor:
    """The merge's eigenvectors in the δ basis on μ's device: v_j[i] =
    ẑᵢ/(δᵢ − λ_j), normalised (k × k)."""
    dev = mu_t.device
    k = delta.size
    delta_t = torch.as_tensor(delta, device=dev)
    if k > 1:
        zhat = _revised_z(delta_t, shift_t, mu_t, rho) * torch.as_tensor(
            np.sign(zu), device=dev)
    else:
        zhat = torch.as_tensor(zu, device=dev)
    dshift = delta_t[shift_t]
    V = torch.empty((k, k), dtype=torch.float64, device=dev)
    for c0 in range(0, k, _CHUNK):
        c1 = min(c0 + _CHUNK, k)
        dif = (delta_t[:, None] - dshift[None, c0:c1]) - mu_t[None, c0:c1]
        dif = torch.where(dif == 0, 1e-300, dif)
        col = zhat[:, None] / dif
        V[:, c0:c1] = col / torch.linalg.vector_norm(col, dim=0, keepdim=True)
    return V


def _sparse_columns(n: int, order: np.ndarray, giv):
    """The columns of P_order·R_givens, each a {row: value} dict (a
    rotated merge's transform before V; reference :525-537)."""
    cols = [{int(order[j]): 1.0} for j in range(n)]
    for (i, j, c, sn) in giv:
        newi, newj = {}, {}
        for r, a in cols[i].items():
            newi[r] = newi.get(r, 0.0) + c * a
            newj[r] = newj.get(r, 0.0) + sn * a
        for r, a in cols[j].items():
            newi[r] = newi.get(r, 0.0) - sn * a
            newj[r] = newj.get(r, 0.0) + c * a
        cols[i], cols[j] = newi, newj
    return cols


def _transform(n: int, order: np.ndarray, giv, und: np.ndarray,
               V: Optional[torch.Tensor], final: np.ndarray,
               dev: torch.device) -> torch.Tensor:
    """The merge's column transform on ``dev`` (n × n float64),
    T = P_order·R_givens·S_V·P_final: Q_new = blkdiag(Q1, Q2)·T. Without
    rotations every column has one source row (two scatters); with them
    the sparse columns come from the host once, and the undeflated ones
    meet V in one product."""
    und_idx = np.nonzero(und)[0]
    defl_idx = np.nonzero(~und)[0]
    pos = np.empty(n, np.int64)
    pos[final] = np.arange(n)  # column j of the unsorted T lands at pos[j]
    T = torch.zeros((n, n), dtype=torch.float64, device=dev)

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    if not giv:
        if und_idx.size:
            T[ix(order[und_idx])[:, None], ix(pos[und_idx])[None, :]] = V
        if defl_idx.size:
            T[ix(order[defl_idx]), ix(pos[defl_idx])] = 1.0
        return T
    cols = _sparse_columns(n, order, giv)
    r, c, a = [], [], []
    for j in defl_idx:
        for row, val in cols[j].items():
            r.append(row), c.append(pos[j]), a.append(val)
    if r:
        T[ix(r), ix(c)] = torch.as_tensor(a, dtype=torch.float64, device=dev)
    if und_idx.size:
        r, c, a = [], [], []
        for i, j in enumerate(und_idx):
            for row, val in cols[j].items():
                r.append(row), c.append(i), a.append(val)
        S = torch.zeros((n, und_idx.size), dtype=torch.float64, device=dev)
        S[ix(r), ix(c)] = torch.as_tensor(a, dtype=torch.float64, device=dev)
        T[:, ix(pos[und_idx])] = S @ V
    return T


def _apply(q1: torch.Tensor, q2: torch.Tensor,
           T: torch.Tensor) -> torch.Tensor:
    """blkdiag(q1, q2)·T without the zero blocks: [q1·T[:n1]; q2·T[n1:]]."""
    n1 = q1.shape[0]
    return torch.cat([q1 @ T[:n1], q2 @ T[n1:]])


def _boundary_rows(br1: np.ndarray, br2: np.ndarray, order: np.ndarray,
                   giv, und: np.ndarray, V: Optional[torch.Tensor],
                   final: np.ndarray) -> np.ndarray:
    """The merged node's first and last rows, [br1[0] ‖ 0; 0 ‖ br2[1]]·T:
    the column order and rotations on the host, the product with V on
    V's device (2 × k up, 2 × k down)."""
    n1, n2 = br1.shape[1], br2.shape[1]
    rows = np.zeros((2, n1 + n2))
    rows[0, :n1] = br1[0]
    rows[1, n1:] = br2[1]
    rows = rows[:, order]
    for (i, j, c, sn) in giv:
        ri = rows[:, i].copy()
        rows[:, i] = c * ri - sn * rows[:, j]
        rows[:, j] = sn * ri + c * rows[:, j]
    if V is not None and V.numel():
        ru = torch.as_tensor(np.ascontiguousarray(rows[:, und]),
                             device=V.device)
        rows[:, und] = (ru @ V).cpu().numpy()
    return rows[:, final]


def _finish(node1: _Node, node2: _Node, n: int, order, giv, und, V, final,
            dev: torch.device) -> _Node:
    br = _boundary_rows(node1.br, node2.br, order, giv, und, V, final)
    if node1.q is None:
        return _Node(None, br)
    T = _transform(n, order, giv, und, V, final, dev)
    return _Node(_apply(node1.q, node2.q, T), br)


def _merge(w1: np.ndarray, node1: _Node, w2: np.ndarray, node2: _Node,
           rho_signed: float, dev: torch.device):
    """One merge: the eigen-decomposition of diag(w1, w2) + ρ·z·zᵀ and
    the merged node (reference ``_merge``, stedc.py:552-670)."""
    s = 1.0 if rho_signed >= 0 else -1.0
    rho = abs(float(rho_signed))
    dd = np.concatenate([w1, w2])
    n = dd.size
    order = np.argsort(dd, kind="stable")
    no_und = np.zeros(n, bool)
    if rho == 0.0:
        return dd[order], _finish(node1, node2, n, order, [], no_und, None,
                                  np.arange(n), dev)
    # z = vᵀ·blkdiag(Q1, Q2), v = [s·e_last; e_first], from the mirrors
    z = np.concatenate([s * node1.br[1], node2.br[0]])[order]
    dd = dd[order]
    nrm = np.linalg.norm(z)
    if nrm > 0:  # normalised, so the deflation tolerances are scale-free
        z = z / nrm
        rho = rho * nrm * nrm
    tol = 8.0 * _EPS * max(np.abs(dd).max(initial=0.0), rho)

    # deflation 1: rotate near-equal eigenvalue pairs so one z component
    # vanishes (dlaed2); the rotations touch basis columns only
    giv = []
    for idx in range(n - 1):
        if abs(dd[idx + 1] - dd[idx]) <= tol and abs(z[idx]) > 0:
            zi, zj = z[idx], z[idx + 1]
            r = np.hypot(zi, zj)
            if r > 0:
                giv.append((idx, idx + 1, zj / r, zi / r))
                z[idx + 1] = r
                z[idx] = 0.0
    # deflation 2: negligible z components
    und = ~(np.abs(rho * z) <= tol)
    k = int(und.sum())
    if k == 0:
        final = np.argsort(dd, kind="stable")
        return dd[final], _finish(node1, node2, n, order, giv, und, None,
                                  final, dev)
    delta = dd[und]
    zu = z[und]
    shift, mu, shift_t, mu_t = _roots(delta, zu * zu, rho, dev)
    V = _vectors(delta, zu, rho, shift_t, mu_t)
    w_new = dd.copy()
    w_new[und] = delta[shift] + mu
    final = np.argsort(w_new, kind="stable")
    return w_new[final], _finish(node1, node2, n, order, giv, und, V, final,
                                 dev)


def _stedc_rec(d: np.ndarray, e: np.ndarray, dev: torch.device,
               min_k: int, vals_only: bool):
    n = d.size
    if dev.type != "cpu" and n < min_k:
        # the subtree runs on the host; its basis crosses once, here
        w, node = _stedc_rec(d, e, torch.device("cpu"), min_k, vals_only)
        if node.q is not None:
            node.q = node.q.to(dev)
        return w, node
    if n <= _SMALL_N:
        w, q = _tridiag_eigh_base(d, e)
        br = np.ascontiguousarray(q[[0, -1], :])
        return w, _Node(None if vals_only else torch.as_tensor(q, device=dev),
                        br)
    m = n // 2
    rho = float(e[m - 1])
    d1 = d[:m].copy()
    d2 = d[m:].copy()
    d1[-1] -= abs(rho)
    d2[0] -= abs(rho)
    w1, q1 = _stedc_rec(d1, e[:m - 1], dev, min_k, vals_only)
    w2, q2 = _stedc_rec(d2, e[m:], dev, min_k, vals_only)
    return _merge(w1, q1, w2, q2, rho, dev)


def stedc(d, e, compute_z: bool = True, device=None,
          min_k: Optional[int] = None, grid=None
          ) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
    """Eigen-decomposition of the symmetric tridiagonal (d, e) by divide
    & conquer (slate::stedc). Returns (w ascending as float64 numpy, Z as
    a float64 tensor on ``device`` whose columns are the eigenvectors, or
    None when ``compute_z`` is False).

    ``device``: where the merges run ("cuda" unless asked for the CPU);
    P9 is chosen by it alone. ``min_k``: subtrees of smaller order run on
    the host (default ``_MIN_K`` by device type). A multi-device ``grid``
    raises: process grids are not ported yet (ROADMAP Queue 1 item 12)."""
    if grid is not None and getattr(grid, "size", 1) > 1:
        raise SlateError("stedc: process grids are not ported yet (ROADMAP "
                         "Queue 1 item 12)")
    dev = torch.device("cuda" if device is None else device)
    if min_k is None:
        min_k = _MIN_K.get(dev.type, _MIN_K["cuda"])
    d = np.asarray(d, np.float64).copy()
    e = np.asarray(e, np.float64).copy()
    n = d.size
    if n == 0:
        return d, (torch.zeros((0, 0), dtype=torch.float64, device=dev)
                   if compute_z else None)
    w, node = _stedc_rec(d, e, dev, min_k, vals_only=not compute_z)
    return w, node.q
