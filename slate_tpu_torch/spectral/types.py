"""Resident spectral payload types and the served matrix-function
catalog (counterpart of ``slate_tpu/spectral/types.py``).

The serving Session keeps an eigendecomposition ``(V, Λ)`` (op kind
``eig``) or a thin SVD ``(U, Σ, V)`` (op kind ``svd``) as one resident
payload, so its byte accounting and eviction see a spectral resident as
one more factor. The vectors are TiledMatrices on the device, the
spectrum a real tensor beside them.

The catalog maps a served matrix function to its diagonal weights: every
served apply is ``L·diag(w)·Rᴴ·b``, two gemms against the resident bases
and one diagonal scale. Each weight function runs on the device with no
host read (a sort, an index tensor and masks), so a CUDA graph captured
on one θ serves every θ copied into its static θ tensor.
"""

from __future__ import annotations

import torch


class EigFactors:
    """Resident Hermitian eigendecomposition A = V·diag(Λ)·Vᴴ.

    ``v``: TiledMatrix of eigenvectors (columns); ``lam``: real
    eigenvalues ASCENDING (the heev/stedc convention), in the operand's
    real type on its device."""

    __slots__ = ("v", "lam")

    def __init__(self, v, lam):
        self.v = v
        self.lam = lam

    def __repr__(self):
        return f"EigFactors(n={self.v.shape[0]})"


class SVDFactors:
    """Resident thin SVD A = U·diag(Σ)·Vᴴ.

    ``u``: (m, k) left vectors, ``s``: singular values DESCENDING (the
    svd convention), ``v``: (n, k) right vectors, k = min(m, n)."""

    __slots__ = ("u", "s", "v")

    def __init__(self, u, s, v):
        self.u = u
        self.s = s
        self.v = v

    def __repr__(self):
        return f"SVDFactors(m={self.u.shape[0]}, n={self.v.shape[0]})"


# ---------------------------------------------------------------------------
# served matrix functions: f -> diagonal weights
# ---------------------------------------------------------------------------
#
# Every entry is (weights(spectrum, theta), forward): ``theta`` is a 0-d
# tensor of the spectrum's type on its device, and ``forward`` picks the
# gemm bases: True -> X = L·diag(w)·Rᴴ·b in the operator's direction
# (eig: V…Vᴴ; svd: U…Vᴴ), False -> the pseudoinverse direction (svd:
# V…Uᴴ).


def _rank_of(theta: torch.Tensor, n: int) -> torch.Tensor:
    """theta -> its integer rank clamped to [0, n], rounding half to even
    (``torch.round``, as ``jnp.round``)."""
    return torch.clamp(torch.round(theta), 0, n).to(torch.int64)


def _eig_solve(lam, theta):
    # solve-with-shift: (A − θ·I)⁻¹ b
    return 1.0 / (lam - theta)


def _eig_psd_project(lam, theta):
    # nearest-PSD projection: the negative modes clamped to zero
    return torch.clamp(lam, min=0.0)


def _eig_whiten(lam, theta):
    # Λ^{-1/2} on the positive spectrum (θ: a ridge added before the
    # inverse square root; θ = 0 is plain whitening)
    lt = lam + theta
    pos = lt > 0
    safe = torch.where(pos, lt, 1.0)
    return torch.where(pos, safe ** -0.5, 0.0)


def _eig_truncate(lam, theta):
    # keep the round(θ) largest-|λ| modes; a tied |λ| group is kept whole
    n = lam.shape[0]
    r = _rank_of(theta, n)
    mag = lam.abs()
    srt = torch.sort(mag).values  # ascending
    guard = torch.cat([srt, srt[-1:] + 1])
    thr = guard.gather(0, (n - r).reshape(1))
    return torch.where(mag >= thr, lam, 0.0)


def _svd_solve(s, theta):
    # Tikhonov-regularised pseudoinverse: σ/(σ² + θ²); θ = 0 gives 1/σ on
    # the nonzero spectrum
    nz = s > 0
    safe = torch.where(nz, s, 1.0)
    return torch.where(nz, safe / (safe * safe + theta * theta), 0.0)


def _svd_truncate(s, theta):
    # the rank-r truncated operator A_r·b (σ descending: the first r stay)
    r = _rank_of(theta, s.shape[0])
    keep = torch.arange(s.shape[0], device=s.device) < r
    return torch.where(keep, s, 0.0)


def _svd_whiten(s, theta):
    # Σ⁻¹ on the nonzero spectrum (+θ ridge): the V·Σ⁻¹·Uᴴ whitening
    # transform of a data matrix
    nz = s > 0
    safe = torch.where(nz, s + theta, 1.0)
    return torch.where(nz, 1.0 / safe, 0.0)


# eig applies are V·diag(w)·Vᴴ always (forward is vacuous, kept so both
# catalogs have one shape)
EIG_FUNCTIONS = {
    "solve": (_eig_solve, True),
    "psd_project": (_eig_psd_project, True),
    "whiten": (_eig_whiten, True),
    "truncate": (_eig_truncate, True),
}

SVD_FUNCTIONS = {
    "solve": (_svd_solve, False),       # V·w·Uᴴ (pinv direction)
    "truncate": (_svd_truncate, True),  # U·w·Vᴴ (forward direction)
    "whiten": (_svd_whiten, False),
}


def function_catalog(op: str) -> dict:
    return EIG_FUNCTIONS if op == "eig" else SVD_FUNCTIONS
