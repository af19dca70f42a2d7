"""Served spectral applies: ``f(A)·b`` as two gemms and a diagonal scale
(counterpart of ``slate_tpu/spectral/apply.py``).

A resident decomposition turns every matrix function of the operator
into one program shape::

    X = L · diag(w) · Rᴴ · B      w = f(spectrum, θ)

(eig: L = R = V; svd: forward functions U, V, the others the
pseudoinverse orientation V…Uᴴ). ``make_apply_fn`` builds the
(payload, B, θ) -> X function that the Session runs eagerly or captures
once per (function, padded shape) as a CUDA graph: θ is a 0-d tensor on
the device, so a new shift, ridge or rank only refills it.

``make_probe_fn`` is the sampled eigen-residual probe: one gemm giving
``A·v_i − λ_i·v_i`` on a static sample of extreme columns, as the
(resid_max, x_max, b_max) triple of the factor probes. The Session does
not call it until the numerics monitor is ported (ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

import torch

from .. import api
from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense, zeros
from ..core.types import Options, DEFAULT_OPTIONS
from .types import function_catalog


def _scale_rows(y: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """diag(w)·y on the padded storage: w (length n, real) padded with
    zeros to y's rows. Residents are stored NoTrans, so storage row i < n
    is logical row i; the padded rows are already zero."""
    wpad = w.new_zeros(y.shape[0])
    wpad[:n] = w
    return y * wpad[:, None].to(y.dtype)


def make_apply_fn(op: str, fname: str, opts: Options = DEFAULT_OPTIONS):
    """(payload, B, theta) -> X for one served matrix function; ``theta``
    is a 0-d tensor of the spectrum's type on its device."""
    catalog = function_catalog(op)
    if fname not in catalog:
        raise SlateError(
            f"unknown spectral function {fname!r} for op {op!r}; "
            f"served functions: {sorted(catalog)}")
    wf, forward = catalog[fname]

    if op == "eig":
        def bases(payload):
            return payload.v, payload.lam, payload.v
    else:
        def bases(payload):
            L, R = ((payload.u, payload.v) if forward
                    else (payload.v, payload.u))
            return L, payload.s, R

    @accurate_matmuls
    def apply_fn(payload, B: TiledMatrix, theta) -> TiledMatrix:
        L, spec, R = bases(payload)
        w = wf(spec, theta)
        y = _scale_rows(R.dense_canonical().mH @ B.dense_canonical(), w,
                        spec.shape[0])
        return TiledMatrix(L.dense_canonical() @ y, L.shape[0], B.shape[1],
                           L.nb)

    apply_fn.__name__ = f"serve_{op}_apply_{fname}"
    return apply_fn


def make_probe_fn(op: str, opts: Options = DEFAULT_OPTIONS,
                  ncols: int = 4):
    """(payload, A) -> stats: the sampled spectral residual probe.

    eig: max |A·v_i − λ_i·v_i| over the ncols largest-λ columns (Λ
    ascending: the top of the spectrum dominates served solves); svd:
    max |A·v_i − σ_i·u_i| over the leading σ. Returns the stacked
    (resid_max, x_max, b_max) triple of the factor probes."""

    def sample(payload):
        if op == "eig":
            V, lam = payload.v, payload.lam
            n = V.shape[0]
            c = min(ncols, n)
            vs = V.dense_canonical()[:n, n - c:n]
            return V, vs, vs, lam[n - c:]
        U, s, V = payload.u, payload.s, payload.v
        c = min(ncols, s.shape[0])
        return (V, V.dense_canonical()[:V.shape[0], :c],
                U.dense_canonical()[:U.shape[0], :c], s[:c])

    @accurate_matmuls
    def probe_fn(payload, A: TiledMatrix) -> torch.Tensor:
        V, vs, xs, lams = sample(payload)
        m, c = A.shape[0], vs.shape[1]
        Vc = from_dense(vs, V.nb, logical_shape=(vs.shape[0], c),
                        device=vs.device)
        AV = api.multiply(1.0, A, Vc, 0.0,
                          zeros(m, c, V.nb, vs.dtype, device=vs.device),
                          opts)
        R = AV.dense_canonical()[:m, :c] - xs * lams[None, :].to(xs.dtype)
        return torch.stack([R.abs().max(), xs.abs().max(),
                            lams.abs().max().to(R.real.dtype)])

    probe_fn.__name__ = f"serve_{op}_spectral_probe"
    return probe_fn
