"""Carry operators and resident factors of the JAX package into the port.

Both functions take numpy arrays only (a ``slate_tpu`` TiledMatrix's
padded ``data`` and its metadata; a resident factor payload ``(L,)``,
``(LU, perm)``, a ``QRFactors``' ``(vr, t)``, or a spectral resident's
``(V, Λ)`` or ``(U, Σ, V)``) and never import the JAX
package. A low-precision payload (a refined operator's bfloat16, float32
or complex64 factor) is taken as it is: a bfloat16 array, which the
reference hands out with ``ml_dtypes``' numpy type and torch cannot
read, is carried by its bits (viewed as uint16, reinterpreted as
``torch.bfloat16``), so ``ml_dtypes`` is never imported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..core.exceptions import SlateError
import torch

from ..core.tiled_matrix import TiledMatrix, as_tensor, from_dense
from ..core.types import Diag, MatrixKind, Uplo
from ..linalg.qr import QRFactors
from ..spectral.types import EigFactors, SVDFactors


def _port_tensor(a, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``; a bfloat16 array by its bits."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return as_tensor(bits, device).view(torch.bfloat16)
    return as_tensor(arr, device)


def tiled_from_arrays(data: np.ndarray, *, nb: int,
                      kind: MatrixKind = MatrixKind.General,
                      uplo: Uplo = Uplo.General, diag: Diag = Diag.NonUnit,
                      logical_shape=None, device="cuda") -> TiledMatrix:
    """A port TiledMatrix from a reference matrix's padded storage and
    metadata (kind, uplo, diag, logical shape)."""
    data = _port_tensor(data, device)
    if data.ndim != 2:
        raise SlateError("tiled_from_arrays: data must be 2-D")
    return from_dense(data, nb, kind=kind, uplo=uplo, diag=diag,
                      logical_shape=logical_shape, device=device)


def factor_from_arrays(op: str, arrays: Sequence[np.ndarray], *, nb: int,
                       logical_shape, uplo: Uplo = Uplo.Lower,
                       device="cuda") -> Tuple:
    """A reference resident-factor payload as the port's payload:
    ``op="chol"``: ``(L,)`` → (triangular TiledMatrix,);
    ``op="lu"``: ``(LU, perm)`` → (TiledMatrix, int32 perm tensor);
    ``op="qr"``: ``(vr, t)`` → (QRFactors,) with ``logical_shape``
    = (m, n), or an appended-rows resident's 5-tuple ``((vr, t), u, w,
    tau, r)`` (``Session.update``'s payload, the base factors' pair first,
    ``logical_shape`` the base's) → (QRFactors, u, w, tau, r). The factor
    keeps its type: a low-precision payload of a refined operator (bf16,
    f32 or c64) stays in it. The spectral residents: ``op="eig"``:
    ``(V, Λ)`` with ``logical_shape`` = (n, n) → ``EigFactors``;
    ``op="svd"``: ``(U, Σ, V)`` with ``logical_shape`` = (m, n) of the
    operator → ``SVDFactors`` (U (m, k), V (n, k), k = min(m, n))."""
    if op == "chol":
        (l,) = arrays
        return (tiled_from_arrays(l, nb=nb, kind=MatrixKind.Triangular,
                                  uplo=uplo, logical_shape=logical_shape,
                                  device=device),)
    if op == "lu":
        lu, perm = arrays
        return (tiled_from_arrays(lu, nb=nb, logical_shape=logical_shape,
                                  device=device),
                as_tensor(np.asarray(perm, dtype=np.int32), device))
    if op == "qr":
        appended = len(arrays) == 5
        vr, t = (as_tensor(np.asarray(x), device)
                 for x in (arrays[0] if appended else arrays))
        m, n = logical_shape
        base = QRFactors(vr, t, m, n, nb)
        if not appended:
            return (base,)
        return (base,) + tuple(as_tensor(np.asarray(x), device)
                               for x in arrays[1:])
    if op == "eig":
        v, lam = arrays
        return EigFactors(tiled_from_arrays(v, nb=nb,
                                            logical_shape=logical_shape,
                                            device=device),
                          as_tensor(np.asarray(lam), device))
    if op == "svd":
        u, s, v = arrays
        m, n = logical_shape
        k = min(m, n)
        return SVDFactors(
            tiled_from_arrays(u, nb=nb, logical_shape=(m, k), device=device),
            as_tensor(np.asarray(s), device),
            tiled_from_arrays(v, nb=nb, logical_shape=(n, k), device=device))
    raise SlateError(f"factor_from_arrays: unsupported op {op!r}")
