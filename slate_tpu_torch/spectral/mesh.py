"""Two-stage heev and svd as the staged pipelines of the served
spectral residents, on one device (counterpart of
``slate_tpu/spectral/mesh.py``).

``heev_staged``: he2hb (full → band), hb2td (the bulge chase), stedc,
then the back-transforms unmtr_hb2td and unmtr_he2hb. ``svd_staged``:
ge2tb (full → band), the Golub–Kahan embedding of the band chased at
bandwidth 2·nb (hb2td), stedc, then the split of the embedded vectors
and unmbr_ge2tb (``linalg/svd.py``'s band arm). Operands with
npad < 3·nb take a dense arm: he2hb and a dense eigh of the band, or
ge2tb and a dense SVD of it.

Each stage is called through its module's name (``linalg/eig.py``,
``linalg/svd.py``), so the stage hooks of ``obs/stages.py`` time a
served factor as they time heev and svd. The reference's XLA seams (the
``stage`` hook, the jit caches, the offsets stripped at program
boundaries, the mesh gather) have no counterpart: here every stage is an
eager call on one device, and a multi-device grid raises (ROADMAP
Queue 1 item 12).

As the reference's, the staged path skips heev's extreme-range scaling
and the svd's ±0 subspace completion: serving residents assume a
working-type conditioned operand of numerical rank k.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.exceptions import SlateError
from ..core.precision import accurate_matmuls
from ..core.tiled_matrix import TiledMatrix, from_dense, num_tiles
from ..core.types import MatrixKind, Options, DEFAULT_OPTIONS
from ..linalg import eig as _eig
from ..linalg import svd as _svd
from ..ops import blocked


def _single_device(grid, what: str):
    if grid is not None and getattr(grid, "size", 1) > 1:
        raise NotImplementedError(
            f"{what}: process grids are not ported yet (ROADMAP Queue 1 "
            "item 12)")


def _level_offsets(panels: int, nb: int) -> Tuple[int, ...]:
    offs, off = [], 0
    for kp in blocked.level_plan(panels):
        offs.append(off)
        off += kp * nb
    return tuple(offs)


def eig_level_offsets(n: int, nb: int) -> Tuple[int, ...]:
    """he2hb's level offsets for an (n, nb) operand: the offsets of its
    reflector entries (he2hb plans over nt − 1 panel columns)."""
    return _level_offsets(num_tiles(n, nb) - 1, nb)


def svd_level_offsets(n: int, nb: int) -> Tuple[int, ...]:
    """ge2tb's level offsets (it plans over kt = npad/nb panel
    columns)."""
    return _level_offsets(num_tiles(n, nb), nb)


@accurate_matmuls
def heev_staged(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS,
                grid=None) -> Tuple[torch.Tensor, TiledMatrix]:
    """Two-stage Hermitian eigendecomposition: (Λ ascending in A's real
    type, V TiledMatrix) on A's device."""
    _single_device(grid, "heev_staged")
    if A.kind not in (MatrixKind.Hermitian, MatrixKind.Symmetric):
        raise SlateError("heev_staged: A must be Hermitian/Symmetric")
    n, nb = A.shape[0], A.nb
    npad = num_tiles(n, nb) * nb
    if npad < 3 * nb:
        return _eig._heev_band_dense(A, True)
    band, refl = _eig.he2hb(A, opts)
    d, e, Vh, Th, phase = _eig.hb2td(band)
    w, z = _eig.stedc(d[:n].double().cpu().numpy(),
                      e[:n - 1].double().cpu().numpy(), device=A.device)
    zt = torch.zeros((npad, n), dtype=A.dtype, device=A.device)
    zt[:n] = z.to(A.dtype)
    Z = _eig.unmtr_he2hb(refl, _eig.unmtr_hb2td(Vh, Th, zt, phase))
    lam = torch.as_tensor(w, device=A.device).to(_eig._real_dtype(A.dtype))
    return lam, from_dense(Z[:n], nb, logical_shape=(n, n), device=A.device)


@accurate_matmuls
def svd_staged(A: TiledMatrix, opts: Options = DEFAULT_OPTIONS, grid=None
               ) -> Tuple[torch.Tensor, TiledMatrix, TiledMatrix]:
    """Two-stage thin SVD of a tall A (m ≥ n): (Σ descending in A's real
    type, U (m, k), V (n, k)), k = min(m, n), on A's device."""
    _single_device(grid, "svd_staged")
    m, n = A.shape
    if m < n:
        raise SlateError(
            "svd_staged: wide operands are not servable; register the "
            "transpose (the api.svd verb handles wide per call)")
    nb = A.nb
    band, u_refl, v_refl = _svd.ge2tb(A, opts)
    if num_tiles(n, nb) * nb < 3 * nb:
        return _svd._svd_band_dense(A, band, u_refl, v_refl, n, True)
    return _svd._svd_band_gk(A, band, u_refl, v_refl, n, True,
                             complete=False)
