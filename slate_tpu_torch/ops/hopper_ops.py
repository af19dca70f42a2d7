"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
gates and launch counters.

Counterpart of ``slate_tpu/ops/pallas_ops.py``: the launchers keep the
reference's names (``chol_tile``, ``lu_panel_base``, ``lu_panel_eligible``)
so the call sites in ``ops/blocked.py`` map one to one. Dispatch is by the
tensor's device and nothing else:

- a CUDA tensor launches the CUDA kernel (``csrc/*.cu``, built by
  ``ops/_build.py``) or the wrapper raises — there is no environment
  switch and no fallback;
- a CPU tensor runs the plain PyTorch version beside the kernel, which
  the CPU tests hold against the reference and ``chip_smoke.py`` holds
  the kernel against on the card.

``LAUNCHES`` counts kernel launches (plain runs are not counted), so a
run can show that its main path went through the kernels.

The reference's TPU gates (VMEM size, the 8-row sublane floor) do not carry
over: every real f32/f64 potrf tile goes through ``chol_tile``, and every
panel base of width 1..128 (any height) goes through ``lu_panel_base``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from ..core.exceptions import SlateError
from . import _build

LAUNCHES: Dict[str, int] = {"chol_tile": 0, "lu_panel_base": 0}

_REAL = (torch.float32, torch.float64)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn(lib: str, sym: str, argtypes, restype=ctypes.c_int):
    """A C entry point with argtypes declared: pointers and the stream
    as c_void_p (a plain int argument would cut a 64-bit pointer), sizes
    as c_int. Launchers return a cudaError_t."""
    f = _fns.get(sym)
    if f is None:
        f = getattr(_build.load(lib), sym)
        f.argtypes = list(argtypes)
        f.restype = restype
        _fns[sym] = f
    return f


def _check_cuda_args(name: str, a: torch.Tensor):
    if a.device.type != "cuda":
        raise SlateError(f"{name}: unsupported device {a.device}")
    if not a.is_contiguous():
        raise SlateError(f"{name}: expects a contiguous row-major tensor")


def _raise_on(rc: int, lib: str, err_sym: str, what: str):
    if rc:
        msg = _fn(lib, err_sym, [_I], ctypes.c_char_p)(rc).decode()
        raise SlateError(f"{what}: CUDA launch failed ({rc}: {msg})")


# ---------------------------------------------------------------------------
# K1: Cholesky of one diagonal tile
# ---------------------------------------------------------------------------

def chol_tile_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: right-looking column loop over the LOWER
    triangle of ``a``; strict upper of the result zeroed; a non-positive
    or NaN pivot makes that diagonal entry NaN and poisons everything
    right of and below it. No host sync."""
    b = a.shape[0]
    l = torch.tril(a)
    nan = torch.full((), math.nan, dtype=a.dtype, device=a.device)
    for j in range(b):
        d = l[j, j]
        s = torch.where(d > 0, d.sqrt(), nan)
        l[j, j] = s
        if j + 1 < b:
            l[j + 1:, j] /= s
            col = l[j + 1:, j]
            l[j + 1:, j + 1:] -= torch.outer(col, col)
    return torch.tril(l)


def chol_tile(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one (b, b) tile (strict upper zeroed).

    Replaces ``pallas_ops.chol_tile`` (pallas_ops.py:337-348). The CUDA
    kernel (csrc/chol_tile.cu) is latency-bound: one serial chain of b
    pivots, kept inside one thread block with MB-wide column panels
    staged in shared memory, so any b goes through it. Reads only the
    lower triangle."""
    if a.dtype not in _REAL:
        raise NotImplementedError(
            f"chol_tile: real float32/float64 only, got {a.dtype}")
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise SlateError(f"chol_tile: expects a square tile, got "
                         f"{tuple(a.shape)}")
    if a.device.type == "cpu":
        return chol_tile_plain(a)
    _check_cuda_args("chol_tile", a)
    b = a.shape[0]
    out = torch.empty_like(a)
    f = _fn("chol_tile", f"slate_chol_tile_{_SUFFIX[a.dtype]}",
            [_P, _P, _I, _P])
    with torch.cuda.device(a.device):
        rc = f(a.data_ptr(), out.data_ptr(), b,
               torch.cuda.current_stream(a.device).cuda_stream)
    if rc:
        maxb = _fn("chol_tile", "slate_chol_tile_max_b", [_I])
        _raise_on(rc, "chol_tile", "slate_chol_error_string",
                  f"chol_tile (b={b}; largest b at {a.dtype}: "
                  f"{maxb(a.element_size())})")
    LAUNCHES["chol_tile"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: pivoted LU of one tall panel base
# ---------------------------------------------------------------------------

LU_PANEL_MAX_W = 128


def lu_panel_eligible(w: int) -> bool:
    """Whether ``panel_getrf`` stops its width recursion and hands the
    panel to ``lu_panel_base`` whole: any w ≤ 128, at any height."""
    return w <= LU_PANEL_MAX_W


def _first_argmax(v: torch.Tensor) -> torch.Tensor:
    """Index of the maximum of ``v`` under jnp.argmax's rule: NaN is the
    maximum, and ties go to the lowest index. A 0-d device tensor; no
    host sync."""
    n = v.shape[0]
    nanmask = torch.isnan(v)
    finite = torch.where(nanmask, torch.full_like(v, -1.0), v)
    cand = torch.where(nanmask.any(), nanmask, finite == finite.max())
    idx = torch.arange(n, device=v.device)
    return torch.where(cand, idx, n).min()


def lu_panel_base_plain(a: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 (= ``blocked._panel_getrf_base``): column
    loop with argmax pivot, row + perm swap, first-bad-pivot info (that
    column divides by 1), scale, rank-1 update of the trailing block.
    Returns (lu, perm int32 with a[perm] = L·U, info int32 0-d). No host
    sync: the pivot index stays on the device."""
    hh, w = a.shape
    dev = a.device
    lu = a.clone()
    perm = torch.arange(hh, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=a.dtype, device=dev)
    for j in range(w):
        p = _first_argmax(lu[j:, j].abs()) + j
        jt = torch.full((), j, dtype=p.dtype, device=dev)
        src, dst = torch.stack([jt, p]), torch.stack([p, jt])
        lu.index_copy_(0, dst, lu.index_select(0, src))
        perm.index_copy_(0, dst, perm.index_select(0, src))
        d = lu[j, j]
        bad = torch.isnan(d) | (d == 0)
        info = torch.where((info == 0) & bad,
                           torch.full_like(info, j + 1), info)
        dsafe = torch.where(bad, one, d)
        if j + 1 < hh:
            lu[j + 1:, j] /= dsafe
            if j + 1 < w:
                lu[j + 1:, j + 1:] -= torch.outer(lu[j + 1:, j],
                                                  lu[j, j + 1:])
    return lu, perm, info


def lu_panel_base(a: torch.Tensor):
    """Pivoted LU of one (H, w) panel base → (lu, perm, info) with the
    ``_panel_getrf_base`` contract.

    Replaces ``pallas_ops.lu_panel_base`` (pallas_ops.py:442-459). The
    CUDA kernel (csrc/lu_panel.cu) is one block looping over the w
    columns; it is bound by the panel's bytes, re-read from L2 once per
    column, and by the w serial argmax steps. Bitwise equal to the plain
    version on the same input."""
    if a.ndim != 2:
        raise SlateError("lu_panel_base: expects a 2-D panel")
    if a.dtype not in _REAL:
        raise NotImplementedError(
            f"lu_panel_base: real float32/float64 only, got {a.dtype}")
    hh, w = a.shape
    if w > hh or w == 0:
        raise SlateError(f"lu_panel_base: needs 0 < w ≤ H, got {(hh, w)}")
    if a.device.type == "cpu":
        return lu_panel_base_plain(a)
    _check_cuda_args("lu_panel_base", a)
    lu = torch.empty_like(a)
    perm = torch.empty(hh, dtype=torch.int32, device=a.device)
    info = torch.empty((), dtype=torch.int32, device=a.device)
    f = _fn("lu_panel", f"slate_lu_panel_{_SUFFIX[a.dtype]}",
            [_P, _P, _P, _P, _I, _I, _P])
    with torch.cuda.device(a.device):
        rc = f(a.data_ptr(), lu.data_ptr(), perm.data_ptr(),
               info.data_ptr(), hh, w,
               torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "lu_panel", "slate_lu_error_string",
              f"lu_panel_base (H={hh}, w={w})")
    LAUNCHES["lu_panel_base"] += 1
    return lu, perm, info
