"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
gates and launch counters.

Counterpart of ``slate_tpu/ops/pallas_ops.py``: the launchers keep the
reference's names (``chol_tile``, ``lu_panel_base``, ``lu_panel_eligible``,
``qr_panel_base``, ``qr_panel_base_wide``, ``qr_panel_wide_eligible``,
``herk_lower_update``) so the call sites in ``ops/blocked.py`` map one to
one. Dispatch is by the tensor's device and nothing else:

- a CUDA tensor launches the CUDA kernel (``csrc/*.cu``, built by
  ``ops/_build.py``) or the wrapper raises — there is no environment
  switch and no fallback;
- a CPU tensor runs the plain PyTorch version beside the kernel, which
  the CPU tests hold against the reference and ``chip_smoke.py`` holds
  the kernel against on the card.

``LAUNCHES`` counts kernel launches (plain runs are not counted), so a
run can show that its main path went through the kernels;
``TYPE_LAUNCHES`` splits each count by the element type launched.

The reference's TPU gates (VMEM size, the 8-row sublane floor, real
float32 only) do not carry over: every potrf tile goes through
``chol_tile``, every panel base of width 1..128 (any height) goes through
``lu_panel_base``,
every ``panel_geqrf`` base goes through ``qr_panel_base`` (w ≤ 32) or
``qr_panel_base_wide`` (32 < w ≤ 128, w % 32 == 0), at any height, and
every real (f32, f64, bf16) ``herk_lower_rec(c, a)`` without ``b`` goes
through ``herk_lower_update`` at any n ≥ 1 and k ≥ 1, in one launch (the
reference's divisibility gates and its k-chunking at 1024 are TPU
limits). Every kernel but K5 takes float32, float64, complex64 and
complex128; K5 takes float32, float64 and bfloat16 (its own bf16
instance, as the reference's gate admits) and raises on a complex tensor
(ROADMAP Queue 1 item 3(c)). K1, K2 and P1–P4 also take bfloat16 by one
route (``_via_f32``): their float32 instance on a float32 copy, the result
rounded back to bfloat16 (perm and info unchanged) and the launch counted
under "bfloat16", as the reference factors a bf16 diagonal tile in f32 and
rounds it back; their plain versions take the same route. K3, K4 and P5
raise on bfloat16. The complex plain versions of the LU and
Cholesky kernels do their arithmetic on the real and imaginary parts
through ``cx_mul``, ``cx_div`` (Smith's scaled quotient), ``cx_div_real``
and ``cx_abs`` (hypot, NaN with a NaN part), and the kernels replay the
same formulas (csrc/cx.cuh), so K2, P2, P3 and P4 stay bitwise equal to
their plain versions in every type. The Householder kernels (K3, K4, P5)
are held to their plain versions within a tolerance, and their complex
plain versions use torch's complex arithmetic: the reflector is
LAPACK's complex larfg (``larfg``), applied as Hᴴ = I − conj(τ)·v·vᴴ.

Two multi-block designs carry the serial kernels across SMs. The panel
kernels K2 (``lu_panel_base``), K3 (``qr_panel_base``) and K4
(``qr_panel_base_wide``) are one cooperative launch each, with the grid
plan ``panel_grid_plan`` (row slabs resident in shared memory or
streamed) and one grid barrier per column; K3 and K4 share one kernel
body, K3 being its single micro-block. K1 (``chol_tile``) is one launch
of a thread-block cluster with the plan ``chol_tile_plan`` (32-row
blocks dealt cyclically to up to 8 CTAs, resident or streamed) and two
cluster barriers per 32-wide step. K5 (``herk_lower_update``) runs on
the tensor cores through warp-level ``mma.sync`` (FP64 DMMA, 3×TF32 in
float32), one block per lower tile pair of the plan ``herk_plan``.

Nine kernels have no Pallas counterpart: they replace programs the
reference fuses with ``jax.vmap``/``fori_loop``/``lax.scan`` and the port would
otherwise run as Python loops of small launches. P1
(``trtri_leaves``) inverts a stack of lower-triangular leaves of at most
64 rows, one block per leaf; P2 (``lu_nopiv_base``) is the no-pivot LU of
one square leaf of at most 64 rows, in one block, in place through the
leaf's strides (``lu_nopiv_base_inplace``); P3 (``lu_panel_batched``) is
the partial-pivot LU of every chunk of a (B, H, w) stack, one
thread-block cluster per chunk with the plan ``lu_panel_batched_plan``
(rows dealt cyclically to up to 16 CTAs, resident or streamed, row
positions swapped instead of rows, one cluster barrier per column), so
one launch is one round of the CALU tournament and one panel of the
batched LU. The batched small-problem engine adds P4
(``chol_tile_batched``: the guarded Cholesky of every tile of a (B, s, s)
stack, one warp per item) and P5 (``qr_panel_batched``: the Householder
QR of every panel of a (B, H, w) stack, its rows owned by the threads of
a warp or a CTA with the plan ``qr_panel_batched_plan``). The incremental
updates (``linalg/update.py``) add P6 (``chol_update_sweep``: a rank-k
Cholesky up/downdate in place, row-block CTAs in one cooperative launch),
P7 (``qr_append_build``: the structured QR of [R; U]) and P8
(``qr_append_apply``: the appended reflectors applied to a solve's
right-hand sides), each bit for bit its plain version. The divide &
conquer eigensolver (``linalg/stedc.py``) adds P9 (``secular_roots``: the
roots of a merge's secular equation, a root's pole sums split over the
lanes of a warp with the plan ``secular_roots_plan``, float64 only),
within a stated tolerance of its plain version.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..core.exceptions import SlateError
from . import _build

LAUNCHES: Dict[str, int] = {"chol_tile": 0, "lu_panel_base": 0,
                            "qr_panel_base": 0, "qr_panel_base_wide": 0,
                            "herk_lower_update": 0, "trtri_leaves": 0,
                            "lu_nopiv_base": 0, "lu_panel_batched": 0,
                            "chol_tile_batched": 0, "qr_panel_batched": 0,
                            "chol_update_sweep": 0, "qr_append_build": 0,
                            "qr_append_apply": 0, "secular_roots": 0}

TYPE_LAUNCHES: Dict[str, Dict[str, int]] = {k: {} for k in LAUNCHES}

# the element types of the kernels' C entry points but K5's
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128"}
# K5's own: the real types and bfloat16
_K5_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
              torch.bfloat16: "bf16"}
# where the complex instances of the real-only kernel are queued
_COMPLEX_LATER = {"herk_lower_update": "ROADMAP Queue 1 item 3(c)"}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        TYPE_LAUNCHES[k] = {}


# the element type a launch is counted under while a bf16 route runs its
# float32 instance (None: the launched tensor's own)
_COUNT_AS: contextvars.ContextVar = contextvars.ContextVar("count_as",
                                                           default=None)


def _count(name: str, x: torch.Tensor):
    """One launch of kernel ``name`` on ``x``'s element type."""
    LAUNCHES[name] += 1
    by_type = TYPE_LAUNCHES[name]
    dt = _COUNT_AS.get() or str(x.dtype).split(".")[1]
    by_type[dt] = by_type.get(dt, 0) + 1


def _upcast(x: torch.Tensor) -> torch.Tensor:
    """A bf16 route's input copy: ``x`` in float32 (exact)."""
    return x.float()


def _round_back(out):
    """A result of a float32 instance, its floating tensors rounded to
    bfloat16 (perms and infos unchanged)."""
    if isinstance(out, tuple):
        return tuple(_round_back(o) for o in out)
    return out.to(torch.bfloat16) if out.is_floating_point() else out


@contextlib.contextmanager
def _counted_as_bf16():
    """Launches inside are counted under "bfloat16" (a bf16 route running
    its float32 instance)."""
    token = _COUNT_AS.set("bfloat16")
    try:
        yield
    finally:
        _COUNT_AS.reset(token)


def _via_f32(fn):
    """The bf16 route of K1, K2, P1, P3 and P4 and of their plain
    versions: a bfloat16 first argument runs ``fn``'s float32 instance on
    a float32 copy (exact: every bf16 value is a float32 one) and its
    result comes back rounded to bfloat16, its launch counted under
    "bfloat16". These kernels are bound by their serial column steps, not
    by operations, so a native bf16 body would save only the copies (6
    bytes per entry); the O(n³) trailing gemms around them stay bf16.
    Every other type goes to ``fn`` unchanged."""

    @functools.wraps(fn)
    def wrapped(x, *args, **kwargs):
        if x.dtype != torch.bfloat16:
            return fn(x, *args, **kwargs)
        with _counted_as_bf16():
            return _round_back(fn(_upcast(x), *args, **kwargs))

    return wrapped


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn(lib: str, sym: str, argtypes, restype=ctypes.c_int):
    """A C entry point with argtypes declared: pointers and the stream
    as c_void_p (a plain int argument would cut a 64-bit pointer), sizes
    as c_int, row strides as c_longlong. Launchers return a cudaError_t."""
    f = _fns.get(sym)
    if f is None:
        f = getattr(_build.load(lib), sym)
        f.argtypes = list(argtypes)
        f.restype = restype
        _fns[sym] = f
    return f


# the build unit (csrc/<unit>.cu) of the kernels a Session preloads
_UNIT = {"chol_update_sweep": "chol_update", "qr_append_build": "qr_append",
         "qr_append_apply": "qr_append"}


def preload(name: str):
    """Build (at first use) and load the library of kernel ``name`` now,
    off a request's path."""
    _build.load(_UNIT[name])


def _check_cuda_args(name: str, a: torch.Tensor):
    if a.device.type != "cuda":
        raise SlateError(f"{name}: unsupported device {a.device}")
    if not a.is_contiguous():
        raise SlateError(f"{name}: expects a contiguous row-major tensor")


def _check_real(name: str, x: torch.Tensor):
    """The gate of the real-only kernel (K5): float32, float64 and
    bfloat16."""
    if x.dtype not in _K5_SUFFIX:
        raise NotImplementedError(
            f"{name}: real float32/float64/bfloat16 only, got {x.dtype} "
            f"(complex: {_COMPLEX_LATER[name]})")


def _check_type(name: str, x: torch.Tensor):
    """The gate of the kernels with complex instances (all but K5)."""
    if x.dtype not in _SUFFIX:
        raise NotImplementedError(
            f"{name}: float32/float64/complex64/complex128 only, got "
            f"{x.dtype}")


def _resolved(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a conjugate or negative view's bits written out, as the
    kernels read raw memory."""
    return x.resolve_conj().resolve_neg()


# ---------------------------------------------------------------------------
# Complex arithmetic of the plain versions, part by part
# ---------------------------------------------------------------------------
# Torch's complex product and quotient do not fix their rounding (its CPU
# and CUDA paths differ, and nvcc contracts c10::complex's products into
# FMAs), so the complex plain versions spell out every real operation on
# the parts, each rounded apart, and the kernels replay them
# (csrc/cx.cuh). On a real tensor each helper is the one torch operation
# it replaces.

def _parts(x: torch.Tensor):
    v = torch.view_as_real(x.resolve_conj())
    return v[..., 0], v[..., 1]


def cx_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b (broadcast): (ar·br − ai·bi) + i·(ar·bi + ai·br). A conjugate
    view is read with its imaginary part negated."""
    if not a.is_complex():
        return a * b
    ar, ai = _parts(a)
    br, bi = _parts(b)
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)


def cx_abs(x: torch.Tensor) -> torch.Tensor:
    """|x|: abs, and for a complex x hypot(re, im), NaN where either part
    is NaN. That is the reference's ``jnp.abs`` (XLA's complex abs), whose
    |inf + nan·i| is NaN where IEEE hypot gives inf."""
    if not x.is_complex():
        return x.abs()
    re, im = _parts(x)
    return torch.where(torch.isnan(re) | torch.isnan(im),
                       torch.full_like(re, math.nan), torch.hypot(re, im))


def bad_pivot(d: torch.Tensor) -> torch.Tensor:
    """The LU kernels' bad pivot, the reference's isnan(|d|) | (|d| == 0)
    with ``cx_abs``'s modulus (inf + nan·i is bad)."""
    m = cx_abs(d)
    return torch.isnan(m) | (m == 0)


def cx_divisor(d: torch.Tensor):
    """Smith's ratio and scale of the divisors ``d``, made once per
    divisor as c10::complex's operator/= (and numpy) does:
    |re| ≥ |im|: rat = im/re, scl = 1/(re + im·rat); otherwise rat =
    re/im, scl = 1/(im + re·rat); both parts zero is its own case. A real
    ``d`` is its own divisor."""
    if not d.is_complex():
        return d
    c, e = _parts(d)
    ac, ae = c.abs(), e.abs()
    big = ac >= ae
    one = torch.ones_like(c)
    rat = torch.where(big, e / c, c / e)
    scl = one / torch.where(big, c + e * rat, e + c * rat)
    return big, (ac == 0) & (ae == 0), rat, scl, ac, ae


def cx_div(a: torch.Tensor, dv) -> torch.Tensor:
    """a / d for ``dv = cx_divisor(d)`` (broadcast), Smith's form:
    (ar + ai·rat)·scl + i·(ai − ar·rat)·scl where |re d| ≥ |im d|,
    (ar·rat + ai)·scl + i·(ai·rat − ar)·scl otherwise, and ar/|re d| +
    i·ai/|im d| for d = 0."""
    if not a.is_complex():
        return a / dv
    big, zero, rat, scl, ac, ae = dv
    ar, ai = _parts(a)
    re = torch.where(big, (ar + ai * rat) * scl, (ar * rat + ai) * scl)
    im = torch.where(big, (ai - ar * rat) * scl, (ai * rat - ar) * scl)
    return torch.complex(torch.where(zero, ar / ac, re),
                         torch.where(zero, ai / ae, im))


def cx_div_real(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """a / r for a real r (broadcast), the parts divided apart."""
    if not a.is_complex():
        return a / r
    ar, ai = _parts(a)
    return torch.complex(ar / r, ai / r)


def _raise_on(rc: int, lib: str, err_sym: str, what: str):
    if rc:
        msg = _fn(lib, err_sym, [_I], ctypes.c_char_p)(rc).decode()
        raise SlateError(f"{what}: CUDA launch failed ({rc}: {msg})")


def _on_device(x: torch.Tensor, f, *args) -> int:
    """``f(*args, stream)`` with the raw handle of the current stream of
    ``x``'s device, entering that device only when it is not already the
    current one (no context manager and no Stream object on the common
    path: a few µs of host time per launch)."""
    dev = x.device.index
    if dev == torch.cuda.current_device():
        return f(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return f(*args, torch._C._cuda_getCurrentRawStream(dev))


# ---------------------------------------------------------------------------
# The grid plan of the multi-block panel kernels (K2, K3, K4)
# ---------------------------------------------------------------------------

PANEL_MIN_ROWS = 32          # the fewest rows a block of a tall panel gets
PANEL_SMEM_LIMIT = 232_448   # 227 KB: the most shared memory a block can have
PANEL_SMEM_RESERVE = 49_152  # K2's own shared memory beside the slab
# K3/K4's own shared memory beside the slab, in elements of the panel's
# type (csrc/qr_panel.cu kFixed: w_row, the taus, the per-warp partials,
# the larfg scalars, G, T and Y/Z): 45,888 B in float64 and complex64,
# 91,776 B in complex128
QR_PANEL_FIXED_ELEMS = 5_736


class PanelPlan(NamedTuple):
    """G blocks of ``rows`` rows each (the last one ragged); ``resident``:
    each block holds its slab in shared memory, else it streams its rows
    from global memory."""
    blocks: int
    rows: int
    resident: bool

    @property
    def mode(self) -> str:
        return "resident" if self.resident else "streaming"


def panel_grid_plan(hh: int, w: int, itemsize: int, n_sm: int,
                    reserve: int) -> PanelPlan:
    """The grid of K2, K3 and K4 for an (hh, w) panel of ``itemsize``-byte
    elements on a card with ``n_sm`` SMs: at most one block per SM, each
    owning a contiguous slab of at least PANEL_MIN_ROWS rows (fewer only
    when the whole panel is shorter), so a small panel takes few blocks.
    A slab that fits PANEL_SMEM_LIMIT with the kernel's own ``reserve``
    bytes beside it is resident (K2's PANEL_SMEM_RESERVE; K3/K4's
    QR_PANEL_FIXED_ELEMS × itemsize). Pure: the C launchers check it,
    the CPU tests hold it."""
    if hh < 1 or w < 1 or n_sm < 1:
        raise SlateError(f"panel_grid_plan: bad shape {(hh, w)} or SM count "
                         f"{n_sm}")
    rows = min(hh, max(PANEL_MIN_ROWS, -(-hh // n_sm)))
    blocks = -(-hh // rows)
    resident = rows * w * itemsize + reserve <= PANEL_SMEM_LIMIT
    return PanelPlan(blocks, rows, resident)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def panel_plan_for(a: torch.Tensor, reserve: int) -> PanelPlan:
    """The plan a panel kernel with ``reserve`` bytes of its own shared
    memory launches with for the CUDA tensor ``a``."""
    hh, w = a.shape
    return panel_grid_plan(hh, w, a.element_size(),
                           _sm_count(a.device.index), reserve)


def _grid_launch(lib: str, sym: str, err_sym: str, scratch_bytes: int,
                 a: torch.Tensor, outs, plan: PanelPlan, what: str):
    """One cooperative launch of a panel kernel: the scratch and the zeroed
    grid-barrier counter are allocated here (the kernel allocates
    nothing); a refused launch raises."""
    hh, w = a.shape
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=a.device)
    bar = torch.zeros(1, dtype=torch.int32, device=a.device)
    f = _fn(lib, sym, [_P] * (1 + len(outs)) + [_I] * 5 + [_P, _P, _P])
    with torch.cuda.device(a.device):
        rc = f(a.data_ptr(), *(x.data_ptr() for x in outs), hh, w,
               plan.blocks, plan.rows, int(plan.resident), scratch.data_ptr(),
               bar.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, lib, err_sym, f"{what} (H={hh}, w={w}, plan {plan})")


# ---------------------------------------------------------------------------
# K1: Cholesky of one diagonal tile
# ---------------------------------------------------------------------------

@_via_f32
def chol_tile_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: right-looking column loop over the LOWER
    triangle of ``a`` (A = L·Lᴴ); strict upper of the result zeroed. The
    pivot is the real part of the diagonal entry, as the reference's
    ``jnp.real(d[j, j])``, so L's diagonal is real; a non-positive or NaN
    pivot makes that diagonal entry NaN and poisons everything right of
    and below it. No host sync."""
    b = a.shape[0]
    l = torch.tril(_resolved(a))
    rdt = l.real.dtype
    nan = torch.full((), math.nan, dtype=rdt, device=a.device)
    for j in range(b):
        d = l[j, j].real
        s = torch.where(d > 0, d.sqrt(), nan)
        l[j, j] = s
        if j + 1 < b:
            l[j + 1:, j] = cx_div_real(l[j + 1:, j], s)
            col = l[j + 1:, j]
            l[j + 1:, j + 1:] -= torch.outer(col, col.conj())
    return torch.tril(l)


CHOL_STEP = 32        # K1's step width and row-block height
CHOL_MAX_CLUSTER = 8  # the portable cluster size


class CholPlan(NamedTuple):
    """K1's cluster of ``ctas`` CTAs; the tile's ``block_rows``-row blocks
    are dealt to them cyclically. ``resident``: each CTA holds its row
    blocks in shared memory (the whole tile when ``ctas`` is 1), else
    the rows stay in ``out`` and are read through L2."""
    ctas: int
    block_rows: int
    resident: bool

    @property
    def mode(self) -> str:
        return "resident" if self.resident else "streaming"

    def row_blocks(self, cta: int, b: int):
        """The [lo, hi) row ranges CTA ``cta`` owns in a b × b tile."""
        nblk = -(-b // self.block_rows)
        return [(g * self.block_rows, min(b, (g + 1) * self.block_rows))
                for g in range(cta, nblk, self.ctas)]


def chol_tile_smem_bytes(b: int, itemsize: int, ctas: int,
                         resident: bool) -> int:
    """Shared memory of one K1 CTA (csrc/chol_tile.cu ``smem_elems``, held
    against it by ``chol_tile_launch_smem`` in ``chip_smoke.py``):
    L11 with the reciprocals of its diagonal (32 × 33); resident, also
    the CTA's row blocks (the whole tile when there is one CTA) at a row
    stride of b + 1 and, beside them when there is more than one CTA, the
    panel copy ((blocks − 1)·32 rows × 33)."""
    nblk = -(-b // CHOL_STEP)
    elems = CHOL_STEP * (CHOL_STEP + 1)
    if resident and ctas == 1:
        elems += nblk * CHOL_STEP * (b + 1)
    elif resident:
        elems += (-(-nblk // ctas) * CHOL_STEP * (b + 1)
                  + (nblk - 1) * CHOL_STEP * (CHOL_STEP + 1))
    return elems * itemsize


def chol_tile_plan(b: int, itemsize: int) -> CholPlan:
    """K1's plan for a b × b tile of ``itemsize``-byte elements: one CTA
    holding the whole tile when it fits a block's shared memory
    (PANEL_SMEM_LIMIT), else a cluster of min(8, blocks) CTAs, resident
    when each CTA's row blocks fit with the panel copy beside them,
    else streaming. Pure: the C launcher checks it, the CPU tests hold
    it."""
    if b < 1 or itemsize < 1:
        raise SlateError(f"chol_tile_plan: bad tile {b} or itemsize "
                         f"{itemsize}")
    if chol_tile_smem_bytes(b, itemsize, 1, True) <= PANEL_SMEM_LIMIT:
        return CholPlan(1, CHOL_STEP, True)
    ctas = min(CHOL_MAX_CLUSTER, -(-b // CHOL_STEP))
    return CholPlan(ctas, CHOL_STEP, chol_tile_smem_bytes(
        b, itemsize, ctas, True) <= PANEL_SMEM_LIMIT)


def chol_tile_launch_smem(b: int, itemsize: int, plan: CholPlan) -> int:
    """The shared memory per CTA that the C launcher sizes ``plan`` with
    (csrc/chol_tile.cu ``slate_chol_tile_smem_bytes``); ``chip_smoke.py``
    holds ``chol_tile_smem_bytes`` against it. Needs the built kernel."""
    return _fn("chol_tile", "slate_chol_tile_smem_bytes", [_I] * 4,
               ctypes.c_longlong)(b, plan.ctas, int(plan.resident), itemsize)


@_via_f32
def chol_tile(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one (b, b) tile (strict upper zeroed).

    Replaces ``pallas_ops.chol_tile`` (pallas_ops.py:337-348). The CUDA
    kernel (csrc/chol_tile.cu) is one launch of a thread-block cluster
    (``chol_tile_plan``): a right-looking Cholesky in 32-wide steps, the
    32-row blocks dealt cyclically to the CTAs and held in shared memory
    (or streamed through L2), every CTA factoring the diagonal block
    redundantly, two cluster barriers per step. It is bound by those
    b/32 serial steps. Any b ≥ 1 goes through it; a plan the card cannot
    schedule raises. Reads only the lower triangle. Types: float32,
    float64, complex64 and complex128 (the complex instances take L21 =
    A21·L11⁻ᴴ and A22 −= L21·L21ᴴ); equal to the plain version up to the
    order of its sums."""
    _check_type("chol_tile", a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise SlateError(f"chol_tile: expects a square tile, got "
                         f"{tuple(a.shape)}")
    if a.device.type == "cpu":
        return chol_tile_plain(a)
    a = _resolved(a)
    _check_cuda_args("chol_tile", a)
    b = a.shape[0]
    plan = chol_tile_plan(b, a.element_size())
    out = torch.empty_like(a)
    f = _fn("chol_tile", f"slate_chol_tile_{_SUFFIX[a.dtype]}",
            [_P, _P, _I, _I, _I, _P])
    with torch.cuda.device(a.device):
        rc = f(a.data_ptr(), out.data_ptr(), b, plan.ctas, int(plan.resident),
               torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "chol_tile", "slate_chol_error_string",
              f"chol_tile (b={b}, plan {plan})")
    _count("chol_tile", out)
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


@_via_f32
def lu_panel_base_plain(a: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 (= ``blocked._panel_getrf_base``): column
    loop with argmax pivot on the modulus, row + perm swap,
    first-bad-pivot info (``bad_pivot``; that column divides by 1),
    scale, rank-1 update of the trailing block. Returns (lu, perm int32
    with a[perm] = L·U, info int32 0-d). No host sync: the pivot index
    stays on the device."""
    hh, w = a.shape
    dev = a.device
    lu = _resolved(a).clone()
    perm = torch.arange(hh, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=a.dtype, device=dev)
    for j in range(w):
        p = _first_argmax(cx_abs(lu[j:, j])) + j
        jt = torch.full((), j, dtype=p.dtype, device=dev)
        src, dst = torch.stack([jt, p]), torch.stack([p, jt])
        lu.index_copy_(0, dst, lu.index_select(0, src))
        perm.index_copy_(0, dst, perm.index_select(0, src))
        d = lu[j, j]
        bad = bad_pivot(d)
        info = torch.where((info == 0) & bad,
                           torch.full_like(info, j + 1), info)
        dsafe = cx_divisor(torch.where(bad, one, d))
        if j + 1 < hh:
            lu[j + 1:, j] = cx_div(lu[j + 1:, j], dsafe)
            if j + 1 < w:
                lu[j + 1:, j + 1:] -= cx_mul(lu[j + 1:, j, None],
                                             lu[j, None, j + 1:])
    return lu, perm, info


@_via_f32
def lu_panel_base(a: torch.Tensor):
    """Pivoted LU of one (H, w) panel base → (lu, perm, info) with the
    ``_panel_getrf_base`` contract.

    Replaces ``pallas_ops.lu_panel_base`` (pallas_ops.py:442-459). The
    CUDA kernel (csrc/lu_panel.cu) is one cooperative launch of G blocks
    (``panel_grid_plan``), each owning a row slab held in shared memory
    or streamed, with one grid barrier per column: it is bound by those
    w serial steps, not by the panel's bytes, which cross HBM once each
    way (PERF.md has its times beside the one-block design's). Bitwise
    equal to the plain version on the same input: lu, perm and info, in
    float32, float64, complex64 and complex128."""
    if a.ndim != 2:
        raise SlateError("lu_panel_base: expects a 2-D panel")
    _check_type("lu_panel_base", a)
    hh, w = a.shape
    if w > hh or w == 0:
        raise SlateError(f"lu_panel_base: needs 0 < w ≤ H, got {(hh, w)}")
    if a.device.type == "cpu":
        return lu_panel_base_plain(a)
    a = _resolved(a)
    _check_cuda_args("lu_panel_base", a)
    plan = panel_plan_for(a, PANEL_SMEM_RESERVE)
    lu = torch.empty_like(a)
    perm = torch.empty(hh, dtype=torch.int32, device=a.device)
    info = torch.empty((), dtype=torch.int32, device=a.device)
    nbytes = _fn("lu_panel", "slate_lu_panel_scratch_bytes", [_I, _I, _I],
                 ctypes.c_longlong)(plan.blocks, w, a.element_size())
    _grid_launch("lu_panel", f"slate_lu_panel_{_SUFFIX[a.dtype]}",
                 "slate_lu_error_string", nbytes, a, (lu, perm, info), plan,
                 "lu_panel_base")
    _count("lu_panel_base", lu)
    return lu, perm, info


# ---------------------------------------------------------------------------
# K3 and K4: Householder QR of one tall panel base
# ---------------------------------------------------------------------------

QR_PANEL_MAX_W = 128
QR_WIDE_MB = 32  # K4's micro-block width and K3's widest panel


def qr_panel_wide_eligible(w: int) -> bool:
    """Whether ``panel_geqrf`` hands a (non-base) panel to
    ``qr_panel_base_wide`` whole: 32 < w ≤ 128 with w % 32 == 0, at any
    height."""
    return QR_WIDE_MB < w <= QR_PANEL_MAX_W and w % QR_WIDE_MB == 0


def abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|², real: x·x, and re² + im² for a complex x."""
    if not x.is_complex():
        return x * x
    return x.real * x.real + x.imag * x.imag


def larfg(alpha: torch.Tensor, sig: torch.Tensor):
    """Scalars of the Householder reflector of [alpha; x] with the real
    sig = ‖x‖² (the reference's ``blocked._larfg``): (beta_out, tau,
    scale) with v = [1; x·scale], H = I − tau·v·vᴴ and Hᴴ·[alpha; x] =
    [beta; 0]: anorm = √(|alpha|² + sig), beta = +anorm if
    real(alpha) ≤ 0 else −anorm (real, in alpha's type),
    tau = (beta − alpha)/beta, scale = 1/(alpha − beta). A column is
    degenerate when sig = 0 and imag(alpha) = 0 (always so for a real
    alpha with a zero tail): tau = 0, scale = 0 and alpha kept (H = I).
    A zero tail under an alpha with an imaginary part is not degenerate:
    tau ≠ 0 rotates alpha onto the real beta. Works elementwise on
    batches of scalars; no host sync; NaN propagates."""
    one, zero = torch.ones_like(alpha), torch.zeros_like(alpha)
    anorm = torch.sqrt(abs2(alpha) + sig)
    beta = torch.where(alpha.real <= 0, anorm, -anorm).to(alpha.dtype)
    degen = sig == 0
    if alpha.is_complex():
        degen = degen & (alpha.imag == 0)
    beta_safe = torch.where(degen | (beta == 0), one, beta)
    denom_safe = torch.where(degen, one, alpha - beta)
    tau = torch.where(degen, zero, (beta - alpha) / beta_safe)
    scale = torch.where(degen, zero, 1.0 / denom_safe)
    return torch.where(degen, alpha, beta), tau, scale


def _householder_column(vr: torch.Tensor, taus: torch.Tensor, j: int,
                        hi: int):
    """Column j of the panel QR, IN PLACE on ``vr``: larfg of the
    column, then Hᴴ = I − conj(τ)·v·vᴴ applied to the lanes j < c < hi
    (w_row = vᴴ·A)."""
    col = vr[j:, j]
    beta, tau, scale = larfg(col[0], abs2(col[1:]).sum())
    v = col.clone()
    v[1:] *= scale
    v[0] = 1
    if j + 1 < hi:
        w_row = v.conj() @ vr[j:, j + 1:hi]
        vr[j:, j + 1:hi] -= torch.outer(tau.conj() * v, w_row)
    vr[j + 1:, j] = v[1:]
    vr[j, j] = beta
    taus[j] = tau


def larft_columnwise(g: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Upper-triangular T of the compact-WY form I − V·T·Vᴴ from the Gram
    matrix G = VᴴV and the taus, by LAPACK's forward column recurrence
    T[:i, i] = −τᵢ·(T[:i, :i]·G[:i, i]), T[i, i] = τᵢ (the reference's
    ``_larft_base``; K4 computes its T the same way)."""
    w = taus.shape[0]
    t = torch.zeros((w, w), dtype=g.dtype, device=g.device)
    for i in range(w):
        t[:i, i] = -taus[i] * (t[:i, :i] @ g[:i, i])
        t[i, i] = taus[i]
    return t


def qr_panel_base_plain(a: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3 (= ``blocked._panel_geqrf_base``): one larfg
    and one rank-1 reflector update per column. Returns (vr, taus):
    beta on the diagonal, v tails below, R above; taus (w,). A conjugate
    view is read with its conjugate."""
    vr = _resolved(a).clone()
    w = a.shape[1]
    taus = torch.zeros(w, dtype=a.dtype, device=a.device)
    for j in range(w):
        _householder_column(vr, taus, j, w)
    return vr, taus


def qr_panel_base_wide_plain(a: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4, with the kernel's association: per 32-column
    micro-block, K3's column loop confined to the micro lanes, then one
    compact-WY update C ← C − V·(Tᴴ·(Vᴴ·C)) of the lanes to its right,
    with T = larft_columnwise(VᴴV, taus) of the micro-block alone."""
    vr = _resolved(a).clone()
    w = a.shape[1]
    taus = torch.zeros(w, dtype=a.dtype, device=a.device)
    for m0 in range(0, w, QR_WIDE_MB):
        hi = m0 + QR_WIDE_MB
        for j in range(m0, hi):
            _householder_column(vr, taus, j, hi)
        if hi < w:
            v = torch.tril(vr[m0:, m0:hi], -1)
            v.diagonal().fill_(1)
            t = larft_columnwise(v.mH @ v, taus[m0:hi])
            c = vr[m0:, hi:]
            c -= v @ (t.mH @ (v.mH @ c))
    return vr, taus


def _check_qr_panel(name: str, a: torch.Tensor, ok_width):
    if a.ndim != 2:
        raise SlateError(f"{name}: expects a 2-D panel")
    _check_type(name, a)
    hh, w = a.shape
    if w > hh or not ok_width(w):
        raise SlateError(f"{name}: width {w} out of range for an "
                         f"{(hh, w)} panel")


def _qr_panel_launch(a: torch.Tensor, name: str):
    """One cooperative launch of csrc/qr_panel.cu's kernel (K3 and K4
    alike) with the panel plan at the QR kernels' own shared memory; a
    refused launch raises."""
    a = _resolved(a)
    _check_cuda_args(name, a)
    plan = panel_plan_for(a, QR_PANEL_FIXED_ELEMS * a.element_size())
    vr = torch.empty_like(a)
    taus = torch.empty(a.shape[1], dtype=a.dtype, device=a.device)
    nbytes = _fn("qr_panel", "slate_qr_panel_scratch_bytes", [_I, _I, _I],
                 ctypes.c_longlong)(plan.blocks, a.shape[1], a.element_size())
    _grid_launch("qr_panel", f"slate_qr_panel_{_SUFFIX[a.dtype]}",
                 "slate_qr_error_string", nbytes, a, (vr, taus), plan, name)
    _count(name, vr)
    return vr, taus


def qr_panel_base(a: torch.Tensor):
    """Householder QR of one (H, w) panel base, 0 < w ≤ min(H, 32),
    → (vr, taus) with the ``_panel_geqrf_base`` contract.

    Replaces ``pallas_ops.qr_panel_base`` (pallas_ops.py:682-697). The
    CUDA kernel (csrc/qr_panel.cu) is K4's at one micro-block: one
    cooperative launch of G blocks with the panel plan, each owning a row slab
    held in shared memory or streamed, one grid barrier per column (the G
    blocks' partial sums reduced in one fixed order, so every block takes
    the same reflector). It is bound by those w serial steps; the panel
    crosses HBM once each way. Equal to the plain version up to the order
    of its H-long reductions, in float32, float64, complex64 and
    complex128."""
    _check_qr_panel("qr_panel_base", a, lambda w: 0 < w <= QR_WIDE_MB)
    if a.device.type == "cpu":
        return qr_panel_base_plain(a)
    return _qr_panel_launch(a, "qr_panel_base")


def qr_panel_base_wide(a: torch.Tensor):
    """Householder QR of one wide (H, w) panel, 32 < w ≤ 128 and
    w % 32 == 0, in 32-column micro-blocks with a compact-WY update
    between them → (vr, taus), K3's contract.

    Replaces ``pallas_ops.qr_panel_base_wide`` (pallas_ops.py:662-679).
    The CUDA kernel (csrc/qr_panel.cu, K3's) is one cooperative launch of
    G blocks with the panel plan, each owning a row slab: one grid barrier per
    column and two per compact-WY update. It is bound by those serial
    steps; the panel crosses HBM once each way (PERF.md has its times
    beside the one-block design's). Equal to ``qr_panel_base_wide_plain``
    up to the order of its H-long sums, and to the unblocked column loop
    (``qr_panel_base_plain``) to tolerance (reassociated trailing
    arithmetic). Types: K3's."""
    _check_qr_panel("qr_panel_base_wide", a, qr_panel_wide_eligible)
    if a.device.type == "cpu":
        return qr_panel_base_wide_plain(a)
    return _qr_panel_launch(a, "qr_panel_base_wide")


# ---------------------------------------------------------------------------
# K5: lower-triangle rank-k update
# ---------------------------------------------------------------------------

HERK_TILE = 128        # the kernel's widest output tile edge
HERK_SMALL_TILE = 64   # its edge where 128-wide pairs fill few waves
HERK_CHUNK_BYTES = 128  # k-depth of one staged chunk, in bytes
HERK_PAD = 4           # shared row padding, in elements, at least 16 bytes
HERK_WIDE_WAVES = 4    # 128-wide tiles need this many waves of pairs
# K5's entrywise check (chip_smoke.py): on the lower triangle
# |K5 − C₆₄|ᵢⱼ ≤ HERK_ENTRY_C·ε·(|C| + |A|·|A|ᵀ)ᵢⱼ, C₆₄ the float64
# result (in float64, the plain version). It tells 3×TF32 from 1×TF32,
# which a global tolerance of 4·ε·√k cannot (tests/test_torch_herk.py).
HERK_ENTRY_C = 32.0


class HerkPlan(NamedTuple):
    """K5's block shape: ``tile`` × ``tile`` output tiles, one block of
    ``warps`` warps each, a ring of ``stages`` staged k-chunks of both
    row panels (``smem_bytes`` of shared memory), registers bounded for
    ``blocks_per_sm`` resident blocks."""
    tile: int
    warps: int
    stages: int
    blocks_per_sm: int
    smem_bytes: int

    def pairs(self, n: int) -> int:
        """The lower tile pairs of an (n, n) C: the launch's blocks."""
        nt = -(-n // self.tile)
        return nt * (nt + 1) // 2


def herk_plan(n: int, itemsize: int, n_sm: int) -> HerkPlan:
    """K5's plan for an (n, n) C of ``itemsize``-byte elements on a card
    with ``n_sm`` SMs (csrc/herk_lower.cu ``herk_plan_of``, held against
    it by ``chip_smoke.py``): 128-wide tiles (8 warps of 64 × 32, 3
    stages, one block per SM) where their pairs fill at least
    HERK_WIDE_WAVES waves, else 64-wide ones (4 warps of 32 × 32, 2
    stages, 4 blocks per SM), so that n = 2048 on 132 SMs is 528 pairs,
    one full wave. Each stage holds the two panels' rows at
    HERK_CHUNK_BYTES of k plus a pad of HERK_PAD elements or 16 bytes,
    whichever is more (8 bfloat16 elements: a row stays 16-byte aligned
    for the 16-byte copies and the m16n8k16 fragment reads hit 32
    banks), so a bfloat16 stage holds twice the k of a float32 one in
    the same bytes. Pure: the CPU tests hold it."""
    if n < 1 or itemsize not in (2, 4, 8) or n_sm < 1:
        raise SlateError(f"herk_plan: bad n {n}, itemsize {itemsize} or SM "
                         f"count {n_sm}")
    nt = -(-n // HERK_TILE)
    if nt * (nt + 1) // 2 >= HERK_WIDE_WAVES * n_sm:
        tile, warps, stages, blocks = HERK_TILE, 8, 3, 1
    else:
        tile, warps, stages, blocks = HERK_SMALL_TILE, 4, 2, 4
    pad = max(HERK_PAD, 16 // itemsize)
    row = (HERK_CHUNK_BYTES // itemsize + pad) * itemsize
    return HerkPlan(tile, warps, stages, blocks, stages * 2 * tile * row)


def herk_plan_for(c: torch.Tensor) -> HerkPlan:
    """The plan K5 launches with for the CUDA tensor ``c``."""
    return herk_plan(c.shape[0], c.element_size(), _sm_count(c.device.index))


def herk_launch_plan(n: int, itemsize: int) -> Tuple[HerkPlan, int]:
    """The plan the C launcher takes for (n, itemsize) on the current
    device (csrc/herk_lower.cu ``slate_herk_plan``) and the blocks per SM
    the card schedules for it; ``chip_smoke.py`` holds ``herk_plan``
    against both. Needs the built kernel."""
    out = (ctypes.c_int * 6)()
    rc = _fn("herk_lower", "slate_herk_plan", [_I, _I, _P])(
        n, itemsize, ctypes.addressof(out))
    _raise_on(rc, "herk_lower", "slate_herk_error_string",
              f"herk_launch_plan (n={n}, itemsize={itemsize})")
    return HerkPlan(*out[:5]), out[5]


def herk_lower_update_plain(c: torch.Tensor, a: torch.Tensor,
                            tile: int = HERK_TILE) -> torch.Tensor:
    """Plain version of K5, the Pallas kernel's step per lower tile pair
    (i ≥ j): C[i, j] −= Aᵢ·Aⱼᵀ, IN PLACE on ``c`` (any strides), with the
    diagonal tiles masked to row ≥ col so the strict upper triangle of
    ``c`` is left bitwise unchanged. Returns ``c``. ``tile`` is the
    kernel's plan tile where the two are compared (``herk_plan``); it
    changes only which products cuBLAS is handed, not the k-long sums.
    In bfloat16 the product is taken in float32 and rounded to bfloat16
    before the bfloat16 subtraction, the TPU kernel's own rounding
    (pallas_ops.py:113, ``cin − prod.astype(out dtype)``)."""
    n = c.shape[0]
    low = c.dtype == torch.bfloat16
    for i0 in range(0, n, tile):
        ai = a[i0:i0 + tile].float() if low else a[i0:i0 + tile]
        for j0 in range(0, i0 + 1, tile):
            ct = c[i0:i0 + tile, j0:j0 + tile]
            aj = a[j0:j0 + tile]
            upd = ai @ (aj.float() if low else aj).mT
            if low:
                upd = upd.to(c.dtype)
            if i0 == j0:
                lower = torch.ones_like(ct, dtype=torch.bool).tril()
                ct.copy_(torch.where(lower, ct - upd, ct))
            else:
                ct.sub_(upd)
    return c


def _row_stride(x: torch.Tensor) -> int:
    return x.stride(0) if x.shape[0] > 1 else max(x.shape[1], 1)


def herk_lower_update(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """C ← C − A·Aᵀ on the lower triangle of the (n, n) ``c``, IN PLACE,
    for an (n, k) ``a``; returns ``c``. The strict upper triangle of
    ``c`` is left bitwise unchanged. ``c`` and ``a`` must not overlap.

    Replaces ``pallas_ops.herk_lower_update`` (pallas_ops.py:136-170, the
    call at 127). The CUDA kernel (csrc/herk_lower.cu) runs one block per
    lower tile pair of ``herk_plan`` (128- or 64-wide) and streams the
    whole k in one launch through the tensor cores (mma.sync: FP64 DMMA
    in float64, 3×TF32 in float32, no 1×TF32 path, and in bfloat16
    m16n8k16 bf16 atoms with float32 accumulation, the product rounded to
    bfloat16 before the bfloat16 subtraction); it is bound by operations
    (n(n+1)·k flops). On the card both tensors need a unit column stride;
    the row strides are passed, so ``c`` may be a view of a larger
    matrix. Equal to the plain version up to the order of its k-long sums
    and, in float32, the 3×TF32 split's error (about 2⁻²² of |a|·|b| per
    product); in bfloat16 that order can move the rounded product by one
    bfloat16 unit."""
    _check_real("herk_lower_update", c)
    if a.dtype != c.dtype:
        raise SlateError(f"herk_lower_update: dtypes differ ({c.dtype}, "
                         f"{a.dtype})")
    if (c.ndim != 2 or a.ndim != 2 or c.shape[0] != c.shape[1]
            or a.shape[0] != c.shape[0]):
        raise SlateError(f"herk_lower_update: needs C (n, n) and A (n, k), "
                         f"got {tuple(c.shape)} and {tuple(a.shape)}")
    if c.device.type == "cpu" and a.device.type == "cpu":
        return herk_lower_update_plain(c, a)
    for name, x in (("C", c), ("A", a)):
        if x.device.type != "cuda" or x.device != c.device:
            raise SlateError(f"herk_lower_update: unsupported device "
                             f"{x.device} for {name}")
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise SlateError(f"herk_lower_update: {name} needs a unit "
                             "column stride")
    n, k = a.shape
    if n == 0 or k == 0:
        return c
    f = _fn("herk_lower", f"slate_herk_lower_{_K5_SUFFIX[c.dtype]}",
            [_P, _P, _I, _I, _L, _L, _P])
    with torch.cuda.device(c.device):
        rc = f(c.data_ptr(), a.data_ptr(), n, k, _row_stride(c),
               _row_stride(a), torch.cuda.current_stream(c.device).cuda_stream)
    _raise_on(rc, "herk_lower", "slate_herk_error_string",
              f"herk_lower_update (n={n}, k={k})")
    _count("herk_lower_update", c)
    return c


# ---------------------------------------------------------------------------
# P1: inverses of a stack of lower-triangular leaves (no Pallas counterpart)
# ---------------------------------------------------------------------------

LEAF_MAX = 64  # the widest leaf P1 and P2 take
# P1's and P2's entrywise check against their plain versions
# (chip_smoke.py): |X − X_plain|ᵢⱼ ≤ LEAF_ENTRY_C·s·ε·(|X_plain|·|L|·
# |X_plain|)ᵢⱼ, s·ε the forward-error bound of triangular inversion, which
# each of the two meets on its own (so c = 2 covers their difference, and
# 4 leaves room for complex products).
LEAF_ENTRY_C = 4.0


@_via_f32
def trtri_leaves_plain(l: torch.Tensor, unit: bool = False) -> torch.Tensor:
    """Plain version of P1: X_b = L_b⁻¹ for a (B, s, s) stack by one row
    substitution loop over the s rows, every leaf at once,
    X[i, :i+1] = (e_i − L[i, :i]·X[:i, :i+1]) / L[i, i]. Reads only the
    lower triangle of ``l`` (not the diagonal when ``unit``); the strict
    upper triangle of X stays zero, so a zero diagonal entry makes
    non-finite only the entries that depend on it."""
    nblk, s, _ = l.shape
    x = torch.zeros((nblk, s, s), dtype=l.dtype, device=l.device)
    for i in range(s):
        row = -(l[:, i:i + 1, :i] @ x[:, :i, :i + 1])[:, 0, :]
        row[:, i] += 1
        x[:, i, :i + 1] = row if unit else row / l[:, i, i:i + 1]
    return x


@_via_f32
def trtri_leaves(l: torch.Tensor, unit: bool = False) -> torch.Tensor:
    """Inverses of a (B, s, s) stack of lower-triangular leaves, s ≤ 64,
    as a new contiguous (B, s, s) tensor whose strict upper triangles are
    zero. Only the lower triangle of each leaf is read (not its diagonal
    when ``unit``), so the diagonal blocks of a larger matrix can be
    handed over as a strided view.

    Counterpart of ``_trtri_unrolled_u`` under ``jax.vmap``
    (slate_tpu/ops/blocked.py:242, :265-276; no Pallas kernel). The CUDA
    kernel (csrc/trtri_leaves.cu) runs one block of 256 threads per leaf
    with the leaf in shared memory, read through the view's batch, row and
    column strides (lanes along the unit stride); it inverts the 8 × 8
    diagonal sub-blocks at once by substitution, then joins them level by
    level, X₂₁ = −iC·(B·iA), every entry of a level at once: its cost is
    that dependent chain, not bytes or operations. Types: float32,
    float64, complex64 and complex128; a conjugate or negative view is
    resolved before the launch. Equal to the plain version up to the
    order of its sums (within
    LEAF_ENTRY_C·s·ε·(|X|·|L|·|X|)ᵢⱼ), with non-finite entries in the same
    places."""
    _check_type("trtri_leaves", l)
    if l.ndim != 3 or l.shape[1] != l.shape[2] or not (
            1 <= l.shape[1] <= LEAF_MAX):
        raise SlateError(f"trtri_leaves: expects a (B, s, s) stack with "
                         f"1 ≤ s ≤ {LEAF_MAX}, got {tuple(l.shape)}")
    if l.device.type == "cpu":
        return trtri_leaves_plain(l, unit)
    if l.device.type != "cuda":
        raise SlateError(f"trtri_leaves: unsupported device {l.device}")
    l = _resolved(l)
    nblk, s, _ = l.shape
    x = torch.empty((nblk, s, s), dtype=l.dtype, device=l.device)
    if nblk == 0:
        return x
    f = _fn("trtri_leaves", f"slate_trtri_leaves_{_SUFFIX[l.dtype]}",
            [_P, _P, _I, _I, _L, _L, _L, _I, _P])
    with torch.cuda.device(l.device):
        rc = f(l.data_ptr(), x.data_ptr(), nblk, s, *l.stride(), int(unit),
               torch.cuda.current_stream(l.device).cuda_stream)
    _raise_on(rc, "trtri_leaves", "slate_trtri_error_string",
              f"trtri_leaves (B={nblk}, s={s})")
    _count("trtri_leaves", x)
    return x


# ---------------------------------------------------------------------------
# P2: no-pivot LU of one square leaf (no Pallas counterpart)
# ---------------------------------------------------------------------------

@_via_f32
def lu_nopiv_base_plain(a: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of P2 (= the reference's ``_lu_nopiv_unblocked``,
    any (m, n)): min(m, n) steps, each scaling column i below the
    diagonal by the pivot and subtracting col ⊗ urow from the WHOLE
    matrix (col zero on and above row i, urow zero left of and at column
    i), so a non-finite entry spreads as in the reference. A bad pivot
    (``bad_pivot``: |d| zero or NaN) sets info (1-based, the first) and
    that step divides by 1. Returns (L\\U packed, info int32 0-d). No host
    sync."""
    m, n = a.shape
    dev = a.device
    mat = _resolved(a).clone()
    info = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=a.dtype, device=dev)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    for i in range(min(m, n)):
        d = mat[i, i]
        bad = bad_pivot(d)
        info = torch.where((info == 0) & bad,
                           torch.full_like(info, i + 1), info)
        dsafe = cx_divisor(torch.where(bad, one, d))
        below = rows > i
        col = torch.where(below, cx_div(mat[:, i], dsafe), zero)
        mat[:, i] = torch.where(below, col, mat[:, i])
        urow = torch.where(cols > i, mat[i, :], zero)
        mat -= cx_mul(col[:, None], urow[None, :])
    return mat, info


def _check_nopiv_leaf(name: str, a: torch.Tensor):
    _check_type(name, a)
    if a.ndim != 2 or a.shape[0] != a.shape[1] or not (
            1 <= a.shape[0] <= LEAF_MAX):
        raise SlateError(f"{name}: expects a square (s, s) leaf "
                         f"with 1 ≤ s ≤ {LEAF_MAX}, got {tuple(a.shape)}")


@_via_f32
def lu_nopiv_base(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """No-pivot LU of one square (s, s) leaf, s ≤ 64 → (L\\U packed,
    info int32 0-d: the 1-based first step whose pivot is 0 or NaN; that
    step goes on with the pivot taken as 1).

    Counterpart of ``_lu_nopiv_unblocked`` (slate_tpu/linalg/lu.py:463-482;
    no Pallas kernel). On a CUDA tensor: ``lu_nopiv_base_inplace`` on a
    copy. Bitwise equal to the plain version on the same input (products
    and differences rounded separately), in float32, float64, complex64
    and complex128."""
    _check_nopiv_leaf("lu_nopiv_base", a)
    if a.device.type == "cpu":
        return lu_nopiv_base_plain(a)
    lu = _resolved(a).clone(memory_format=torch.contiguous_format)
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    lu_nopiv_base_inplace(lu, info)
    return lu, info


def lu_nopiv_base_inplace(a: torch.Tensor, info: torch.Tensor,
                          offset: int = 0) -> None:
    """``lu_nopiv_base`` IN PLACE on a square (s, s) view, s ≤ 64, of any
    non-overlapping strides: L\\U is written back into ``a``. ``info`` is
    a 0-d int32 slot on a's device: if it reads 0 and this leaf has a bad
    pivot at 1-based step p, it becomes ``offset + p``; else it is left as
    it is. Leaves launched in factor order on one stream so leave the
    factor's first bad pivot there (no host sync).

    The CUDA kernel (csrc/lu_nopiv.cu) keeps the leaf in registers, 8
    columns per warp; the warp holding column k makes step k's multipliers
    one step ahead and publishes them through shared memory and an
    mbarrier of their own: no block-wide barrier per step. A CPU tensor
    runs ``lu_nopiv_base_plain`` and copies its result in."""
    name = "lu_nopiv_base_inplace"
    if a.dtype == torch.bfloat16:  # the bf16 route, in place on a copy
        t = _upcast(a)
        with _counted_as_bf16():
            lu_nopiv_base_inplace(t, info, offset)
        a.copy_(t)
        return
    _check_nopiv_leaf(name, a)
    if (info.dtype != torch.int32 or info.ndim != 0
            or info.device != a.device):
        raise SlateError(f"{name}: info must be a 0-d int32 tensor on "
                         f"{a.device}, got {info.dtype} {tuple(info.shape)} "
                         f"on {info.device}")
    s = a.shape[0]
    lo, hi = sorted(a.stride())
    if s > 1 and (lo < 1 or hi < s * lo):
        raise SlateError(f"{name}: the view's entries overlap "
                         f"(strides {a.stride()})")
    if a.device.type == "cpu":
        lu, got = lu_nopiv_base_plain(a)
        a.copy_(lu)
        info.copy_(torch.where((info == 0) & (got > 0), got + offset, info))
        return
    if a.device.type != "cuda":
        raise SlateError(f"{name}: unsupported device {a.device}")
    if a.is_conj() or a.is_neg():
        raise SlateError(f"{name}: a conjugate or negative view cannot be "
                         "factored in place")
    f = _fn("lu_nopiv", f"slate_lu_nopiv_{_SUFFIX[a.dtype]}",
            [_P, _L, _L, _I, _P, _I, _P])
    with torch.cuda.device(a.device):
        rc = f(a.data_ptr(), *a.stride(), s, info.data_ptr(), offset,
               torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "lu_nopiv", "slate_lu_nopiv_error_string",
              f"{name} (s={s})")
    _count("lu_nopiv_base", a)


# ---------------------------------------------------------------------------
# P3: partial-pivot LU of every chunk of a stack (no Pallas counterpart)
# ---------------------------------------------------------------------------

@_via_f32
def lu_panel_batched_plain(stack: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of P3 (= the reference's ``_panel_getrf_batched_impl``,
    written out over the batch): per chunk, ``lu_panel_base_plain``'s
    column loop — argmax pivot on the modulus under jnp.argmax's rule
    (NaN is the maximum, ties go to the lowest row, rows above j are not
    candidates),
    row and perm swap, first-bad-pivot info (that column divides by 1),
    scale, and the rank-1 update of the trailing block as a rounded
    product and a separate difference. Every step runs on all B chunks at
    once and no reduction crosses chunks. Returns (lu, perm int32 (B, H)
    with stack[b][perm[b]] = L·U, info int32 (B,)). No host sync."""
    bsz, hh, w = stack.shape
    dev = stack.device
    lu = _resolved(stack).clone()
    perm = torch.arange(hh, dtype=torch.int32, device=dev).repeat(bsz, 1)
    info = torch.zeros(bsz, dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=stack.dtype, device=dev)
    batch = torch.arange(bsz, device=dev)
    for j in range(w):
        col = cx_abs(lu[:, j:, j])
        nanmask = torch.isnan(col)
        finite = torch.where(nanmask, torch.full_like(col, -1.0), col)
        cand = torch.where(nanmask.any(1, keepdim=True), nanmask,
                           finite == finite.max(1, keepdim=True).values)
        idx = torch.arange(hh - j, device=dev).expand_as(col)
        p = torch.where(cand, idx, hh).min(1).values + j
        row_j, row_p = lu[batch, j], lu[batch, p]
        lu[batch, p] = row_j
        lu[batch, j] = row_p
        perm_j, perm_p = perm[batch, j], perm[batch, p]
        perm[batch, p] = perm_j
        perm[batch, j] = perm_p
        d = lu[:, j, j]
        bad = bad_pivot(d)
        info = torch.where((info == 0) & bad,
                           torch.full_like(info, j + 1), info)
        dsafe = cx_divisor(torch.where(bad, one, d)[:, None])
        if j + 1 < hh:
            lu[:, j + 1:, j] = cx_div(lu[:, j + 1:, j], dsafe)
            if j + 1 < w:
                lu[:, j + 1:, j + 1:] -= cx_mul(lu[:, j + 1:, j, None],
                                                lu[:, j, None, j + 1:])
    return lu, perm, info


P3_CLUSTERS = (1, 2, 4, 8, 16)  # cluster sizes P3 takes (16: non-portable)
P3_WARPS = 8           # csrc/lu_panel_batched.cu kWarps (256 threads a CTA)
P3_CTAS_PER_SM = 2     # its __launch_bounds__(256, 2)
SM_SMEM = 233_472      # 228 KB: the shared memory of one SM
SMEM_BLOCK_RESERVED = 1_024  # the runtime's own shared memory per block


class P3Plan(NamedTuple):
    """P3's cluster of ``ctas`` CTAs per chunk: row i of a chunk is CTA
    i mod ctas's slot i // ctas, ``rows`` the slots of the fullest CTA.
    ``resident``: each CTA holds its slots in shared memory, else in a
    global scratch of its own. ``smem_bytes``: shared memory per CTA."""
    ctas: int
    rows: int
    resident: bool
    smem_bytes: int

    @property
    def mode(self) -> str:
        return "resident" if self.resident else "streaming"

    def slots(self, cta: int, hh: int) -> range:
        """The chunk rows CTA ``cta`` owns, slot by slot."""
        return range(cta, hh, self.ctas)


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def lu_panel_batched_smem_bytes(hh: int, w: int, itemsize: int, ctas: int,
                                resident: bool) -> int:
    """Shared memory of one P3 CTA (csrc/lu_panel_batched.cu
    ``smem_bytes``, held against it by ``lu_panel_batched_launch_smem`` in
    ``chip_smoke.py``): the candidates of the cluster's ctas · 8 warps
    for two columns and the pivot (16 bytes each), each slot's position,
    the U rows of two columns and, resident, the CTA's slots."""
    rows = -(-hh // ctas)
    nbytes = ((2 * ctas * P3_WARPS + 1) * 16 + _align16(4 * rows)
              + 2 * _align16(w * itemsize))
    return nbytes + (rows * w * itemsize if resident else 0)


def lu_panel_batched_plan_with(hh: int, w: int, itemsize: int,
                               ctas: int) -> P3Plan:
    """The plan at a given cluster size: resident when the slots fit
    PANEL_SMEM_LIMIT. Refuses a size P3 does not take, more CTAs than
    rows, and a streaming CTA whose U row does not fit."""
    if ctas not in P3_CLUSTERS or ctas > hh or w < 1 or w > hh:
        raise SlateError(f"lu_panel_batched_plan: no plan of {ctas} CTAs "
                         f"for a chunk of {(hh, w)}")
    resident = lu_panel_batched_smem_bytes(
        hh, w, itemsize, ctas, True) <= PANEL_SMEM_LIMIT
    smem = lu_panel_batched_smem_bytes(hh, w, itemsize, ctas, resident)
    if smem > PANEL_SMEM_LIMIT:
        raise SlateError(f"lu_panel_batched_plan: a chunk of {(hh, w)} "
                         f"needs {smem} bytes of shared memory per CTA")
    return P3Plan(ctas, -(-hh // ctas), resident, smem)


def lu_panel_batched_plan(bsz: int, hh: int, w: int, itemsize: int,
                          n_sm: int) -> P3Plan:
    """P3's plan for a (bsz, hh, w) stack of ``itemsize``-byte elements
    on a card with ``n_sm`` SMs: the cluster size C ∈ P3_CLUSTERS (at
    most hh) whose CTAs hold their slots in shared memory, then whose
    bsz·C CTAs fill the card in the fewest waves (P3_CTAS_PER_SM CTAs an
    SM where their shared memory allows), then the largest C. A resident
    plan wins over one wave fewer: on an H100 (16, 1024, 512) f32 took
    5.4 ms at C = 16 resident in three waves and 6.3 ms at C = 8
    streaming in one (tools/p3_plans.py). Many small chunks take C = 1,
    where more CTAs would need more waves. Pure: the C launcher checks
    it, the CPU tests hold it."""
    if bsz < 1 or itemsize < 1 or n_sm < 1 or w < 1 or w > hh:
        raise SlateError(f"lu_panel_batched_plan: bad stack "
                         f"{(bsz, hh, w)}, itemsize {itemsize} or SM "
                         f"count {n_sm}")
    best, key = None, None
    for ctas in P3_CLUSTERS:
        try:
            plan = lu_panel_batched_plan_with(hh, w, itemsize, ctas)
        except SlateError:
            continue
        per_sm = min(P3_CTAS_PER_SM,
                     SM_SMEM // (plan.smem_bytes + SMEM_BLOCK_RESERVED))
        waves = -(-bsz * ctas // (n_sm * per_sm))
        k = (not plan.resident, waves, -ctas)
        if key is None or k < key:
            best, key = plan, k
    if best is None:
        raise SlateError(f"lu_panel_batched_plan: a chunk of {(hh, w)} "
                         f"does not fit a CTA's shared memory")
    return best


def lu_panel_batched_plan_for(stack: torch.Tensor) -> P3Plan:
    """The plan P3 launches with for the CUDA stack ``stack``."""
    bsz, hh, w = stack.shape
    return lu_panel_batched_plan(bsz, hh, w, stack.element_size(),
                                 _sm_count(stack.device.index))


def lu_panel_batched_launch_smem(hh: int, w: int, itemsize: int,
                                 plan: P3Plan) -> int:
    """The shared memory per CTA that the C launcher sizes ``plan`` with
    (``slate_lu_panel_batched_smem_bytes``); ``chip_smoke.py`` holds the
    plan's ``smem_bytes`` against it. Needs the built kernel."""
    return _fn("lu_panel_batched", "slate_lu_panel_batched_smem_bytes",
               [_I] * 5, ctypes.c_longlong)(hh, w, plan.ctas,
                                            int(plan.resident), itemsize)


def lu_panel_batched_max_clusters(stack: torch.Tensor, plan: P3Plan) -> int:
    """How many clusters of ``plan`` the card holds at once
    (cudaOccupancyMaxActiveClusters), for timing plans against each
    other. Needs the built kernel."""
    bsz, hh, w = stack.shape
    out = ctypes.c_int(0)
    f = _fn("lu_panel_batched",
            f"slate_lu_panel_batched_{_SUFFIX[stack.dtype]}_clusters",
            [_I] * 5 + [ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(stack.device):
        rc = f(bsz, hh, w, plan.ctas, int(plan.resident), ctypes.byref(out))
    _raise_on(rc, "lu_panel_batched", "slate_lu_panel_batched_error_string",
              f"lu_panel_batched_max_clusters (plan {plan})")
    return out.value


@_via_f32
def lu_panel_batched(stack: torch.Tensor):
    """Partial-pivot LU of every (H, w) chunk of a contiguous (B, H, w)
    stack, 0 < w ≤ H → (lu, perm int32 (B, H), info int32 (B,)), each
    chunk with ``lu_panel_base``'s contract. Chunks never mix: a zero or
    NaN column in one changes nothing in the others.

    Counterpart of ``blocked.panel_getrf_batched`` (body
    ``_panel_getrf_batched_impl``, slate_tpu/ops/blocked.py:691-763; no
    Pallas kernel), the reference's one batched program per CALU
    tournament round. The CUDA kernel (csrc/lu_panel_batched.cu) runs one
    thread-block cluster per chunk (``lu_panel_batched_plan``), the whole
    stack in one launch, so one launch is one round: the chunk's rows
    dealt cyclically to the cluster's CTAs and held in shared memory (or
    streamed), row positions swapped instead of rows, one cluster barrier
    per column. It is bound by the w serial column steps. The stack must
    be contiguous (``blocked.panel_getrf_batched`` makes it so). Bitwise
    equal to the plain version on the same input: lu, perm and info, in
    float32, float64, complex64 and complex128. A plan the card cannot
    schedule raises."""
    _check_type("lu_panel_batched", stack)
    if stack.ndim != 3:
        raise SlateError(f"lu_panel_batched: expects a (B, H, w) stack, got "
                         f"{tuple(stack.shape)}")
    bsz, hh, w = stack.shape
    if w > hh or w == 0:
        raise SlateError(f"lu_panel_batched: needs 0 < w ≤ H, got "
                         f"{(hh, w)}")
    if stack.device.type == "cpu":
        return lu_panel_batched_plain(stack)
    stack = _resolved(stack)
    _check_cuda_args("lu_panel_batched", stack)
    if bsz == 0:
        return (torch.empty_like(stack),
                torch.empty((0, hh), dtype=torch.int32, device=stack.device),
                torch.empty(0, dtype=torch.int32, device=stack.device))
    return lu_panel_batched_launch(stack, lu_panel_batched_plan_for(stack))


def lu_panel_batched_launch(stack: torch.Tensor, plan: P3Plan):
    """One P3 launch of the contiguous CUDA stack with ``plan``
    (``lu_panel_batched``'s own, or another cluster size from
    ``lu_panel_batched_plan_with`` to time it); a streaming plan's
    scratch is allocated here. Raises when the launch is refused."""
    bsz, hh, w = stack.shape
    lu = torch.empty_like(stack)
    perm = torch.empty((bsz, hh), dtype=torch.int32, device=stack.device)
    info = torch.empty(bsz, dtype=torch.int32, device=stack.device)
    scratch = torch.empty(0 if plan.resident else bsz * plan.ctas
                          * plan.rows * w, dtype=stack.dtype,
                          device=stack.device)
    f = _fn("lu_panel_batched",
            f"slate_lu_panel_batched_{_SUFFIX[stack.dtype]}",
            [_P] * 5 + [_I] * 5 + [_P])
    with torch.cuda.device(stack.device):
        rc = f(stack.data_ptr(), lu.data_ptr(), perm.data_ptr(),
               info.data_ptr(), scratch.data_ptr(), bsz, hh, w, plan.ctas,
               int(plan.resident),
               torch.cuda.current_stream(stack.device).cuda_stream)
    _raise_on(rc, "lu_panel_batched", "slate_lu_panel_batched_error_string",
              f"lu_panel_batched (B={bsz}, H={hh}, w={w}, plan {plan})")
    _count("lu_panel_batched", lu)
    return lu, perm, info


# ---------------------------------------------------------------------------
# P4: guarded Cholesky of every tile of a stack (no Pallas counterpart)
# ---------------------------------------------------------------------------

@_via_f32
def chol_tile_batched_plain(d: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of P4 (= the reference's ``_chol_unrolled_b``): per
    column j, on every item at once, the guarded pivot dj = re(d[j, j])
    (a NaN or non-positive dj sets info to j + 1 if it is still 0, and the
    column divides by sqrt(1)), col = d[j+1:, j] / root (the parts
    divided apart), then d[j+1:, j+1:] −= col·colᴴ, the product
    (``cx_mul``) and the difference rounded separately. Only the lower
    triangle reaches the result; the imaginary part of a diagonal entry
    is never read. Returns (tril L, info int32 (B,)). No host sync."""
    bsz, s, _ = d.shape
    a = _resolved(d).clone(memory_format=torch.contiguous_format)
    info = torch.zeros(bsz, dtype=torch.int32, device=d.device)
    one = torch.ones((), dtype=a.real.dtype, device=d.device)
    for j in range(s):
        dj = a[:, j, j].real
        bad = torch.isnan(dj) | (dj <= 0)
        info = torch.where((info == 0) & bad,
                           torch.full_like(info, j + 1), info)
        root = torch.sqrt(torch.where(bad, one, dj))
        if j + 1 < s:
            col = cx_div_real(a[:, j + 1:, j], root[:, None])
            a[:, j + 1:, j] = col
            a[:, j + 1:, j + 1:] -= cx_mul(col[:, :, None],
                                           col.conj()[:, None, :])
        a[:, j, j] = root
    return torch.tril(a), info


@_via_f32
def chol_tile_batched(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Guarded lower Cholesky of every (s, s) item of a (B, s, s) stack,
    1 ≤ s ≤ 64 → (L, info int32 (B,)): L a new contiguous stack with zero
    strict upper triangles; info the 1-based index of each item's first
    non-positive or NaN leading minor, 0 if none. That column divides by a
    safe 1 and the factorization goes on, so a bad item changes nothing
    in its neighbours. Only the lower triangle is read, through the
    stack's batch, row and column strides: a diagonal block of a larger
    stack needs no copy.

    Counterpart of ``_chol_unrolled_b`` (slate_tpu/ops/blocked.py:1072-1097;
    no Pallas kernel). The CUDA kernel (csrc/chol_tile_batched.cu) runs one
    warp per item, four items per CTA, the item in registers padded to
    16, 32 or 64 rows (lane l holds row l and, past 32, row l + 32),
    staged through a per-warp shared tile one row per instruction, the
    columns broadcast through shared memory, each step's trailing update
    finished after the next pivot's square root and division are under
    way. Bitwise equal to the plain version (IEEE square root and
    division, products and differences rounded separately), in float32,
    float64, complex64 and complex128 (two items a CTA in complex128)."""
    _check_type("chol_tile_batched", d)
    if d.ndim != 3 or d.shape[1] != d.shape[2] or not (
            1 <= d.shape[1] <= LEAF_MAX):
        raise SlateError(f"chol_tile_batched: expects a (B, s, s) stack with "
                         f"1 ≤ s ≤ {LEAF_MAX}, got {tuple(d.shape)}")
    if d.device.type == "cpu":
        return chol_tile_batched_plain(d)
    if d.device.type != "cuda":
        raise SlateError(f"chol_tile_batched: unsupported device {d.device}")
    d = _resolved(d)
    bsz, s, _ = d.shape
    l = torch.empty((bsz, s, s), dtype=d.dtype, device=d.device)
    info = torch.empty(bsz, dtype=torch.int32, device=d.device)
    if bsz == 0:
        return l, info
    f = _fn("chol_tile_batched",
            f"slate_chol_tile_batched_{_SUFFIX[d.dtype]}",
            [_P, _P, _P, _I, _I, _L, _L, _L, _P])
    rc = _on_device(d, f, d.data_ptr(), l.data_ptr(), info.data_ptr(), bsz,
                    s, *d.stride())
    if rc:
        _raise_on(rc, "chol_tile_batched",
                  "slate_chol_tile_batched_error_string",
                  f"chol_tile_batched (B={bsz}, s={s})")
    _count("chol_tile_batched", l)
    return l, info


# ---------------------------------------------------------------------------
# P5: Householder QR of every panel of a stack (no Pallas counterpart)
# ---------------------------------------------------------------------------

P5_THREADS = 256       # csrc/qr_panel_batched.cu kMemThreads: the largest
                       # CTA team
P5_WARP_ITEMS = 4      # kWarpItems: items (warps) a CTA of warp teams
P5_STORAGE = {"registers": 0, "shared": 1, "streaming": 2}  # enum Storage
P5_ITEMSIZES = (4, 8, 16)  # float32; float64 and complex64; complex128


class P5Plan(NamedTuple):
    """How P5 works one item: ``team`` "warp" (one warp per item,
    ``items_per_cta`` items a CTA) or "cta" (one CTA per item) of
    ``threads`` threads; thread t owns rows t, t + threads, … (at most
    ``rows_per_thread``); ``storage`` "registers" (the rows in
    registers), "shared" (the item in shared memory) or "streaming"
    (worked in place in the output stack); ``smem_bytes``: shared memory
    per CTA."""
    team: str
    threads: int
    items_per_cta: int
    rows_per_thread: int
    storage: str
    smem_bytes: int


def qr_panel_batched_smem_bytes(hh: int, w: int, itemsize: int,
                                storage: str, threads: int) -> int:
    """Shared memory of one P5 CTA (csrc/qr_panel_batched.cu
    ``smem_bytes``, held against it by ``chip_smoke.py``): a warp team's
    row j, double-buffered, per warp; a CTA team's double-buffered
    partials of each of its warps and row j (32 columns in registers, w
    rounded up to 32 otherwise), then, shared, the item in rows of an odd
    length (w | 1)."""
    if storage == "registers":
        if threads == 32:
            return P5_WARP_ITEMS * 2 * 32 * itemsize
        return (2 * (threads // 32) * 32 + 2 * 32) * itemsize
    wp = -(-w // 32) * 32
    item = hh * (w | 1) if storage == "shared" else 0
    return (2 * (threads // 32) * wp + 2 * wp + item) * itemsize


@functools.lru_cache(maxsize=256)
def qr_panel_batched_plan(hh: int, w: int, itemsize: int) -> P5Plan:
    """P5's plan for items of (hh, w) ``itemsize``-byte entries. It does
    not read B, so an item's bits do not depend on how many items share
    the call. With kR = 8 // itemsize rows a thread (2 in float32, 1 in
    float64 and complex64): registers when itemsize ≤ 8, w ≤ 32 and
    hh ≤ 256·kR, in a team of 32·⌈hh / 32kR⌉ threads (a warp team when
    that is 32, four items a CTA; else a CTA team); otherwise (complex128
    always: a row of 32 entries and its 32 partials would fill a thread's
    registers) a CTA team of 32·⌈hh / 32⌉ threads, at most 256, with the
    item in shared memory when it fits PANEL_SMEM_LIMIT, else streaming. Every shape with
    1 ≤ w ≤ min(hh, 128) and hh·w < 2³¹ has one. Pure: the C launcher
    sizes the same shared memory, the CPU tests hold the plan."""
    if (w < 1 or w > QR_PANEL_MAX_W or w > hh
            or itemsize not in P5_ITEMSIZES or hh * w >= 2 ** 31):
        raise SlateError(f"qr_panel_batched_plan: no plan for an item of "
                         f"{(hh, w)}, itemsize {itemsize}")
    kr = 8 // itemsize
    if kr and w <= 32 and hh <= P5_THREADS * kr:
        storage, threads = "registers", 32 * -(-hh // (32 * kr))
    else:
        threads = min(P5_THREADS, 32 * -(-hh // 32))
        storage = ("shared" if qr_panel_batched_smem_bytes(
            hh, w, itemsize, "shared", threads) <= PANEL_SMEM_LIMIT
            else "streaming")
    warp = storage == "registers" and threads == 32
    return P5Plan("warp" if warp else "cta", threads,
                  P5_WARP_ITEMS if warp else 1, -(-hh // threads), storage,
                  qr_panel_batched_smem_bytes(hh, w, itemsize, storage,
                                              threads))


def qr_panel_batched_launch_smem(hh: int, w: int, itemsize: int,
                                 plan: P5Plan) -> int:
    """The shared memory per CTA that the C launcher sizes ``plan`` with
    (``slate_qr_panel_batched_smem_bytes``). Needs the built kernel."""
    return _fn("qr_panel_batched", "slate_qr_panel_batched_smem_bytes",
               [_I] * 5, ctypes.c_longlong)(
                   hh, w, P5_STORAGE[plan.storage], plan.threads, itemsize)


def qr_panel_batched_plain(stack: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of P5 (the reference's ``_panel_geqrf_batched``
    written out over the batch, with K3's reflector): per column j, on
    every item at once, ``larfg`` of [alpha; x] = the column on and below
    the diagonal (a degenerate column keeps alpha, tau = 0), v = [1;
    x·scale], w_row = vᴴ·A[j:, j+1:], A[j:, j+1:] −= (conj(tau)·v)·w_row.
    Returns (vr (B, H, w), taus (B, w)). No host sync."""
    bsz, hh, w = stack.shape
    vr = _resolved(stack).clone(memory_format=torch.contiguous_format)
    taus = torch.zeros((bsz, w), dtype=stack.dtype, device=stack.device)
    for j in range(w):
        col = vr[:, j:, j]
        beta, tau, scale = larfg(col[:, 0], abs2(col[:, 1:]).sum(1))
        v = col.clone()
        v[:, 1:] *= scale[:, None]
        v[:, 0] = 1
        if j + 1 < w:
            w_row = (v.conj()[:, None, :] @ vr[:, j:, j + 1:])[:, 0, :]
            vr[:, j:, j + 1:] -= (tau.conj()[:, None] * v)[:, :, None] \
                * w_row[:, None, :]
        vr[:, j + 1:, j] = v[:, 1:]
        vr[:, j, j] = beta
        taus[:, j] = tau
    return vr, taus


def qr_panel_batched(stack: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Householder QR of every (H, w) item of a (B, H, w) stack,
    1 ≤ w ≤ min(H, 128) → (vr, taus): vr a new contiguous (B, H, w) stack,
    R on and above each diagonal and the reflectors' tails below (unit
    heads implied), taus (B, w); each item with ``qr_panel_base``'s
    contract. A degenerate column (zero below the diagonal) keeps its
    diagonal entry with tau = 0. Items never mix: a NaN stays in its item.
    The stack is read through its strides (a panel of a larger stack needs
    no copy).

    Counterpart of ``_panel_geqrf_batched`` (slate_tpu/ops/blocked.py:
    1216-1264; no Pallas kernel). The CUDA kernel (csrc/qr_panel_batched.cu)
    works each item with a team of threads that own its rows (the plan
    ``qr_panel_batched_plan``: a warp or a CTA; the rows in registers, in
    shared memory, or streamed through the output stack): per column one
    pass over each thread's rows for every trailing column's partial sum,
    one fixed-order reduction (a transposing butterfly in each warp, then
    the warps in order), the larfg scalars, w_row and the rank-1 update.
    Equal to the plain version up to the order of its H-long sums, in
    float32, float64, complex64 and complex128."""
    _check_type("qr_panel_batched", stack)
    if stack.ndim != 3:
        raise SlateError(f"qr_panel_batched: expects a (B, H, w) stack, got "
                         f"{tuple(stack.shape)}")
    bsz, hh, w = stack.shape
    if not 1 <= w <= min(hh, QR_PANEL_MAX_W):
        raise SlateError(f"qr_panel_batched: needs 1 ≤ w ≤ min(H, "
                         f"{QR_PANEL_MAX_W}), got {(hh, w)}")
    if stack.device.type == "cpu":
        return qr_panel_batched_plain(stack)
    if stack.device.type != "cuda":
        raise SlateError(f"qr_panel_batched: unsupported device "
                         f"{stack.device}")
    stack = _resolved(stack)
    vr = torch.empty((bsz, hh, w), dtype=stack.dtype, device=stack.device)
    taus = torch.empty((bsz, w), dtype=stack.dtype, device=stack.device)
    if bsz == 0:
        return vr, taus
    plan = qr_panel_batched_plan(hh, w, stack.element_size())
    f = _fn("qr_panel_batched", f"slate_qr_panel_batched_{_SUFFIX[stack.dtype]}",
            [_P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _P])
    rc = _on_device(stack, f, stack.data_ptr(), vr.data_ptr(),
                    taus.data_ptr(), bsz, hh, w, *stack.stride(),
                    P5_STORAGE[plan.storage], plan.threads)
    if rc:
        _raise_on(rc, "qr_panel_batched",
                  "slate_qr_panel_batched_error_string",
                  f"qr_panel_batched (B={bsz}, H={hh}, w={w}, plan {plan})")
    _count("qr_panel_batched", vr)
    return vr, taus


# ---------------------------------------------------------------------------
# P6–P8: incremental factor updates (no Pallas counterpart)
# ---------------------------------------------------------------------------
# The reference writes these sweeps as lax.scan programs over the n columns
# (slate_tpu/linalg/update.py). Each step is O(n·k) work, so a plain torch
# port issues about n·k launches per call; the three kernels make each
# sweep one launch. Their plain versions replay the kernels' arithmetic:
# every product, sum and quotient rounded apart (complex products part by
# part through ``cx_mul``, complex quotients by Smith's form through
# ``cx_divisor``/``cx_div``), sums over the appended rows in increasing
# order, so a zero update lane or appended row adds exact zeros at the end
# of each sum and is a bitwise no-op.

UPDATE_BUCKETS = (1, 2, 4, 8, 16)  # the kernels' rank / row-count instances
P6_ROWS = 128    # rows (one thread each) per CTA of a multi-CTA sweep
P6_ONE_CTA = 256  # csrc/chol_update.cu kMaxThreads: the largest one-CTA item
P6_TILE = 32     # csrc/chol_update.cu kTw: columns of a block and a panel
P6_SMEM_MAX = 232448  # csrc/chol_update.cu kSmemMax: a CTA's shared memory
P6_SMEM_PER_SM = 233472  # an H100 SM's shared memory (1024 B of it per CTA
#                          kept by the system)
P7_COLS = 128    # csrc/qr_append.cu kCols: columns (one thread each) per CTA
P7_STEP = 32     # csrc/qr_append.cu kStep: steps staged and published at once
P8_THREADS = 128  # csrc/qr_append.cu kApplyThreads: threads on columns a CTA
P8_STEP = 32     # csrc/qr_append.cu kApplyStep: steps staged at a time
P8_BUFS = 3      # csrc/qr_append.cu kApplyBufs: chunks in flight
P8_SPLIT_P = 16  # csrc/qr_append.cu kApplySplitP: the least P (P/2 in
#                  complex types) whose column takes two lanes


def _check_bucket(name: str, k: int):
    if k not in UPDATE_BUCKETS:
        raise SlateError(f"{name}: the rank / row count {k} is not one of "
                         f"the buckets {UPDATE_BUCKETS} (pad with zero lanes)")


def _scale_real(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x·c for a real c (broadcast), part by part for a complex x."""
    if not x.is_complex():
        return x * c
    re, im = _parts(x)
    return torch.complex(re * c, im * c)


class P6Plan(NamedTuple):
    """One P6 item is swept by ``ctas`` CTAs of ``rows`` threads, CTA b
    owning rows [b·rows, (b+1)·rows) and warp w of it rows [32w, 32w + 32)
    of those; ``bufs`` (1 or 2) 32-column blocks of L per row in shared
    memory (2: the next block is fetched while one is worked)."""
    ctas: int
    rows: int
    bufs: int


def chol_update_smem(rows: int, kb: int, itemsize: int, real_itemsize: int,
                     bufs: int) -> int:
    """P6's dynamic shared memory (csrc/chol_update.cu ``smem_bytes``):
    the blocks, two buffers of (c, s) pairs (P6_TILE + kb steps of kb
    pairs), two panels' live counts."""
    return (bufs * rows * (P6_TILE + 1) * itemsize
            + 2 * (P6_TILE + kb) * kb * (itemsize + real_itemsize)
            + 2 * P6_TILE * 4)


def chol_update_plan(n: int, kb: int, itemsize: int,
                     real_itemsize: int = None) -> P6Plan:
    """P6's plan for an item of ``n`` live rows at rank bucket ``kb`` and
    element size ``itemsize`` (``real_itemsize`` that of its real part,
    itemsize by default): one CTA of 32·⌈n/32⌉ threads up to P6_ONE_CTA
    rows, else ⌈n / P6_ROWS⌉ CTAs of P6_ROWS. Two block buffers where they
    fit (one CTA: in P6_SMEM_MAX; several: two CTAs in an SM, so that the
    cooperative launch stays resident up to 2·132 CTAs), else one. It
    reads no batch size, so an item's bits do not depend on the batch
    (and, the arithmetic per entry being fixed, not on the plan either)."""
    if n < 1:
        raise SlateError(f"chol_update_plan: no plan for n = {n}")
    rit = itemsize if real_itemsize is None else real_itemsize
    if n <= P6_ONE_CTA:
        ctas, rows = 1, 32 * -(-n // 32)
        room = P6_SMEM_MAX
    else:
        ctas, rows = -(-n // P6_ROWS), P6_ROWS
        room = P6_SMEM_PER_SM // 2 - 1024
    bufs = 2 if chol_update_smem(rows, kb, itemsize, rit, 2) <= room else 1
    if chol_update_smem(rows, kb, itemsize, rit, bufs) > P6_SMEM_MAX:
        raise SlateError(f"chol_update_plan: n = {n}, kb = {kb} does not "
                         f"fit one CTA's shared memory")
    return P6Plan(ctas, rows, bufs)


def chol_update_plan_for(n: int, kb: int, dtype: torch.dtype) -> P6Plan:
    """P6's plan for an item of ``n`` live rows of ``dtype`` at rank
    bucket ``kb`` (bfloat16 takes the float32 instance)."""
    if dtype == torch.bfloat16:
        dtype = torch.float32
    it = torch.empty((), dtype=dtype).element_size()
    return chol_update_plan(n, kb, it, it // 2 if dtype.is_complex else it)


def chol_update_sweep_plain(l: torch.Tensor, w: torch.Tensor, sign: int,
                            n: int = None) -> torch.Tensor:
    """Plain version of P6 (the reference's ``chol_update_dense`` scan
    body, ``slate_tpu/linalg/update.py:94-132``), IN PLACE on ``l``: for
    A' = A + sign·W·Wᴴ, per column j < n and vector i, on every item at
    once, ljj = re(L[j, j]), r² = ljj² ± |w[j, i]|² (a downdate with
    r² ≤ 0 sets info = j + 1 and freezes the sweep from there on: no
    entry changes after it), r = √max(r², tiny), c = ljj/r, s = w[j, i]/r,
    then over the rows r ≥ j: L[r, j] ← c·L[r, j] ± conj(s)·w[r, i] and
    w[r, i] ← c·w[r, i] − s·L[r, j] (on a working copy: ``w`` is only
    read). Returns info (int32, 0-d for one item, (B,) for a stack)."""
    batched = l.ndim == 3
    L = l if batched else l[None]
    x = (w if batched else w[None]).transpose(1, 2).clone()
    bsz, npad, _ = L.shape
    kb = x.shape[1]
    n = npad if n is None else n
    rdt = L.real.dtype if L.is_complex() else L.dtype
    tiny = torch.tensor(torch.finfo(rdt).tiny, dtype=rdt, device=l.device)
    info = torch.zeros(bsz, dtype=torch.int32, device=l.device)
    live = torch.ones(bsz, dtype=torch.bool, device=l.device)
    for j in range(n):
        lc = L[:, j:n, j].clone()
        for i in range(kb):
            xi = x[:, i, j:n]
            ljj = lc[:, 0].real if lc.is_complex() else lc[:, 0]
            xj = xi[:, :1]
            ax2 = abs2(xi[:, 0])
            l2 = ljj * ljj
            r2 = l2 + ax2 if sign > 0 else l2 - ax2
            if sign < 0:
                bad = r2 <= 0
                info = torch.where(live & bad, torch.full_like(info, j + 1),
                                   info)
                live = live & ~bad
            r = torch.sqrt(torch.maximum(r2, tiny))[:, None]
            c = ljj[:, None] / r
            s = cx_div_real(xj, r)
            t = cx_mul(s.conj(), xi)
            cl = _scale_real(lc, c)
            new = cl + t if sign > 0 else cl - t
            newx = _scale_real(xi, c) - cx_mul(s, lc)
            if sign < 0:
                new = torch.where(live[:, None], new, lc)
                newx = torch.where(live[:, None], newx, xi)
            lc = new
            x[:, i, j:n] = newx
        L[:, j:n, j] = lc
    return info if batched else info[0]


def chol_update_sweep(l: torch.Tensor, w: torch.Tensor, sign: int,
                      n: int = None) -> torch.Tensor:
    """P6: rank-k update (``sign`` +1) or downdate (−1) of lower Cholesky
    factors IN PLACE, A' = A + sign·W·Wᴴ. ``l`` is one (npad, npad) factor
    (zero above the diagonal and beyond the logical ``n``) or a (B, s, s)
    stack; ``w`` the (npad, kb) or (B, s, kb) update vectors, zero beyond
    the live rows and rank, kb one of UPDATE_BUCKETS. Only the lower
    triangle of the first ``n`` rows and columns changes; ``w`` is read,
    never written. Returns info as the plain version does: the 1-based
    column of the first failed downdate (the factor is then to be
    discarded; it stays finite), 0 if none. A zero vector lane is a
    bitwise no-op, and an item's bits do not depend on the batch.

    No Pallas counterpart: replaces the reference's ``chol_update_dense``
    scan (slate_tpu/linalg/update.py:70-137) and its ``vmap`` in
    ``_k_chol_update`` (:158-169). The CUDA kernel (csrc/chol_update.cu)
    owns one row per thread with the row's kb vector entries in registers
    and the rows' entries of L in 32-column blocks of shared memory, one
    per warp, the next block fetched by cp.async while one is worked (plan
    ``chol_update_plan``: CTAs of P6_ROWS rows, one CTA of up to
    P6_ONE_CTA for a small item; one or two block buffers). CTA b first
    applies the (c, s) pairs the CTAs above it publish, then its diagonal
    block one 32-column panel per warp: the panel's warp makes the pairs
    as a (column, vector) wavefront (lane l makes pair (j0 + l, t − l) at
    step t, so a panel takes its width + kb − 1 warp-synchronous steps),
    releasing each step through a counter in shared memory to the warps
    below, which follow it step by step; no block-wide barrier sits on a
    column. A panel in which a downdate fails is restored to its entry
    state and replayed in the plain version's order, so pairs leave a
    panel only final, with each column's live count. A multi-CTA item is
    one cooperative launch (every CTA resident, so the spin-waits cannot
    deadlock). Every entry sees the plain version's operations in its
    order, rounded apart, so the factor is bit for bit the plain
    version's. A bfloat16 factor (a refined operator's) takes the float32
    instance on a float32 copy, written back rounded."""
    name = "chol_update_sweep"
    if l.dtype == torch.bfloat16:  # the bf16 route, in place on a copy
        t = _upcast(l)
        with _counted_as_bf16():
            info = chol_update_sweep(t, w.to(torch.float32), sign, n)
        l.copy_(t)
        return info
    _check_type(name, l)
    batched = l.ndim == 3
    if l.ndim not in (2, 3) or l.shape[-1] != l.shape[-2] or (
            w.ndim != l.ndim or w.shape[:-1] != l.shape[:-1]):
        raise SlateError(f"{name}: expects l (npad, npad) or (B, s, s) and "
                         f"w (…, kb) beside it, got {tuple(l.shape)} and "
                         f"{tuple(w.shape)}")
    if w.dtype != l.dtype or w.device != l.device:
        raise SlateError(f"{name}: w must match l's type and device")
    if sign not in (1, -1):
        raise SlateError(f"{name}: sign must be +1 or -1, got {sign}")
    kb = w.shape[-1]
    _check_bucket(name, kb)
    npad = l.shape[-1]
    n = npad if n is None else int(n)
    if not 0 <= n <= npad:
        raise SlateError(f"{name}: n = {n} outside [0, {npad}]")
    if l.device.type == "cpu":
        return chol_update_sweep_plain(l, w, sign, n)
    if l.device.type != "cuda":
        raise SlateError(f"{name}: unsupported device {l.device}")
    if l.is_conj() or l.is_neg() or l.stride(-1) != 1:
        # the kernel writes rows of unit column stride: sweep a copy
        t = _resolved(l).contiguous()
        info = chol_update_sweep(t, w, sign, n)
        l.copy_(t)
        return info
    L = l if batched else l[None]
    W = (_resolved(w) if batched else _resolved(w)[None]).contiguous()
    bsz = L.shape[0]
    info = torch.zeros(bsz, dtype=torch.int32, device=l.device)
    if bsz == 0 or n == 0:
        return info if batched else info[0]
    plan = chol_update_plan_for(n, kb, L.dtype)
    real = torch.empty((), dtype=L.dtype).real.dtype if L.is_complex() \
        else L.dtype
    nsc = bsz * n * kb if plan.ctas > 1 else 1
    sc_c = torch.empty(nsc, dtype=real, device=l.device)
    sc_s = torch.empty(nsc, dtype=L.dtype, device=l.device)
    sc_live = torch.empty(bsz * n if plan.ctas > 1 else 1, dtype=torch.int32,
                          device=l.device)
    # a downdate's W entries at a panel's entry (a replay's restart)
    sc_x = torch.empty(bsz * n * kb if sign < 0 else 1, dtype=L.dtype,
                       device=l.device)
    progress = torch.zeros(bsz * plan.ctas, dtype=torch.int32,
                           device=l.device)
    f = _fn("chol_update", f"slate_chol_update_{_SUFFIX[L.dtype]}",
            [_P, _L, _L, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
             _P, _P, _P, _P])
    rc = _on_device(L, f, L.data_ptr(), L.stride(0), L.stride(1),
                    W.data_ptr(), W.stride(0), n, kb, int(sign < 0), bsz,
                    plan.ctas, plan.rows, plan.bufs, info.data_ptr(),
                    sc_c.data_ptr(), sc_s.data_ptr(), sc_live.data_ptr(),
                    sc_x.data_ptr(), progress.data_ptr())
    if rc:
        _raise_on(rc, "chol_update", "slate_chol_update_error_string",
                  f"{name} (B={bsz}, n={n}, kb={kb}, plan {plan})")
    _count(name, L)
    return info if batched else info[0]


def _householder_append(alpha: torch.Tensor, x: torch.Tensor):
    """The reference's reflector of [alpha; x] for a structured QR step
    (slate_tpu/linalg/update.py:209-222): beta = −phase·√(|α|² + ‖x‖²)
    with phase = α/|α| (1 for α = 0), so beta is complex in complex types;
    tau = (beta − α)/beta and the tail x/(α − beta); a zero x is inert
    (tau = 0, tail 0, the diagonal keeps α). ``x``: the (P,) appended
    entries, ‖x‖² summed in increasing order. Returns (diag, tau, tail)."""
    xn2 = abs2(x[0])
    for p in range(1, x.shape[0]):
        xn2 = xn2 + abs2(x[p])
    an = cx_abs(alpha)
    one = torch.ones_like(alpha)
    phase = torch.where(an > 0, cx_div_real(alpha, torch.where(
        an > 0, an, torch.ones_like(an))), one)
    beta = _scale_real(-phase, torch.sqrt(an * an + xn2))
    inert = xn2 == 0
    zero = torch.zeros_like(alpha)
    tau = torch.where(inert, zero, cx_div(beta - alpha, cx_divisor(
        torch.where(inert, one, beta))))
    tail = torch.where(inert, torch.zeros_like(x), cx_div(x, cx_divisor(
        torch.where(inert, one, alpha - beta))))
    return torch.where(inert, alpha, beta), tau, tail


def _reflect_rows(top: torch.Tensor, mat: torch.Tensor, tail: torch.Tensor,
                  tau: torch.Tensor):
    """[top; mat] ← (I − tau·v·vᴴ)·[top; mat] for v = [1; tail] (top a row
    of q entries, mat (P, q)), vᴴ·y summed over the P rows in increasing
    order and added to the top row last → (new top, new mat)."""
    acc = cx_mul(tail[0].conj(), mat[0])
    for p in range(1, mat.shape[0]):
        acc = acc + cx_mul(tail[p].conj(), mat[p])
    vy = top + acc
    new_top = top - cx_mul(tau, vy)
    new_mat = mat - cx_mul(tau, cx_mul(tail[:, None], vy[None, :]))
    return new_top, new_mat


def qr_append_build_plain(r: torch.Tensor, u: torch.Tensor, n: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of P7 (the reference's ``qr_append_build`` scan body,
    slate_tpu/linalg/update.py:207-241), IN PLACE on the upper-triangular
    ``r`` (npad, npad): per column j < n, the reflector of [R[j, j];
    U[:, j]] (``_householder_append``), then R's row j and U's columns
    right of j reflected, R[j, j] = beta (α when inert) and U[:, j] = 0.
    ``u`` (P, npad) is read on a working copy. Returns (w (P, npad), tau
    (npad,)), zero beyond column n."""
    npad = r.shape[1]
    umat = _resolved(u).clone()
    w = torch.zeros_like(umat)
    tau = torch.zeros(npad, dtype=r.dtype, device=r.device)
    for j in range(n):
        d, tj, wj = _householder_append(r[j, j], umat[:, j])
        top, mat = _reflect_rows(r[j, j + 1:], umat[:, j + 1:], wj, tj)
        r[j, j + 1:] = top
        umat[:, j + 1:] = mat
        r[j, j] = d
        umat[:, j] = 0
        w[:, j] = wj
        tau[j] = tj
    return w, tau


def _check_append(name: str, top: torch.Tensor, rows: torch.Tensor,
                  what: str):
    _check_type(name, top)
    if rows.dtype != top.dtype or rows.device != top.device:
        raise SlateError(f"{name}: {what} must match the type and device")
    _check_bucket(name, rows.shape[0])


def qr_append_build(r: torch.Tensor, u: torch.Tensor, n: int,
                    w: torch.Tensor = None, tau: torch.Tensor = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P7: the structured QR of [R; U] IN PLACE on the upper-triangular
    ``r`` (npad, npad): per column j < n one reflector v = [e_j; w_j] with
    the reference's convention (beta = −phase·√(|α|² + ‖x‖²), complex in
    complex types, on the diagonal; not K3's larfg), R's row j and U's
    trailing columns reflected. ``u`` is the (P, npad) block of appended
    rows, P one of UPDATE_BUCKETS, zero beyond the live rows and the
    logical n (a zero row is a bitwise no-op); it is read, never written.
    Returns (w (P, npad), tau (npad,)), zero beyond column n, written into
    ``w`` and ``tau`` when given (a Session's append slots).

    No Pallas counterpart: replaces the reference's ``qr_append_build``
    scan (slate_tpu/linalg/update.py:189-241). The CUDA kernel
    (csrc/qr_append.cu) owns one column of R and U per thread (U's column
    in registers), P7_COLS columns a CTA, and stages R's rows P7_STEP at a
    time into shared memory by cp.async, double-buffered, so no global
    load sits on a step (alpha = R[j][j] is in the staged row: no earlier
    step writes row j). CTA b applies the reflectors the CTAs left of it
    publish, then makes its own a chunk of P7_STEP steps per warp: the
    chunk's warp is the front, its lane s making step j's scalars from
    alpha and its U column, the P entries of the tail divided one per lane
    by one divisor, and every lane right of j reflecting its column, so
    the next column's owner is ready one reflection later; each step is
    released through a counter in shared memory to the warps to the right,
    which follow it. A multi-CTA call is one cooperative launch (two
    staging buffers, or one where two would not keep every CTA resident).
    Arithmetic as the plain version's, rounded apart."""
    name = "qr_append_build"
    _check_append(name, r, u, "u")
    npad = r.shape[-1]
    if r.ndim != 2 or r.shape[0] != npad or u.ndim != 2 or (
            u.shape[1] != npad) or not 0 <= n <= npad:
        raise SlateError(f"{name}: expects r (npad, npad), u (P, npad) and "
                         f"n ≤ npad, got {tuple(r.shape)}, {tuple(u.shape)}, "
                         f"{n}")
    P = u.shape[0]
    if r.device.type == "cpu":
        w2, tau2 = qr_append_build_plain(r, u, n)
        if w is None:
            return w2, tau2
        w.copy_(w2)
        tau.copy_(tau2)
        return w, tau
    if r.device.type != "cuda":
        raise SlateError(f"{name}: unsupported device {r.device}")
    if r.is_conj() or r.is_neg() or r.stride(1) != 1:
        raise SlateError(f"{name}: r must be a row-major view")
    if w is None:
        w = torch.zeros((P, npad), dtype=r.dtype, device=r.device)
        tau = torch.zeros(npad, dtype=r.dtype, device=r.device)
    else:
        if not (w.shape == (P, npad) and tau.shape == (npad,)
                and w.is_contiguous() and tau.is_contiguous()):
            raise SlateError(f"{name}: w must be ({P}, {npad}) and tau "
                             f"({npad},), both contiguous")
        w.zero_()
        tau.zero_()
    if n == 0:
        return w, tau
    u = _resolved(u).contiguous()
    ctas = -(-npad // P7_COLS)
    progress = torch.zeros(ctas, dtype=torch.int32, device=r.device)
    f = _fn("qr_append", f"slate_qr_append_build_{_SUFFIX[r.dtype]}",
            [_P, _L, _P, _P, _P, _I, _I, _I, _I, _P, _P])
    rc = _on_device(r, f, r.data_ptr(), r.stride(0), u.data_ptr(),
                    w.data_ptr(), tau.data_ptr(), n, npad, P, ctas,
                    progress.data_ptr())
    if rc:
        _raise_on(rc, "qr_append", "slate_qr_append_error_string",
                  f"{name} (npad={npad}, P={P}, n={n})")
    _count(name, r)
    return w, tau


class P8Plan(NamedTuple):
    """A P8 call on q right-hand-side columns: ``ctas`` CTAs of
    ``threads`` threads on ``cols`` columns (``lanes`` to a column, lanes
    l·lanes … l·lanes + lanes − 1 on the CTA's column l, each holding
    P/lanes entries of its d), which also stage the operands: ``step``
    reflectors (and ct's rows) staged at a time, ``bufs`` chunks of them
    in flight in ``smem_bytes``."""
    ctas: int
    threads: int
    lanes: int
    cols: int
    step: int
    bufs: int
    smem_bytes: int


def qr_append_apply_lanes(P: int, complex_: bool) -> int:
    """P8's lanes per column (csrc/qr_append.cu ``apply_lanes``): two from
    P8_SPLIT_P appended rows on, or P8_SPLIT_P / 2 in complex types."""
    return 2 if P * (2 if complex_ else 1) >= P8_SPLIT_P else 1


def qr_append_apply_smem(P: int, itemsize: int, complex_: bool) -> int:
    """P8's dynamic shared memory (csrc/qr_append.cu ``apply_smem_bytes``):
    P8_BUFS buffers of a chunk's w (P entries a step), tau and ct slots (one
    per column of the CTA)."""
    cols = P8_THREADS // qr_append_apply_lanes(P, complex_)
    return P8_BUFS * P8_STEP * (P + 1 + cols) * itemsize


def qr_append_apply_plan(q: int, P: int, dtype: torch.dtype) -> P8Plan:
    """P8's launch for ``q`` columns at P appended rows of ``dtype``: the
    constants of csrc/qr_append.cu, ⌈q / cols⌉ CTAs."""
    if q < 1:
        raise SlateError(f"qr_append_apply_plan: no plan for q = {q}")
    cx_ = dtype.is_complex
    lanes = qr_append_apply_lanes(P, cx_)
    cols = P8_THREADS // lanes
    return P8Plan(-(-q // cols), P8_THREADS, lanes, cols, P8_STEP,
                  P8_BUFS, qr_append_apply_smem(
                      P, torch.empty((), dtype=dtype).element_size(), cx_))


def qr_append_apply_launch_smem(P: int, dtype: torch.dtype) -> int:
    """The shared memory per CTA that the C launcher gives P8
    (``slate_qr_append_apply_smem_bytes_*``); ``chip_smoke.py`` holds the
    plan's ``smem_bytes`` against it. Needs the built kernel."""
    return _fn("qr_append", "slate_qr_append_apply_smem_bytes_"
               f"{_SUFFIX[dtype]}", [_I], ctypes.c_longlong)(P)


def qr_append_apply_plain(ct: torch.Tensor, d: torch.Tensor, w: torch.Tensor,
                          tau: torch.Tensor, n: int) -> None:
    """Plain version of P8 (the forward sweep of the reference's
    ``appended_gels``, slate_tpu/linalg/update.py:275-286), IN PLACE on
    ``ct`` (npad, q): per column j < n, [ct[j]; d] ← (I − tau_j·v·vᴴ)·
    [ct[j]; d] with v = [1; w[:, j]]; ``d`` (P, q) is read on a working
    copy."""
    dm = _resolved(d).clone()
    for j in range(n):
        top, dm = _reflect_rows(ct[j], dm, w[:, j], tau[j])
        ct[j] = top


def qr_append_apply(ct: torch.Tensor, d: torch.Tensor, w: torch.Tensor,
                    tau: torch.Tensor, n: int) -> None:
    """P8: applies the n appended reflectors of ``qr_append_build`` (w
    (P, npad), tau (npad,)) to [ct; d] IN PLACE on ``ct`` (npad, q): the
    top rows' Qᴴ·B that the base factor's ``unmqr`` made, and ``d`` (P, q)
    the appended rows' right-hand sides, zero beyond the live rows (read,
    never written). Column j touches only ct's row j and d, which is all
    that is carried from step to step.

    No Pallas counterpart: replaces the forward scan of the reference's
    ``appended_gels`` (slate_tpu/linalg/update.py:275-286). The CUDA kernel
    (csrc/qr_append.cu, plan ``qr_append_apply_plan``) gives each
    right-hand-side column one lane, or two from P8_SPLIT_P appended rows
    on (P8_SPLIT_P / 2 in complex types; each lane holds half of the
    column's d in registers, the first sums its half of the products, the
    second continues from that partial, so the sum keeps its order),
    P8_THREADS such threads a CTA. They copy the reflectors and ct's rows
    by cp.async P8_BUFS − 1 chunks of P8_STEP steps ahead (w transposed, a
    step's P entries side by side; tau; ct's rows in 16-byte copies where
    aligned), and each reads a step's operands from shared memory one step
    ahead, so no global load sits on a step; each finished entry goes back
    by a plain store. Arithmetic as the plain version's, rounded apart,
    steps in order."""
    name = "qr_append_apply"
    _check_append(name, ct, d, "d")
    if w.dtype != ct.dtype or tau.dtype != ct.dtype:
        raise SlateError(f"{name}: w and tau must match ct's type")
    if ct.ndim != 2 or d.ndim != 2 or d.shape[1] != ct.shape[1] or (
            w.shape != (d.shape[0], ct.shape[0])) or not 0 <= n <= ct.shape[0]:
        raise SlateError(f"{name}: expects ct (npad, q), d (P, q), w "
                         f"(P, npad), got {tuple(ct.shape)}, {tuple(d.shape)},"
                         f" {tuple(w.shape)}")
    if ct.device.type == "cpu":
        qr_append_apply_plain(ct, d, w, tau, n)
        return
    if ct.device.type != "cuda":
        raise SlateError(f"{name}: unsupported device {ct.device}")
    if ct.is_conj() or ct.is_neg() or ct.stride(1) != 1:
        raise SlateError(f"{name}: ct must be a row-major view")
    npad, q = ct.shape
    P = d.shape[0]
    if n == 0 or q == 0:
        return
    d = _resolved(d).contiguous()
    w = _resolved(w).contiguous()
    tau = _resolved(tau).contiguous()
    f = _fn("qr_append", f"slate_qr_append_apply_{_SUFFIX[ct.dtype]}",
            [_P, _L, _P, _P, _P, _I, _I, _I, _I, _P])
    rc = _on_device(ct, f, ct.data_ptr(), ct.stride(0), d.data_ptr(),
                    w.data_ptr(), tau.data_ptr(), n, npad, q, P)
    if rc:
        _raise_on(rc, "qr_append", "slate_qr_append_error_string",
                  f"{name} (npad={npad}, q={q}, P={P}, n={n})")
    _count(name, ct)


# ---------------------------------------------------------------------------
# P9: the secular roots of a divide-and-conquer merge (no Pallas kernel)
# ---------------------------------------------------------------------------

SECULAR_BISECT = 55   # halvings: the bracket to w·2⁻⁵⁵, full f64 accuracy
SECULAR_NEWTON = 4    # bracket-safeguarded Newton steps after them
SECULAR_FIXED = 2     # near-pole fixed-point steps
SECULAR_CHUNK = 2048  # roots a plain-version pass takes (k × chunk temporaries)
# P9's plan (csrc/secular.cu's plan_for, from k alone): a root's pole sums
# over SECULAR_MIN_LANES to 32 lanes of a warp, at most SECULAR_MAX_WARPS
# warps a CTA, the poles resident in shared memory up to
# SECULAR_RESIDENT_MAX (16 bytes a pole within the 227 KB a CTA may take),
# else staged SECULAR_TILE at a time
SECULAR_MAX_WARPS = 16
SECULAR_MIN_LANES = 4
SECULAR_SMS = 132     # the H100's SMs: one wave of CTAs where k allows
SECULAR_RESIDENT_MAX = 14336
SECULAR_TILE = 4096
SECULAR_SMEM_MAX = 232448
# P9 against its plain version (chip_smoke.py): the roots
# λ_j = δ[shift_j] + μ_j within SECULAR_ROOT_C·ε₆₄·max(max|δ|, ρ) (both
# bracket each root to about w·2⁻⁵⁵ and sum the same terms in other
# orders), and the merge's eigenvectors built from the kernel's
# (shift, μ) orthogonal to k·SECULAR_ORTH
SECULAR_ROOT_C = 64.0
SECULAR_ORTH = 1e-14


class P9Plan(NamedTuple):
    """P9's launch at k roots: ``ctas`` CTAs of ``warps`` warps, each
    root's pole sums over ``lanes`` lanes (32 / lanes roots a warp), the
    poles ``resident`` in shared memory for the whole schedule or staged
    SECULAR_TILE at a time, ``smem`` dynamic shared bytes a CTA."""
    ctas: int
    warps: int
    lanes: int
    resident: bool
    smem: int


def secular_roots_plan(k: int) -> P9Plan:
    """P9's plan for k roots, from k alone (csrc/secular.cu's ``plan_for``,
    which the launch takes): the widest lanes a root of 32, 16, 8, 4 whose
    k·lanes/32 root-warps fit one wave of SECULAR_MAX_WARPS-warp CTAs on
    SECULAR_SMS SMs; as few warps a CTA as spread the roots over every SM;
    the poles resident where 16·k bytes fit (k ≤ SECULAR_RESIDENT_MAX).
    The roots' bits depend on ``lanes`` alone (the order of each sum)."""
    if k < 1:
        raise SlateError(f"secular_roots_plan: no plan for k = {k}")
    lanes = 32
    while lanes > SECULAR_MIN_LANES and (
            k * lanes > 32 * SECULAR_SMS * SECULAR_MAX_WARPS):
        lanes //= 2
    per_warp = 32 // lanes
    warps = min(SECULAR_MAX_WARPS, -(-k // (per_warp * SECULAR_SMS)))
    resident = k <= SECULAR_RESIDENT_MAX
    return P9Plan(-(-k // (per_warp * warps)), warps, lanes, resident,
                  16 * (k if resident else SECULAR_TILE))


def _secular_f(gap: torch.Tensor, m: torch.Tensor, z2: torch.Tensor,
               rho: float) -> torch.Tensor:
    """1 + ρ·Σᵢ z2ᵢ / (gapᵢ − m) for each root's row of ``gap``, a zero
    denominator replaced by 1e-300."""
    denom = gap - m[:, None]
    denom = torch.where(denom == 0, 1e-300, denom)
    return 1.0 + rho * (z2[None, :] / denom).sum(dim=1)


def secular_roots_plain(delta: torch.Tensor, z2: torch.Tensor, rho: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of P9: all k roots of 1 + ρ·Σ z2ᵢ/(δᵢ − λ) = 0 for
    δ ascending, z2 > 0, ρ > 0 (float64). Returns (upper, μ): root j is
    λ_j = δ[j + upper_j] + μ_j, shifted to its nearer pole as dlaed4 does,
    so δᵢ − λ_j = (δᵢ − δ[shift_j]) − μ_j never cancels.

    The reference's host ``_secular_roots`` (slate_tpu/linalg/stedc.py:
    74-168) in torch, stage for stage over chunks of SECULAR_CHUNK roots:
    the pole chosen by the sign of f at the interval's midpoint, 55
    bisections, 4 Newton steps that also shrink the bracket, and 2
    fixed-point steps μ = ρ·z2ₚ/(1 + ρ·Σ_{i≠p} …) for the roots closer to
    their pole than the bisection resolves. One guard is the port's own:
    a fixed-point candidate must lie inside the bisection's bracket. The
    reference accepts any candidate of the right sign below 1e-5 of the
    interval, so a root about 1e-7 of the interval from a pole of
    negligible weight, whose place the other poles set (the rest of f
    nearly zero there), jumps to a false root at the pole: 2e-7 off on
    glued Wilkinson matrices (ROADMAP queue 3)."""
    k = delta.numel()
    dev = delta.device
    width = torch.empty_like(delta)
    width[:-1] = delta[1:] - delta[:-1]
    width[-1] = rho * z2.sum()  # last interval: (δ_k, δ_k + ρ‖z‖²)
    mu = torch.empty_like(delta)
    upper_all = torch.empty(k, dtype=torch.bool, device=dev)
    for c0 in range(0, k, SECULAR_CHUNK):
        c1 = min(c0 + SECULAR_CHUNK, k)
        j = torch.arange(c0, c1, device=dev)
        w = width[c0:c1]
        notlast = j < k - 1
        fmid = _secular_f(delta[None, :] - delta[j][:, None], 0.5 * w, z2,
                          rho)
        upper = (fmid < 0) & notlast  # f < 0 there: the root's upper half
        sj = j + upper.long()
        upper_all[c0:c1] = upper
        gap = delta[None, :] - delta[sj][:, None]
        zero = torch.zeros_like(w)
        lo = torch.where(upper, -0.5 * w, zero)
        hi = torch.where(upper, zero, torch.where(notlast, 0.5 * w, w))
        for _ in range(SECULAR_BISECT):
            mid = 0.5 * (lo + hi)
            up = _secular_f(gap, mid, z2, rho) < 0
            lo = torch.where(up, mid, lo)
            hi = torch.where(up, hi, mid)
        blo, bhi = lo, hi  # the bisection's bracket of the root
        m = 0.5 * (lo + hi)
        for _ in range(SECULAR_NEWTON):
            denom = gap - m[:, None]
            denom = torch.where(denom == 0, 1e-300, denom)
            r = z2[None, :] / denom
            f = 1.0 + rho * r.sum(dim=1)
            fp = rho * (r / denom).sum(dim=1)  # f' = ρ·Σ z2/denom²
            up = f < 0  # every evaluation also shrinks the bracket
            lo = torch.where(up, m, lo)
            hi = torch.where(up, hi, m)
            m_new = m - torch.where(fp > 0, f / fp, zero)
            bad = (m_new <= lo) | (m_new >= hi) | ~torch.isfinite(m_new)
            m = torch.where(bad, 0.5 * (lo + hi), m_new)
        # roots below the bisection's resolution need relative accuracy,
        # or the revised ẑ inflates a tiny component (dlaed4's rational
        # correction)
        zp2 = z2[sj]
        colmask = torch.zeros((c1 - c0, k), dtype=torch.bool, device=dev)
        colmask[torch.arange(c1 - c0, device=dev), sj] = True
        weff = torch.where(upper, 0.5 * w, w)
        near_pole = m.abs() < 1e-6 * weff
        want = torch.where(upper, -1.0, 1.0).to(delta.dtype)
        for _ in range(SECULAR_FIXED):
            denom = gap - m[:, None]
            denom = torch.where(colmask | (denom == 0), 1e300, denom)
            rest = 1.0 + rho * (z2[None, :] / denom).sum(dim=1)
            cand = rho * zp2 / torch.where(rest == 0, 1e-300, rest)
            ok = (torch.isfinite(cand) & (rest != 0)
                  & (torch.sign(cand) == want) & (cand.abs() < 1e-5 * weff)
                  & (cand >= blo) & (cand <= bhi))
            m = torch.where(near_pole & ok, cand, m)
        mu[c0:c1] = m
    return upper_all, mu


def secular_roots(delta: torch.Tensor, z2: torch.Tensor, rho: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P9: the k roots of a merge's secular equation, (upper, μ) with
    root j = δ[j + upper_j] + μ_j (``secular_roots_plain``'s contract):
    δ ascending and z2 > 0 as 1-D float64 tensors of one length on one
    device, ρ > 0 a float. Any other type raises.

    No Pallas counterpart: replaces the reference's df32 sweep
    ``_secular_kernel_body`` (slate_tpu/linalg/stedc.py:171-290, a
    ``lax.map`` of ``fori_loop``s XLA fuses into one program) and its host
    ``_secular_roots`` (:74-168). The CUDA kernel (csrc/secular.cu) runs
    the plain version's whole schedule in one launch: the pole choice, 55
    bisections, 4 safeguarded Newton steps and 2 fixed-point steps. Each
    root's sums are split over a group of lanes of one warp (the plan
    ``secular_roots_plan(k)``): lane l sums poles l, l + L, … in order,
    one branch-free reciprocal a term (its denominator clamped to
    |den| ≥ 1e-300, sign kept), and a fixed xor butterfly gives every lane
    of the group the same f bit for bit, so the schedule stays uniform.
    The poles stay in shared memory for the whole launch up to
    SECULAR_RESIDENT_MAX, else are staged SECULAR_TILE at a time each
    pass. The widths δ_{j+1} − δ_j and ρ‖z‖² are made in the kernel. Its
    sums run in another order than the plain version's, so the two agree
    within SECULAR_ROOT_C·ε·max(max|δ|, ρ) on the roots; a pole choice
    flipped where f at the midpoint is within rounding of zero changes
    (upper, μ) but not the root. Two launches on one input give the same
    bits."""
    name = "secular_roots"
    if delta.dtype != torch.float64 or z2.dtype != torch.float64:
        raise SlateError(f"{name}: float64 only, got {delta.dtype} and "
                         f"{z2.dtype}")
    if delta.ndim != 1 or z2.shape != delta.shape or delta.numel() < 1 or (
            z2.device != delta.device):
        raise SlateError(f"{name}: expects δ and z2 of one length k ≥ 1 on "
                         f"one device, got {tuple(delta.shape)} on "
                         f"{delta.device} and {tuple(z2.shape)} on "
                         f"{z2.device}")
    if delta.device.type == "cpu":
        return secular_roots_plain(delta, z2, float(rho))
    if delta.device.type != "cuda":
        raise SlateError(f"{name}: unsupported device {delta.device}")
    delta = delta.contiguous()
    z2 = z2.contiguous()
    k = delta.numel()
    upper = torch.empty(k, dtype=torch.bool, device=delta.device)
    mu = torch.empty_like(delta)
    f = _fn("secular", "slate_secular_roots_f64",
            [_P, _P, ctypes.c_double, _P, _P, _I, _P])
    rc = _on_device(delta, f, delta.data_ptr(), z2.data_ptr(), float(rho),
                    upper.data_ptr(), mu.data_ptr(), k)
    if rc:
        _raise_on(rc, "secular", "slate_secular_error_string",
                  f"{name} (k={k})")
    _count(name, mu)
    return upper, mu
