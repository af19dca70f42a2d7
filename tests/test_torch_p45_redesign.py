"""The Hopper designs of P4 ``chol_tile_batched`` and P5
``qr_panel_batched`` on the CPU, where their kernels cannot run.

- P5's plan (``qr_panel_batched_plan``): every row of an item has one
  owner, the shared memory fits 227 KB, the team and storage at the
  smoke's shapes, no dependence on B, the refusals.
- A plain-torch emulation of P5's column step as the kernel orders it
  (rows owned by the threads of the plan's team, the partials
  p[c] = Σ x_r·a[r][c] over each thread's rows, a transposing butterfly
  in each warp, the warps summed in order, w_row[c] = a[j][c] +
  scale·p[c]) held to ``qr_panel_batched_plain`` within
  4·ε·max(√H, w), with the same NaN, zero-column and degenerate-column
  behaviour; an item's bits do not depend on the stack around it.
- A model of P4's staging indices (every lower entry loaded once, every
  entry stored once, every shared index inside its tile) and a
  plain-torch emulation of its lookahead step order, bit for bit
  ``chol_tile_batched_plain``.
- The launchers refuse a tensor that is neither on the CPU nor on a
  CUDA device, and count no launch.

Inputs are numpy from a seed; the fault items (``_chol_items``,
``_qr_items``) and the reference's own checks of the plain versions are
in ``tests/test_torch_batched.py``.
"""

import math
import os
import re
import zlib

import numpy as np
import pytest
import torch

from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.ops import hopper_ops
# the fault items the plain versions are held to the reference on
from test_torch_batched import _chol_items, _qr_items

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(hopper_ops.__file__), os.pardir, "csrc")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _constant(src: str, name: str) -> int:
    with open(os.path.join(CSRC, src)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


# ---------------------------------------------------------------------------
# P5's plan
# ---------------------------------------------------------------------------

PLAN = hopper_ops.qr_panel_batched_plan
SHAPES = [(hh, w, it) for it in (4, 8) for w in (1, 7, 32, 33, 64, 128)
          for hh in (w, 40, 64, 65, 100, 256, 257, 512, 513, 1000, 2000,
                     5000) if hh >= w]


def test_p5_constants_match_the_kernel():
    assert hopper_ops.P5_THREADS == _constant("qr_panel_batched.cu",
                                              "kMemThreads")
    assert hopper_ops.P5_WARP_ITEMS == _constant("qr_panel_batched.cu",
                                                 "kWarpItems")


@pytest.mark.parametrize("it", [4, 8])
def test_p5_plan_every_row_has_one_owner(it):
    for hh, w, it_ in SHAPES:
        if it_ != it:
            continue
        p = PLAN(hh, w, it)
        owners = np.zeros(hh, int)
        for t in range(p.threads):
            for k in range(p.rows_per_thread):
                if t + k * p.threads < hh:
                    owners[t + k * p.threads] += 1
        assert (owners == 1).all(), (hh, w, it, p)
        assert p.threads % 32 == 0 and 32 <= p.threads <= 256
        assert (p.rows_per_thread - 1) * p.threads < hh
        if p.storage == "registers":  # the kernel's kR slots a thread
            assert w <= 32 and p.rows_per_thread <= 8 // it
        assert p.smem_bytes <= hopper_ops.PANEL_SMEM_LIMIT
        assert p.smem_bytes == hopper_ops.qr_panel_batched_smem_bytes(
            hh, w, it, p.storage, p.threads)


@pytest.mark.parametrize("shape,want", [
    # the engine's panels, then the smoke's other shapes
    ((512, 32, 4), ("cta", 256, 1, 2, "registers")),
    ((64, 32, 4), ("warp", 32, 4, 2, "registers")),
    ((512, 32, 8), ("cta", 256, 1, 2, "shared")),
    ((2000, 128, 4), ("cta", 256, 1, 8, "streaming")),
    ((1000, 128, 8), ("cta", 256, 1, 4, "streaming")),
    ((7, 7, 4), ("warp", 32, 4, 1, "registers")),
    ((100, 1, 8), ("cta", 128, 1, 1, "registers")),
    ((256, 32, 4), ("cta", 128, 1, 2, "registers")),
    ((40, 40, 8), ("cta", 64, 1, 1, "shared")),
    # both sides of every boundary, float32 and float64
    ((65, 32, 4), ("cta", 64, 1, 2, "registers")),
    ((32, 32, 8), ("warp", 32, 4, 1, "registers")),
    ((33, 32, 8), ("cta", 64, 1, 1, "registers")),
    ((513, 32, 4), ("cta", 256, 1, 3, "shared")),
    ((256, 32, 8), ("cta", 256, 1, 1, "registers")),
    ((257, 32, 8), ("cta", 256, 1, 2, "shared")),
    ((100, 33, 4), ("cta", 128, 1, 1, "shared")),
    ((1743, 32, 4), ("cta", 256, 1, 7, "shared")),
    ((1744, 32, 4), ("cta", 256, 1, 7, "streaming"))])
def test_p5_plan_at_the_smoke_shapes(shape, want):
    p = PLAN(*shape)
    assert (p.team, p.threads, p.items_per_cta, p.rows_per_thread,
            p.storage) == want


def test_p5_plan_reads_no_batch_size():
    """The plan is a function of the item alone, so no B can change an
    item's reduction order (the launcher passes it the item shape)."""
    import inspect
    assert list(inspect.signature(PLAN).parameters) == ["hh", "w",
                                                        "itemsize"]


@pytest.mark.parametrize("bad", [(8, 9, 4), (200, 129, 4), (10, 0, 4),
                                 (2 ** 24, 128, 4), (64, 32, 2)])
def test_p5_plan_refuses(bad):
    with pytest.raises(SlateError):
        PLAN(*bad)


# ---------------------------------------------------------------------------
# P5's column step, emulated in the kernel's order
# ---------------------------------------------------------------------------

def _butterfly(part):
    """(warps, 32, w) lane partials → (warps, w): column c's sum over the
    32 lanes as reduce_scatter orders it, lane c mod 32 keeping it."""
    nw, _, w = part.shape
    ci = torch.arange(w) % 32
    lanes = torch.arange(32)
    p = part.clone()
    for o in (16, 8, 4, 2, 1):
        keep = ((lanes[:, None] & o) == (ci[None, :] & o))
        p = torch.where(keep, p + p[:, lanes ^ o, :], p)
    return p[:, ci, torch.arange(w)]


def _p5_emulate_item(a, plan):
    """One (H, w) item through the kernel's column steps with ``plan``'s
    team: thread t owns rows t, t + n, …; each thread's partials in row
    order, then the butterfly, then the warps in order from 0."""
    hh, w = a.shape
    n, rows = plan.threads, plan.rows_per_thread
    m = torch.zeros((rows * n, w), dtype=a.dtype)
    m[:hh] = a
    taus = torch.zeros(w, dtype=a.dtype)
    r_idx = torch.arange(rows * n)
    for j in range(w):
        below = (r_idx > j) & (r_idx < hh)
        contrib = torch.where(below[:, None], m[:, j:j + 1] * m, 0)
        acc = torch.zeros((n, w), dtype=a.dtype)
        for k in range(rows):
            acc = acc + contrib[k * n:(k + 1) * n]
        warps = _butterfly(acc.reshape(n // 32, 32, w))
        p = torch.zeros(w, dtype=a.dtype)
        for q in range(n // 32):
            p = p + warps[q]
        beta, tau, scale = hopper_ops.larfg(m[j, j], p[j])
        taus[j] = tau
        w_row = m[j] + scale * p
        live = (r_idx >= j) & (r_idx < hh)
        v = torch.where(r_idx == j, torch.ones((), dtype=a.dtype),
                        m[:, j] * scale)
        upd = (tau * v)[:, None] * w_row[None, :]
        m[:, j + 1:] = torch.where(live[:, None], m[:, j + 1:] - upd[:, j + 1:],
                                   m[:, j + 1:])
        m[:, j] = torch.where(r_idx == j, beta,
                              torch.where(live, v, m[:, j]))
    return m[:hh], taus


def _p5_emulate(stack):
    """The emulation over a (B, H, w) stack, each item with the plan of
    its own shape."""
    bsz, hh, w = stack.shape
    plan = PLAN(hh, w, stack.element_size())
    out = [_p5_emulate_item(stack[b], plan) for b in range(bsz)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


P5_CASES = [(64, 32, np.float32), (40, 24, np.float32), (9, 9, np.float32),
            (64, 32, np.float64), (40, 24, np.float64), (9, 9, np.float64),
            (40, 40, np.float64), (300, 40, np.float64)]


@pytest.mark.parametrize("hh,w,dt", P5_CASES,
                         ids=[f"{h}x{w}-{d.__name__}" for h, w, d in P5_CASES])
def test_p5_emulation_within_tolerance_of_plain(hh, w, dt):
    a = torch.from_numpy(_qr_items(hh, w, dt))
    vk, tk = _p5_emulate(a)
    vp, tp = hopper_ops.qr_panel_batched_plain(a)
    tol = 4 * torch.finfo(a.dtype).eps * max(math.sqrt(hh), w)
    upper = torch.ones((hh, w), dtype=torch.bool).triu()
    for i in (0, 1, 3):
        rmax = torch.where(upper, vp[i], 0).abs().max()
        assert (torch.where(upper, vk[i] - vp[i], 0).abs().max()
                <= tol * rmax)
        assert torch.where(upper, 0, vk[i] - vp[i]).abs().max() <= tol
        assert (tk[i] - tp[i]).abs().max() <= tol
    # the zero column and the degenerate columns: tau = 0, alpha kept
    assert tk[1, 2] == 0 == tp[1, 2]
    assert tk[3, 0] == 0 and tk[3, 1] == 0
    assert vk[3, 0, 0] == a[3, 0, 0] and vk[3, 1, 1] == 3.0
    # the NaN stays in its item, in its columns from the NaN on
    top = min(w, hh - 1)
    assert torch.isnan(tk[2, 3:top]).all()
    assert torch.isfinite(tk[2, :3]).all()
    assert torch.isfinite(vk[2, :, :3]).all()
    assert torch.isfinite(vk[[0, 1, 3]]).all()
    assert torch.equal(torch.isnan(tk[2]), torch.isnan(tp[2]))


@pytest.mark.parametrize("hh,w,dt", [(64, 32, np.float32),
                                     (70, 20, np.float64),
                                     (300, 40, np.float64)])
def test_p5_emulation_is_batch_independent(hh, w, dt):
    """An item's bits at B = 1 are its bits inside a stack of 5."""
    stack = torch.from_numpy(
        _rng("b", hh, w).standard_normal((5, hh, w)).astype(dt))
    vs, ts = _p5_emulate(stack)
    for b in (0, 2, 4):
        v1, t1 = _p5_emulate(stack[b:b + 1])
        assert torch.equal(v1[0], vs[b]) and torch.equal(t1[0], ts[b])


# ---------------------------------------------------------------------------
# P4: the staging indices and the lookahead order
# ---------------------------------------------------------------------------

def _p4_ks(s):
    return 16 if s <= 16 else 32 if s <= 32 else 64


@pytest.mark.parametrize("s", range(1, 65))
def test_p4_staging_indices(s):
    """The kernel's load_quadrant/store_quadrant index expressions: every
    lower entry is read once and nothing above the diagonal, every entry
    of the (s, s) output is written once, and every tile and column
    buffer index stays inside its allocation."""
    ld = _constant("chol_tile_batched.cu", "kLd")
    ks = _p4_ks(s)
    kq = min(ks, 32)
    quads = [(0, 0)] + ([(1, 0), (1, 1)] if ks > 32 else [])
    loads = np.zeros((s, s), int)
    stores = np.zeros((s, s), int)
    lane = np.arange(32)
    for rb, cb in quads:
        for i in range(kq):  # the warp reads row 32·rb + i
            r, c = 32 * rb + i, 32 * cb + lane
            assert (i * ld + lane < 32 * ld).all()
            hit = (r < s) & (c <= r)
            np.add.at(loads, (np.full(hit.sum(), r), c[hit]), 1)
        for k in range(32):  # lane l takes row 32·rb + l from the tile
            assert (lane * ld + k < 32 * ld).all()
        for i in range(kq):  # stores: row 32·rb + i per instruction
            r, c = 32 * rb + i, 32 * cb + lane
            hit = (r < s) & (c < s)
            np.add.at(stores, (np.full(hit.sum(), r), c[hit]), 1)
    if ks > 32:  # the zero block above the diagonal, rows 0..31
        for i in range(32):
            c = 32 + lane
            hit = c < s
            np.add.at(stores, (np.full(hit.sum(), i), c[hit]), 1)
    assert np.array_equal(loads, np.tril(np.ones((s, s), int)))
    assert (stores == 1).all()
    # the column buffer: lane l writes entries l (and l + 32), every step
    # reads 16-byte groups g·kV … g·kV + kV − 1 < kS
    for kv in (4, 2):
        for j in range(ks - 1):
            for g in range((j + 2) // kv, ks // kv):
                assert g * kv + kv - 1 < ks


def _p4_emulate(d):
    """P4's step order on a (B, s, s) stack, items padded with zeros to
    kS rows: the column of step j, then column j + 1 takes step j, then
    step j + 1's pivot, root and column, then the rest of step j's update
    (columns j + 2 …); every difference and product rounded separately,
    info only for steps below s."""
    bsz, s, _ = d.shape
    ks = _p4_ks(s)
    m = torch.zeros((bsz, ks, ks), dtype=d.dtype)
    m[:, :s, :s] = torch.tril(d)
    info = torch.zeros(bsz, dtype=torch.int32)
    one = torch.ones((), dtype=d.dtype)
    rows = torch.arange(ks)

    def pivot(k):
        nonlocal info
        dk = m[:, k, k].clone()
        bad = torch.isnan(dk) | (dk <= 0)
        if k < s:
            info = torch.where((info == 0) & bad,
                               torch.full_like(info, k + 1), info)
        root = torch.sqrt(torch.where(bad, one, dk))
        col = torch.where(rows[None, :] > k, m[:, :, k] / root[:, None],
                          torch.where(rows[None, :] == k, root[:, None],
                                      torch.zeros((), dtype=d.dtype)))
        return col

    col = pivot(0)
    for j in range(ks):
        m[:, :, j] = col
        if j + 1 == ks:
            break
        below = rows > j
        k = j + 1
        m[:, below, k] = m[:, below, k] - col[:, below] * col[:, k:k + 1]
        nxt = pivot(k)
        if j + 2 < ks:
            m[:, j + 1:, j + 2:] = (m[:, j + 1:, j + 2:]
                                    - col[:, j + 1:, None] * col[:, None, j + 2:])
        col = nxt
    return torch.tril(m[:, :s, :s]), info


@pytest.mark.parametrize("s", [1, 7, 32, 33, 64])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_p4_lookahead_order_bitwise_plain(s, dt):
    d = torch.from_numpy(_chol_items(s, dt))
    lk, ik = _p4_emulate(d)
    lp, ip = hopper_ops.chol_tile_batched_plain(d)
    assert torch.equal(ik, ip)
    assert torch.equal(torch.isnan(lk), torch.isnan(lp))
    bits = torch.int32 if d.dtype == torch.float32 else torch.int64
    fin = ~torch.isnan(lp)
    assert torch.equal(lk.contiguous().view(bits)[fin],
                       lp.contiguous().view(bits)[fin])
    if s > 5:
        assert ip.tolist() == [0, 4, 6, s]


# ---------------------------------------------------------------------------
# the ablation's substitutions and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["chol_tile_batched", "qr_panel_batched"])
def test_ablation_variants_match_the_sources(name):
    """tools/p45_ablation.py cuts parts out of the kernels by text
    substitution: each of its variants must find its patterns in the
    sources as they are (a stale pattern would only show on the card)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "p45_ablation", os.path.join(os.path.dirname(__file__), os.pardir,
                                     "tools", "p45_ablation.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    for variant in tool.CUTS[name]:
        assert tool.substitute(src, name, variant) != src

@pytest.mark.parametrize("launcher,shape", [
    (hopper_ops.chol_tile_batched, (2, 8, 8)),
    (hopper_ops.qr_panel_batched, (2, 64, 32))])
def test_p45_refuse_a_meta_tensor(launcher, shape):
    hopper_ops.reset_launches()
    with pytest.raises(SlateError, match="unsupported device"):
        launcher(torch.empty(shape, device="meta"))
    assert not any(hopper_ops.LAUNCHES.values())
