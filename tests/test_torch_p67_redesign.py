"""The Hopper designs of P6 ``chol_update_sweep`` and P7
``qr_append_build`` on the CPU, where their kernels cannot run.

- The launchers' constants are the ``constexpr``s of
  ``csrc/chol_update.cu`` and ``csrc/qr_append.cu``; P6's plan gives
  every row one CTA and one warp, fits its shared memory in 227 KB (two
  CTAs an SM for a multi-CTA item), reads no batch size; P7's CTAs give
  every column one owner and fit 227 KB.
- A plain-torch emulation of P6 in the kernel's order: the CTAs' forward
  pipeline (phase 1: each published tile as a wavefront, or in column
  order with its live counts once a downdate has failed above), then
  each 32-column panel as a (column, vector) wavefront (at step t the
  front's lane l makes pair (j0 + l, t − l), then every row below applies
  the step's pairs), a panel with a failed downdate restored to its entry
  state and replayed in the plain version's order, the rows below
  applying the replayed live pairs. It is held bit for bit to
  ``chol_update_sweep_plain`` in float32, float64, complex64 and
  complex128 at kb ∈ {1, 2, 4, 16}, update and downdate, a failed
  downdate (info equal), zero lanes, and CTAs of 32 rows as well as the
  plan's.
- The same for P7's order: the CTAs' column blocks, the published
  reflectors first, then each 32-step chunk made by the front (the
  reflector's scalars on lane s, the tail divided entry by entry with one
  divisor), every column right of step j reflected; bit for bit
  ``qr_append_build_plain`` at P ∈ {1, 4, 16}, with a zero appended
  column and zero rows.

Inputs are numpy from a seed.
"""

import inspect
import math
import os
import re
import zlib

import numpy as np
import pytest
import torch

from slate_tpu_torch.ops import hopper_ops as ho

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(ho.__file__), os.pardir, "csrc")
TYPES = (np.float32, np.float64, np.complex64, np.complex128)
TORCH = {np.float32: torch.float32, np.float64: torch.float64,
         np.complex64: torch.complex64, np.complex128: torch.complex128}


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _constant(src: str, name: str) -> int:
    with open(os.path.join(CSRC, src)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


def _draw(rng, shape, dt):
    x = rng.standard_normal(shape)
    if np.iscomplexobj(np.zeros(1, dt)):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dt)


def _sizes(dt):
    t = TORCH[dt]
    it = torch.empty((), dtype=t).element_size()
    return it, it // 2 if t.is_complex else it


# ---------------------------------------------------------------------------
# constants and plans
# ---------------------------------------------------------------------------

def test_constants_match_the_kernels():
    assert ho.P6_TILE == _constant("chol_update.cu", "kTw")
    assert ho.P6_ONE_CTA == _constant("chol_update.cu", "kMaxThreads")
    assert ho.P6_SMEM_MAX == _constant("chol_update.cu", "kSmemMax")
    assert ho.P7_COLS == _constant("qr_append.cu", "kCols")
    assert ho.P7_STEP == _constant("qr_append.cu", "kStep")
    assert ho.P8_THREADS == _constant("qr_append.cu", "kApplyThreads")
    assert ho.P6_ROWS % ho.P6_TILE == 0 and ho.P6_ROWS <= ho.P6_ONE_CTA


def test_p6_smem_formula_is_the_kernels():
    with open(os.path.join(CSRC, "chol_update.cu")) as f:
        src = f.read()
    body = re.search(r"size_t smem_bytes\(int rows, int kb, int bufs\) "
                     r"\{(.*?)\}", src, re.S).group(1)
    assert "(size_t)bufs * rows * (kTw + 1) * sizeof(T)" in body
    assert "(size_t)2 * (kTw + kb) * kb * (sizeof(T) + sizeof(real_t<T>))" \
        in body
    assert "(size_t)2 * kTw * sizeof(int)" in body
    assert ho.chol_update_smem(128, 16, 4, 4, 2) == (
        2 * 128 * 33 * 4 + 2 * (32 + 16) * 16 * 8 + 2 * 32 * 4)


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("kb", ho.UPDATE_BUCKETS)
def test_p6_plan_every_row_has_one_owner_and_fits(dt, kb):
    it, rit = _sizes(dt)
    for n in (1, 31, 32, 33, 100, 255, 256, 257, 300, 2000, 16384, 16385):
        p = ho.chol_update_plan(n, kb, it, rit)
        assert p.rows % 32 == 0 and 32 <= p.rows <= ho.P6_ONE_CTA
        assert (p.ctas - 1) * p.rows < n <= p.ctas * p.rows
        owner = np.zeros(n, int)
        for b in range(p.ctas):
            for w in range(p.rows // 32):
                lo = b * p.rows + 32 * w
                owner[lo:min(n, lo + 32)] += 1
        assert (owner == 1).all()
        smem = ho.chol_update_smem(p.rows, kb, it, rit, p.bufs)
        assert smem <= ho.P6_SMEM_MAX
        if p.ctas > 1:  # two CTAs an SM keep the cooperative launch resident
            assert 2 * (smem + 1024) <= ho.P6_SMEM_PER_SM
        if p.bufs == 1:  # two buffers would not have fitted
            two = ho.chol_update_smem(p.rows, kb, it, rit, 2)
            assert two > (ho.P6_SMEM_MAX if p.ctas == 1
                          else ho.P6_SMEM_PER_SM // 2 - 1024)
    assert ho.chol_update_plan(16384, kb, it, rit).ctas == 128


def test_plans_read_no_batch_size():
    names = set(inspect.signature(ho.chol_update_plan).parameters)
    assert names == {"n", "kb", "itemsize", "real_itemsize"}
    assert ho.chol_update_plan(16384, 16, 4) == (128, 128, 2)
    assert ho.chol_update_plan(256, 2, 4) == (1, 256, 2)
    # complex128 at kb = 16: one buffer (two would not leave two CTAs an SM)
    assert ho.chol_update_plan(2000, 16, 16, 8).bufs == 1
    assert ho.chol_update_plan(256, 16, 16, 8) == (1, 256, 1)


@pytest.mark.parametrize("dt", TYPES)
def test_p7_columns_have_one_owner_and_fit(dt):
    it, _ = _sizes(dt)
    for P in ho.UPDATE_BUCKETS:
        smem = (2 * ho.P7_STEP * ho.P7_COLS + 2 * ho.P7_STEP * P
                + 2 * ho.P7_STEP) * it
        assert smem <= ho.P6_SMEM_MAX
    for npad in (1, 127, 128, 129, 2048, 8192):
        ctas = -(-npad // ho.P7_COLS)
        owner = np.zeros(npad, int)
        for b in range(ctas):
            for w in range(ho.P7_COLS // ho.P7_STEP):
                lo = b * ho.P7_COLS + w * ho.P7_STEP
                owner[lo:min(npad, lo + ho.P7_STEP)] += 1
        assert (owner == 1).all()


# ---------------------------------------------------------------------------
# P6: the kernel's order, emulated
# ---------------------------------------------------------------------------

def _rot(l, x, c, s, down):
    """The kernel's rotate: (l, x) ← (c·l ± conj(s)·x, c·x − s·l)."""
    t = ho.cx_mul(s.conj(), x)
    cl = ho._scale_real(l, c)
    return (cl - t if down else cl + t), ho._scale_real(x, c) - ho.cx_mul(
        s, l)


def _pair(d, x, down, tiny):
    """(c, s, ok) of the diagonal d and the vector entry x."""
    ljj = d.real if d.is_complex() else d
    ax2 = ho.abs2(x)
    l2 = ljj * ljj
    r2 = l2 - ax2 if down else l2 + ax2
    r = torch.sqrt(torch.maximum(r2, tiny))
    return ljj / r, ho.cx_div_real(x, r), not (down and bool(r2 <= 0))


def p6_emulate(l, w, sign, n, ctas, rows, tw=32):
    """P6 in the kernel's order on one item, IN PLACE on ``l`` (npad,
    npad); ``w`` (npad, kb) read on a copy. Returns info. The warps of a
    CTA are run one after another: a warp writes only its own rows and
    reads only the pairs the fronts above it released."""
    L = l
    x = w.T.clone()
    kb = x.shape[0]
    down = sign < 0
    rdt = L.real.dtype if L.is_complex() else L.dtype
    tiny = torch.tensor(torch.finfo(rdt).tiny, dtype=rdt)
    info = [0]
    pub = {}  # column → (c (kb,), s (kb,), live)

    def wave(pairs, rows, j0, t, lim=None):
        """step t of a panel's wavefront on ``rows`` (lim: the front's
        rows apply only the columns left of their own)."""
        for k in range(kb):
            cc = t - k
            if (j0 + cc, k) in pairs:
                c, s_ = pairs[(j0 + cc, k)]
                for r in rows:
                    if lim is None or r > j0 + cc:
                        L[r, j0 + cc], x[k, r] = _rot(L[r, j0 + cc],
                                                      x[k, r], c, s_, down)

    def columns(final, live, rows, j0, wd):
        for cc in range(wd):
            for i in range(live[cc]):
                c, s_ = final[(j0 + cc, i)]
                for r in rows:
                    L[r, j0 + cc], x[i, r] = _rot(L[r, j0 + cc], x[i, r],
                                                  c, s_, down)

    for b in range(ctas):
        r0, r1 = b * rows, min(n, (b + 1) * rows)
        every = range(r0, r1)
        frozen = [False]
        # 1. the columns published by the CTAs above, 32 at a time: as a
        # wavefront over (column, vector), or in column order once a
        # published column has fewer than kb live pairs
        for j0 in range(0, r0, tw):
            cols = range(j0, min(j0 + tw, r0))
            frozen[0] |= any(pub[cc][2] < kb for cc in cols)
            pairs = {(cc, i): (pub[cc][0][i], pub[cc][1][i]) for cc in cols
                     for i in range(pub[cc][2])}
            if frozen[0]:
                columns(pairs, [pub[cc][2] for cc in cols], every, j0,
                        len(cols))
            else:
                for t in range(len(cols) + kb - 1):
                    wave(pairs, every, j0, t)
        # 2. the diagonal block, warp by warp
        panels = {}  # p → released pairs, state, final pairs, live

        def geometry(p):
            j0 = r0 + p * tw
            wd = min(tw, r1 - j0)
            return j0, wd, list(range(j0, j0 + wd))

        def follow(p, mine):
            q = panels[p]
            j0, wd, _ = geometry(p)
            if q["state"] == "frozen":
                return
            entry = (L[mine].clone(), x[:, mine].clone())
            for t in range(wd + kb - 1):
                wave(q["released"], mine, j0, t)
            if q["state"] == "replayed":
                L[mine], x[:, mine] = entry
                columns(q["final"], q["live"], mine, j0, wd)

        def front_step(p, t, d, released, bad):
            j0, wd, lanes = geometry(p)
            for lane in range(wd):
                i = t - lane
                if 0 <= i < kb:
                    r = lanes[lane]
                    c, s_, ok = _pair(d[lane], x[i, r], down, tiny)
                    bad[0] |= not ok
                    d[lane], _ = _rot(d[lane], x[i, r], c, s_, down)
                    released[(r, i)] = (c, s_)
            wave(released, lanes, j0, t, lim=True)

        def front_end(p, d, released, bad, entry_x):
            j0, wd, lanes = geometry(p)
            q = panels[p]
            if not bad[0]:
                for lane, r in enumerate(lanes):
                    L[r, r] = d[lane]
                q.update(state="clean", final=dict(released),
                         live=[kb] * wd)
                return
            # restore the entry state, replay in the plain order
            L[lanes, j0:j0 + wd] = q["entry_l"]
            x[:, lanes] = entry_x
            final, live, going = {}, [], True
            for cc, j in enumerate(lanes):
                lv = 0
                for i in range(kb):
                    if not going:
                        break
                    c, s_, ok = _pair(L[j, j], x[i, j], down, tiny)
                    if not ok:
                        info[0], going = j + 1, False
                        break
                    L[j, j], _ = _rot(L[j, j], x[i, j], c, s_, down)
                    final[(j, i)] = (c, s_)
                    for r in lanes[cc + 1:]:
                        L[r, j], x[i, r] = _rot(L[r, j], x[i, r], c, s_,
                                                down)
                    lv = i + 1
                live.append(lv)
            frozen[0] |= not going
            q.update(state="replayed", final=final, live=live)

        def front(p):
            j0, wd, lanes = geometry(p)
            if frozen[0]:
                panels[p] = dict(state="frozen", released={}, final={},
                                 live=[0] * wd)
                return
            panels[p] = dict(state="running",
                             entry_l=L[lanes, j0:j0 + wd].clone())
            entry_x = x[:, lanes].clone()
            d = [L[r, r].clone() for r in lanes]
            released, bad = {}, [False]
            panels[p]["released"] = released
            for t in range(wd + kb - 1):
                front_step(p, t, d, released, bad)
            front_end(p, d, released, bad, entry_x)

        nwarps = -(-(r1 - r0) // 32)
        for wp in range(nwarps):
            mine = list(range(r0 + 32 * wp, min(r0 + 32 * wp + 32, r1)))
            for p in range(wp):
                follow(p, mine)
            front(wp)
        for p, q in panels.items():
            j0, wd, _ = geometry(p)
            for cc in range(wd):
                lv = q["live"][cc]
                pub[j0 + cc] = (
                    [q["final"][(j0 + cc, i)][0] for i in range(lv)],
                    [q["final"][(j0 + cc, i)][1] for i in range(lv)], lv)
    return info[0]


def _p6_operands(dt, n, npad, kb, k, scale, seed):
    rng = _rng("p6", seed, dt.__name__, n, kb, k)
    x = _draw(rng, (n, n), np.complex128 if np.iscomplexobj(
        np.zeros(1, dt)) else np.float64)
    a = x @ x.conj().T / n + 2 * np.eye(n)
    l = np.zeros((npad, npad), dt)
    l[:n, :n] = np.linalg.cholesky(a)
    w = np.zeros((npad, kb), dt)
    w[:n, :k] = scale * _draw(rng, (n, k), dt)
    return torch.tensor(l), torch.tensor(w)


def _p6_against_plain(dt, n, npad, kb, k, sign, scale, ctas, rows, seed=0):
    l, w = _p6_operands(dt, n, npad, kb, k, scale, seed)
    le, lp = l.clone(), l.clone()
    ie = p6_emulate(le, w, sign, n, ctas, rows)
    ip = int(ho.chol_update_sweep_plain(lp, w, sign, n))
    return le, lp, ie, ip, l


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("kb", [1, 2, 4, 16])
@pytest.mark.parametrize("sign", [1, -1])
def test_p6_wavefront_order_is_the_plain_version(dt, kb, sign):
    # three CTAs of 32 rows (phase 1 and the panel hand-off) and the plan's
    # one CTA of 96 rows (three panels, the warps below following)
    n, npad = 70, 96
    for ctas, rows in ((3, 32), tuple(ho.chol_update_plan(n, kb, 8))[:2]):
        le, lp, ie, ip, _ = _p6_against_plain(dt, n, npad, kb, kb, sign,
                                              0.05, ctas, rows)
        assert ie == ip == 0
        assert torch.equal(le, lp), (ctas, rows)


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("kb", [1, 2, 4, 16])
def test_p6_failed_downdate_replays_the_panel(dt, kb):
    n, npad = 70, 96
    for ctas, rows in ((3, 32), (1, 96)):
        le, lp, ie, ip, l0 = _p6_against_plain(dt, n, npad, kb, kb, -1, 3.0,
                                               ctas, rows, seed=1)
        assert ie == ip > 0
        jf = ip - 1
        # the columns left of the failure, the frozen column and the rest
        # (the latter unchanged from the factor) bit for bit
        assert torch.equal(le[:, :jf], lp[:, :jf])
        assert torch.equal(le[:, jf:], lp[:, jf:])
        assert torch.equal(lp[jf + 1:, jf + 1:], l0[jf + 1:, jf + 1:])
        assert bool(torch.isfinite(le).all())


def test_p6_failure_inside_a_wavefront_panel_is_replayed():
    # a failure at vector 3 of column 40: the front has made pairs of the
    # columns after it (e.g. (41, 0..1)) before it sees it
    dt, kb, n, npad = np.float64, 4, 64, 64
    l, w = _p6_operands(dt, n, npad, kb, kb, 0.02, 5)
    w[40, 3] = 2.0 * float(l[40, 40]) + 1.0
    le, lp = l.clone(), l.clone()
    ie = p6_emulate(le, w, -1, n, 1, 64)
    ip = int(ho.chol_update_sweep_plain(lp, w, -1, n))
    assert ie == ip == 41
    assert torch.equal(le, lp)


@pytest.mark.parametrize("dt", TYPES)
def test_p6_zero_lanes_are_no_ops_in_the_kernel_order(dt):
    n, npad = 70, 96
    l, w = _p6_operands(dt, n, npad, 4, 2, 0.1, 2)
    le = l.clone()
    p6_emulate(le, torch.zeros_like(w), 1, n, 3, 32)
    assert torch.equal(le, l)
    l4, l8 = l.clone(), l.clone()
    w8 = torch.cat([w, torch.zeros_like(w)], 1)
    p6_emulate(l4, w, 1, n, 3, 32)
    p6_emulate(l8, w8, 1, n, 3, 32)
    lp = l.clone()
    ho.chol_update_sweep_plain(lp, w, 1, n)
    assert torch.equal(l4, l8) and torch.equal(l4, lp)


# ---------------------------------------------------------------------------
# P7: the kernel's order, emulated
# ---------------------------------------------------------------------------

def _reflector(alpha, col):
    """The front's reflector as the kernel makes it: the scalars on the
    owner's lane, the tail divided entry by entry by one divisor."""
    xn2 = ho.abs2(col[0])
    for p in range(1, col.shape[0]):
        xn2 = xn2 + ho.abs2(col[p])
    an = ho.cx_abs(alpha)
    one = torch.ones_like(alpha)
    phase = ho.cx_div_real(alpha, an) if bool(an > 0) else one
    beta = ho._scale_real(-phase, torch.sqrt(an * an + xn2))
    inert = bool(xn2 == 0)
    tj = torch.zeros_like(alpha) if inert else ho.cx_div(
        beta - alpha, ho.cx_divisor(beta))
    dv = ho.cx_divisor(one if inert else alpha - beta)
    tail = torch.stack([torch.zeros_like(alpha) if inert else
                        ho.cx_div(col[p], dv) for p in range(col.shape[0])])
    return (alpha if inert else beta), tj, tail


def p7_emulate(r, u, n, cols=128, step=32):
    """P7 in the kernel's order, IN PLACE on ``r``; returns (w, tau)."""
    npad = r.shape[1]
    umat = u.clone()
    w = torch.zeros_like(umat)
    tau = torch.zeros(npad, dtype=r.dtype)
    for b in range(-(-npad // cols)):
        c0, c1 = b * cols, min(npad, (b + 1) * cols)
        blk = slice(c0, c1)
        for j in range(min(c0, n)):  # 1. the published reflectors
            top, mat = ho._reflect_rows(r[j, blk], umat[:, blk], w[:, j],
                                        tau[j])
            r[j, blk], umat[:, blk] = top, mat
        for j0 in range(c0, min(c1, n), step):  # 2. chunk by chunk
            for j in range(j0, min(j0 + step, n)):
                d, tj, wj = _reflector(r[j, j], umat[:, j])
                w[:, j], tau[j] = wj, tj
                r[j, j] = d
                umat[:, j] = 0
                right = slice(j + 1, c1)  # the front's lanes, then the rest
                top, mat = ho._reflect_rows(r[j, right], umat[:, right], wj,
                                            tj)
                r[j, right], umat[:, right] = top, mat
    return w, tau


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("P", [1, 4, 16])
def test_p7_lookahead_order_is_the_plain_version(dt, P):
    rng = _rng("p7", dt.__name__, P)
    npad, n = 150, 140
    r = np.triu(_draw(rng, (npad, npad), dt))
    np.fill_diagonal(r, math.sqrt(4 * n))
    u = np.zeros((P, npad), dt)
    live = max(1, P - 1)  # a zero appended row
    u[:live, :n] = _draw(rng, (live, n), dt)
    # zero appended columns 0..7: inert reflectors (tau = 0, alpha kept)
    u[:, :8] = 0
    for cols, step in ((128, 32), (32, 8)):
        re_, rp = torch.tensor(r), torch.tensor(r)
        we, te = p7_emulate(re_, torch.tensor(u), n, cols, step)
        wp, tp = ho.qr_append_build_plain(rp, torch.tensor(u), n)
        assert torch.equal(re_, rp) and torch.equal(we, wp)
        assert torch.equal(te, tp)
        assert float(te[:8].abs().max()) == 0.0 and torch.equal(
            re_.diagonal()[:8], torch.tensor(r).diagonal()[:8])
    zr = torch.tensor(r)
    p7_emulate(zr, torch.zeros((P, npad), dtype=zr.dtype), n)
    assert torch.equal(zr, torch.tensor(r))
