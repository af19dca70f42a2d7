"""The Hopper design of P8 ``qr_append_apply`` on the CPU, where its kernel
cannot run.

- The launcher's constants and shared-memory formula are those of
  ``csrc/qr_append.cu``; the plan gives every right-hand-side column one
  owner and fits 227 KB in every type at every bucket P.
- A plain-torch emulation of the kernel's order: a chunk of P8_STEP
  reflectors staged a chunk ahead into two buffers laid out as the
  kernel's shared memory (w transposed, tau, the column owner's slots of
  ct's rows, every index held inside the formula's bytes), each column
  reflected step by step from the staged values and stored back at once;
  a column on two lanes sums its first half of the products and continues
  from that partial on the second lane. It is held bit for bit
  to ``qr_append_apply_plain`` in float32, float64, complex64 and
  complex128 at P ∈ {1, 4, 16}, with n not a multiple of the chunk,
  n < npad, n = 0, tau = 0 columns, zero appended rows, q not a multiple
  of the CTA, signed zeros, and the plan's constants as well as narrower
  CTAs, every column on two lanes and shorter chunks.

Inputs are numpy from a seed.
"""

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
TORCH_OF = {np.float32: torch.float32, np.float64: torch.float64,
            np.complex64: torch.complex64, np.complex128: torch.complex128}
SMEM_MAX = 232448  # an H100 CTA's dynamic shared memory


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _source() -> str:
    with open(os.path.join(CSRC, "qr_append.cu")) as f:
        return f.read()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source()).group(1))


def _draw(rng, shape, dt):
    x = rng.standard_normal(shape)
    if np.iscomplexobj(np.zeros(1, dt)):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dt)


def _itemsize(dt) -> int:
    return np.dtype(dt).itemsize


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The raw bits of x (signed zeros and NaNs told apart)."""
    x = torch.view_as_real(x) if x.is_complex() else x
    return x.contiguous().view({4: torch.int32, 8: torch.int64}[
        x.element_size()])


def _same(a, b) -> bool:
    return torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# constants and plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, const", [
    ("P8_THREADS", "kApplyThreads"), ("P8_STEP", "kApplyStep"),
    ("P8_BUFS", "kApplyBufs"), ("P8_SPLIT_P", "kApplySplitP")])
def test_constants_match_the_kernel(name, const):
    assert getattr(ho, name) == _constant(const)


def test_smem_and_lanes_are_the_kernels():
    src = _source()
    body = re.search(r"size_t apply_smem_bytes\(int P\) \{(.*?)\}", src,
                     re.S).group(1)
    assert ("(size_t)kApplyBufs * kApplyStep *\n         (P + 1 + "
            "kApplyThreads / apply_lanes<T>(P)) * sizeof(T)") in body
    lanes = re.search(r"constexpr int apply_lanes\(int P\) \{(.*?)\}", src,
                      re.S).group(1)
    assert ("P * (sizeof(T) == sizeof(real_t<T>) ? 1 : 2) >= kApplySplitP ? 2"
            in lanes)
    # the launch sizes the kernel and its grid by the same functions
    assert "apply_smem_bytes<T>(P);" in src
    assert "const int per_cta = kApplyThreads / apply_lanes<T>(P);" in src
    assert "(q + per_cta - 1) / per_cta, kApplyThreads, smem," in src
    for P in ho.UPDATE_BUCKETS:
        assert ho.qr_append_apply_lanes(P, False) == (
            2 if P >= ho.P8_SPLIT_P else 1)
        assert ho.qr_append_apply_lanes(P, True) == (
            2 if 2 * P >= ho.P8_SPLIT_P else 1)
    assert ho.qr_append_apply_smem(16, 4, False) == 3 * 32 * (16 + 1 + 64) * 4


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("P", ho.UPDATE_BUCKETS)
def test_plan_every_column_has_one_owner_and_fits(dt, P):
    it, cx_ = _itemsize(dt), np.iscomplexobj(np.zeros(1, dt))
    for q in (1, 31, 32, 63, 64, 65, 127, 128, 129, 200, 512, 1000):
        plan = ho.qr_append_apply_plan(q, P, TORCH_OF[dt])
        assert plan.threads == ho.P8_THREADS and plan.step == ho.P8_STEP
        assert plan.bufs == ho.P8_BUFS
        assert plan.lanes == ho.qr_append_apply_lanes(P, cx_)
        assert plan.cols == ho.P8_THREADS // plan.lanes
        assert P % plan.lanes == 0 and ho.P8_THREADS % 32 == 0
        assert plan.smem_bytes == ho.qr_append_apply_smem(P, it, cx_) \
            <= SMEM_MAX
        # whole 16-byte copies of a CTA's columns of a row
        assert plan.cols * it % 16 == 0
        assert (plan.ctas - 1) * plan.cols < q <= plan.ctas * plan.cols
        # lane t < P8_THREADS of CTA b: column b·cols + t // lanes, entries
        # (t % lanes)·P/lanes … of its d; a pair never straddles a warp
        owner = np.zeros((plan.ctas * plan.cols, P), int)
        h = P // plan.lanes
        for b in range(plan.ctas):
            for t in range(ho.P8_THREADS):
                owner[b * plan.cols + t // plan.lanes,
                      (t % plan.lanes) * h:(t % plan.lanes + 1) * h] += 1
                assert t // 32 == (t - t % plan.lanes) // 32
        assert (owner == 1).all()
    with pytest.raises(ho.SlateError):
        ho.qr_append_apply_plan(0, P, TORCH_OF[dt])


def test_served_plan():
    # appended_gels pads q to whole 512-wide tiles: eight CTAs of 64
    # columns at q = 512 and P = 16; complex types split from P = 8
    f32, c128 = torch.float32, torch.complex128
    assert ho.qr_append_apply_plan(512, 16, f32) == (
        8, 128, 2, 64, 32, 3, 31104)
    assert ho.qr_append_apply_plan(512, 8, f32) == (
        4, 128, 1, 128, 32, 3, 52608)
    assert ho.qr_append_apply_plan(512, 8, c128).lanes == 2
    assert ho.qr_append_apply_plan(512, 16, c128).smem_bytes == 124416
    # the largest: complex128 at P = 4, one lane a column
    assert ho.qr_append_apply_plan(512, 4, c128).smem_bytes == 204288


# ---------------------------------------------------------------------------
# the kernel's order, emulated
# ---------------------------------------------------------------------------

def _step(top, dm, w, tj, lanes):
    """One step on a CTA's columns (top (k,), dm (P, k)) as the kernel's
    lanes make it: on one lane the plain reflection; on two, the first
    lane's half of the products summed, the second half added on to that
    partial, then ct's entry."""
    if lanes == 1:
        return ho._reflect_rows(top, dm, w, tj)
    P = dm.shape[0]
    prod = [ho.cx_mul(w[p].conj(), dm[p]) for p in range(P)]
    acc = prod[0]
    for p in range(1, P // 2):
        acc = acc + prod[p]
    for p in range(P // 2, P):
        acc = acc + prod[p]
    vy = top + acc
    new_top = top - ho.cx_mul(tj, vy)
    new_d = dm - ho.cx_mul(tj, ho.cx_mul(w[:, None], vy[None, :]))
    return new_top, new_d


def p8_emulate(ct, d, w, tau, n, threads, lanes, step, bufs):
    """P8 in the kernel's order, IN PLACE on ``ct`` (npad, q): per CTA,
    chunks of ``step`` steps staged ``bufs`` − 1 chunks ahead into a flat
    model of its shared memory (``bufs`` buffers, the kernel's offsets),
    every column reflected step by step from the staged values and stored
    at once."""
    npad, q = ct.shape
    P = d.shape[0]
    cols = threads // lanes
    elems = bufs * step * (P + 1 + cols)
    for b in range(-(-q // cols)):
        smem = torch.full((elems,), float("nan"), dtype=ct.dtype)
        s_w, s_tau = 0, bufs * step * P
        s_top = s_tau + bufs * step
        colof = torch.arange(b * cols, (b + 1) * cols)
        live = colof < q
        dm = torch.zeros((P, cols), dtype=ct.dtype)
        dm[:, live] = d[:, colof[live]]

        def stage(buf, j0, cnt):  # the staging warp's copies, in order
            for idx in range(step * P):
                s, p = idx % step, idx // step
                if s < cnt:
                    smem[s_w + buf * step * P + s * P + p] = w[p, j0 + s]
            for t in range(cnt):
                smem[s_tau + buf * step + t] = tau[j0 + t]
            for s in range(cnt):  # a row across the CTA, zero past q
                o = s_top + buf * step * cols + s * cols
                smem[o:o + cols] = 0
                smem[o:o + int(live.sum())] = ct[j0 + s, colof[live]]

        for i in range(bufs - 1):
            if i * step < n:
                stage(i, i * step, min(step, n - i * step))
        buf = 0
        for j0 in range(0, n, step):
            cnt, ahead = min(step, n - j0), j0 + (bufs - 1) * step
            if ahead < n:
                stage((buf + bufs - 1) % bufs, ahead, min(step, n - ahead))
            for s in range(cnt):
                o = s_top + buf * step * cols + s * cols
                top = smem[o:o + cols].clone()
                o = s_w + buf * step * P + s * P
                wv = smem[o:o + P].clone()
                tj = smem[s_tau + buf * step + s]
                top, dm = _step(top, dm, wv, tj, lanes)
                ct[j0 + s, colof[live]] = top[live]
            buf = (buf + 1) % bufs


def _operands(dt, npad, n, q, P, p_live, seed):
    """ct (npad, q), d (P, q) with p_live live rows, and the reflectors of
    a P7 run on an R of npad² with P appended rows (zero columns 0..4:
    tau = 0 there)."""
    rng = _rng("p8", seed)
    r = np.triu(_draw(rng, (npad, npad), dt))
    np.fill_diagonal(r, math.sqrt(4 * max(n, 1)))
    u = np.zeros((P, npad), dt)
    u[:p_live, :n] = _draw(rng, (p_live, n), dt)
    u[:, :5] = 0
    w, tau = ho.qr_append_build_plain(torch.tensor(r), torch.tensor(u), n)
    ct = torch.tensor(_draw(rng, (npad, q), dt))
    d = torch.zeros((P, q), dtype=ct.dtype)
    d[:p_live] = torch.tensor(_draw(rng, (p_live, q), dt))
    return ct, d, w, tau


def _layouts(P, dt):
    """The plan's (threads, lanes, step, bufs), then 64-thread CTAs with
    every column on two lanes (P > 1), 8-step chunks and two buffers."""
    cx_ = np.iscomplexobj(np.zeros(1, dt))
    return [(ho.P8_THREADS, ho.qr_append_apply_lanes(P, cx_), ho.P8_STEP,
             ho.P8_BUFS), (64, 2 if P > 1 else 1, 8, 2)]


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("P", [1, 4, 16])
def test_staged_order_is_the_plain_version(dt, P):
    # n = 77: not a multiple of any chunk, below npad = 90; q = 150: not a
    # multiple of any CTA's columns; one zero appended row where P > 1
    npad, n, q = 90, 77, 150
    ct, d, w, tau = _operands(dt, npad, n, q, P, max(1, P - 1), (dt, P))
    assert float(tau[:5].abs().max()) == 0.0  # inert reflectors
    want = ct.clone()
    ho.qr_append_apply_plain(want, d, w, tau, n)
    for threads, lanes, step, bufs in _layouts(P, dt):
        got = ct.clone()
        p8_emulate(got, d, w, tau, n, threads, lanes, step, bufs)
        assert _same(got, want)
    assert _same(want[n:], ct[n:])  # rows past n untouched


@pytest.mark.parametrize("dt", TYPES)
def test_no_op_cases_in_the_kernel_order(dt):
    npad, n, q, P = 70, 64, 40, 4
    ct, d, w, tau = _operands(dt, npad, n, q, P, 3, (dt, "noop"))
    for threads, lanes, step, bufs in _layouts(P, dt):
        # n = 0: nothing staged, nothing written
        got = ct.clone()
        p8_emulate(got, d, w, tau, 0, threads, lanes, step, bufs)
        assert _same(got, ct)
        # zero reflectors (tau = 0, w = 0): exact no-ops
        got = ct.clone()
        p8_emulate(got, d, torch.zeros_like(w), torch.zeros_like(tau), n,
                   threads, lanes, step, bufs)
        assert _same(got, ct)
        # a zero appended row changes no bit: the same sweep at bucket 8
        got4, got8 = ct.clone(), ct.clone()
        p8_emulate(got4, d, w, tau, n, threads, lanes, step, bufs)
        p8_emulate(got8, torch.cat([d, torch.zeros_like(d)]),
                   torch.cat([w, torch.zeros_like(w)]), tau, n, threads,
                   lanes, step, bufs)
        assert _same(got4, got8)
        want = ct.clone()
        ho.qr_append_apply_plain(want, d, w, tau, n)
        assert _same(got4, want)


@pytest.mark.parametrize("dt", TYPES)
def test_zero_rows_across_the_split(dt):
    # P = 4 on one lane and the same rows at bucket 16, on two lanes
    npad, n, q = 70, 64, 72
    ct, d, w, tau = _operands(dt, npad, n, q, 4, 4, (dt, "split"))
    cx_ = np.iscomplexobj(np.zeros(1, dt))
    assert ho.qr_append_apply_lanes(4, cx_) == 1
    assert ho.qr_append_apply_lanes(16, cx_) == 2
    got4, got16 = ct.clone(), ct.clone()
    p8_emulate(got4, d, w, tau, n, ho.P8_THREADS, 1, ho.P8_STEP, ho.P8_BUFS)
    z = torch.zeros((12,) + d.shape[1:], dtype=d.dtype)
    p8_emulate(got16, torch.cat([d, z]), torch.cat([
        w, torch.zeros((12, npad), dtype=w.dtype)]), tau, n, ho.P8_THREADS,
        2, ho.P8_STEP, ho.P8_BUFS)
    assert _same(got4, got16)


@pytest.mark.parametrize("dt", TYPES)
def test_signed_zeros_across_the_split(dt):
    # every product −0 and ct's entries −0: the two-lane sum must keep the
    # signs of the one-lane sum (a partial started from +0 would not)
    npad, n, q, P = 40, 33, 20, 16
    ct = torch.full((npad, q), -0.0, dtype=TORCH_OF[dt])
    d = torch.full((P, q), -0.0, dtype=ct.dtype)
    if ct.is_complex():
        ct = torch.complex(ct.real, ct.real)
        d = torch.complex(d.real, d.real)
    rng = _rng("p8 zeros", dt)

    def positive(shape):  # positive parts
        x = _draw(rng, shape, dt)
        return torch.tensor((np.abs(x.real) + 1j * np.abs(x.imag)).astype(
            dt) if np.iscomplexobj(x) else np.abs(x))

    w, tau = positive((P, npad)), positive((npad,))
    want = ct.clone()
    ho.qr_append_apply_plain(want, d, w, tau, n)
    for threads, lanes, step, bufs in _layouts(P, dt):
        got = ct.clone()
        p8_emulate(got, d, w, tau, n, threads, lanes, step, bufs)
        assert _same(got, want)
