#!/usr/bin/env python3
"""Where the port's Cholesky, LU and QR factors and solves spend their
time, on one NVIDIA GPU.

    python3 profile_factors.py            # n=16384, nb=512, float32
    python3 profile_factors.py --n 2048   # a shorter run
    python3 profile_factors.py --factors chol,chol_f64   # only these
    python3 profile_factors.py --solves chol,lu,qr,chol_nb128  # solves only
    python3 profile_factors.py --factors heev_qr,heev_2stage,hegv
    python3 profile_factors.py --factors heev_dc,hegv
    python3 profile_factors.py --factors svd_dc

By default factors the SPD (n × n, op "chol", at nb and at nb = n/128,
where potrf takes its recursion and K1 runs at b = n/128), the general
(n × n, op "lu") and the tall (2n × n/2, op "qr") operators of
chip_smoke.py's main phase once each. ``--factors`` picks some of
those, or "nopiv" (the main phase's diagonally dominant n × n operator,
op "lu" with MethodLU.NoPiv: getrf_nopiv, 2048 P1 launches at
n = 16384), "calu" (the general operator with MethodLU.CALU:
getrf_tntpiv, 161 P3 launches at n = 16384), or of three that run a kernel in another plan mode: "chol_f64"
(the SPD operator in float64 at nb, K1 at b = nb f64), "chol_nb1024"
(in float32 at nb = 1024, K1 at b = 1024) and "qr_f64_nb32" (an
8n × 64 float64 operator at nb = 32, K3 at (8n, 32) f64), or the
complex64 ones: "chol_c64" and "lu_c64" (Hermitian positive definite
and general, at nb), "chol_c64_nb128" (at nb = n/128, where potrf's
recursion updates its trailing blocks by the complex 2×2 recursion of
gemms, K5 having no complex instance) and "qr_c64" (the tall 2n × n/2
operator at nb: K4's complex64 instance and the trailing CGEMMs), or
the low-precision factors of refined float32 operators (Session
``refine=RefinePolicy("bfloat16")``): "chol_bf16" (the SPD operator at
nb: K1's and P1's bf16 routes and bf16 gemms), "chol_bf16_nb128" (at
nb = n/128: a bfloat16 potrf whose recursion's trailing updates are K5's
bf16 instance, its tiles K1's bf16 route) and "lu_bf16"
(the general operator at nb: K2's and P1's bf16 routes and bf16 gemms);
each line of those adds ``route_copies``: the bf16 routes' float32
copies in and rounded copies out, their count and the device time of the
kernels launched inside them (each copy under a ``record_function``
range in the profiled run; the unprofiled run is not timed per copy,
since CUDA events around a copy in a host-bound factor would time the
host's launch gap too). Each runs
through a Session that has factored every kind and type it profiles
once at n = 1024 (so that one-time set-up of libraries and kernels is
not in the profile), under torch.profiler (CPU and CUDA activity), then
once more without it, and prints one
JSON line per factor: the wall time under the profiler (the profiler
slows the host, so this is not the factor time) and without it (host
clock ending in a sync: the factor time), the summed time of its
device events (kernels, copies, sets; no host op is counted, so nothing
twice) and its share of that wall, the count of device events, the
device time and launches of each of the port's own kernels (by kernel
name; "qr_panel" is K3 and K4, which share one kernel body), P3's
launches by (B, H, w) stack shape with the cluster plan each took
(``p3_rounds``, counted in the unprofiled run), the stream time of
potrf's recursive trailing updates (``herk_lower_rec``: its outermost
calls between CUDA events in the unprofiled run, and their share of
that wall), the device time of the cuBLAS gemm kernels (every device
event whose name holds "gemm", or "nvjet" in bf16) and its share of the
busy time beside the port's kernels' shares (``shares``), and the top
twelve device events by device time and host ops by self CPU time.

``--factors`` also takes the Hermitian eigensolvers, "heev_qr" (heev
with MethodEig.QR through he2td), "heev_2stage" (through he2hb and the
hb2td bulge chase), "heev_dc" (MethodEig.DC through he2td: stedc) and
"hegv" (itype 1 under its default method, Auto: stedc at n ≥ 2048), of
a symmetrized Gaussian float64 operator at ``--eig-n`` (4096) and
``--eig-nb`` (256), after a warm-up of each at 512: besides the walls,
busy time, events and the port's kernels (P9 ``secular_roots``
included), each stage's device and CPU time (a ``record_function``
range per stage: he2td, he2hb, hb2td, stedc, the back-transforms,
potrf, hegst; the host steqr is the wall they leave), the
matrix-vector kernels' device time beside the latrd columns' bytes
bound, and the columns and hops of he2td's and hb2td's sequential
chains. "svd_dc" profiles svd with vectors of an n × n float32
Gaussian at ``--svd-n`` (8192) and ``--svd-nb`` (1024) under Auto (the
DC arm: ge2bd, bdsqr on stedc, the back-transforms), after a warm-up at
2048, under torch.profiler with CUDA activity only: the same walls,
busy share and kernels, each SVD stage's ms by CUDA events
(``obs/stages.SVD_STAGES``), the matrix-vector kernels' device time
beside the bytes bound of ge2bd's two products a labrd column, and
device events a column.

``--solves`` (alone it runs no factor) profiles one-column solves
against the resident factors of the same operators (names as above:
chol, lu, qr, chol_nb128, at chip_smoke.py's serve phase's shapes),
eager and replayed from the CUDA graph ``Session.warmup`` captures, on
the same factor and right-hand side: for each, one solve under the
profiler (device events, busy ms, the port's kernels) and the
unprofiled wall of SOLVE_REPS more (median, min, max; host clock ending
in a sync), the capture's wall and bytes, and whether the two answers
are equal bit for bit. The last line is the card's nvidia-smi name and
power limit. Exits 2 without a CUDA device. Imports nothing of JAX and
nothing of slate_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the port's kernels by the names of their __global__ functions in csrc/
KERNEL_FUNCS = {"chol_tile": "chol_tile_kernel",
                "lu_panel_base": "lu_panel_kernel",
                "qr_panel": "qr_panel_kernel",
                "herk_lower_update": "herk_lower_kernel",
                "trtri_leaves": "trtri_leaves_kernel",
                "lu_nopiv_base": "lu_nopiv_kernel",
                "lu_panel_batched": "lu_panel_batched_kernel",
                "secular_roots": "secular_roots_kernel"}


def register(torch, stt, sess, shape, op, nb, gen, dtype):
    refine = None
    if op.endswith("_bf16"):  # a refined operator: its bf16 factor
        op, refine = op[:-len("_bf16")], stt.RefinePolicy("bfloat16")
    a = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    if op == "chol":  # SPD (HPD), as chip_smoke.py's main phase makes it
        a = a @ a.mH / shape[0]
        a.diagonal().add_(1.0)
        return sess.register(stt.hermitian(a, nb, stt.Uplo.Lower,
                                           device="cuda"), op=op,
                             refine=refine)
    if op == "nopiv":  # diagonally dominant, as chip_smoke.py's
        a = a / math.sqrt(shape[0])
        a.diagonal().add_(2.0)
        return sess.register(stt.from_dense(a, nb, device="cuda"), op="lu",
                             opts=stt.Options(method_lu=stt.MethodLU.NoPiv))
    if op == "calu":  # the general operator, tournament pivoting
        return sess.register(stt.from_dense(a, nb, device="cuda"), op="lu",
                             opts=stt.Options(method_lu=stt.MethodLU.CALU))
    return sess.register(stt.from_dense(a, nb, device="cuda"), op=op,
                         refine=refine)


ROUTE_RANGE = "bf16_route_copy"


@contextlib.contextmanager
def route_copies():
    """Each bf16 route copy made inside the block (``hopper_ops._upcast``
    in, the outermost ``_round_back`` out) under a ``record_function``
    range named ROUTE_RANGE, whose kernels the profiler attributes to it;
    yields a dict that counts the copies."""
    from torch.profiler import record_function
    from slate_tpu_torch.ops import hopper_ops as ho
    up, back = ho._upcast, ho._round_back
    out, depth = {"copies": 0}, [0]

    def ranged(fn):
        def run(x):
            depth[0] += 1
            try:
                if depth[0] > 1:  # _round_back's own recursion on a tuple
                    return fn(x)
                out["copies"] += 1
                with record_function(ROUTE_RANGE):
                    return fn(x)
            finally:
                depth[0] -= 1
        return run

    ho._upcast, ho._round_back = ranged(up), ranged(back)
    try:
        yield out
    finally:
        ho._upcast, ho._round_back = up, back


@contextlib.contextmanager
def p3_rounds():
    """Counts the P3 launches made inside the block by (B, H, w) stack,
    each with the plan it launched with (null on a tree without
    ``lu_panel_batched_plan_for``)."""
    from slate_tpu_torch.ops import hopper_ops as ho
    launch, plan_for = (ho.lu_panel_batched,
                        getattr(ho, "lu_panel_batched_plan_for", None))
    rounds = {}

    def counted(stack):
        key = "x".join(map(str, stack.shape))
        if key not in rounds:
            plan = plan_for(stack) if plan_for else None
            rounds[key] = {"launches": 0, "plan": plan and {
                "ctas": plan.ctas, "mode": plan.mode}}
        rounds[key]["launches"] += 1
        return launch(stack)

    ho.lu_panel_batched = counted
    try:
        yield rounds
    finally:
        ho.lu_panel_batched = launch


@contextlib.contextmanager
def herk_recursion(torch):
    """The stream time of the outermost ``blocked.herk_lower_rec`` calls
    made inside the block (CUDA events around each, read after the
    block): the trailing updates of potrf's 2×2 recursion, one K5 launch
    in real types, the recursion of gemms in complex ones. Between the
    events the stream may also wait for the host, so this bounds the
    device time of those updates from above."""
    from slate_tpu_torch.ops import blocked
    rec = blocked.herk_lower_rec
    events, depth = [], [0]

    def timed(*args, **kw):
        depth[0] += 1
        try:
            if depth[0] > 1:
                return rec(*args, **kw)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = rec(*args, **kw)
            ev[1].record()
            events.append(ev)
            return out
        finally:
            depth[0] -= 1

    out = {}
    blocked.herk_lower_rec = timed
    try:
        yield out
    finally:
        blocked.herk_lower_rec = rec
    torch.cuda.synchronize()
    out.update(calls=len(events),
               stream_ms=sum(a.elapsed_time(b) for a, b in events))


def dev_us(e):
    for k in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, k):
            return getattr(e, k)
    return 0.0


def on_device(e):  # a kernel, copy or set on the card, not a host op
    return str(e.device_type).endswith("CUDA")


def port_kernels(dev):
    """Device ms and launches of each of the port's kernels among the
    device events ``dev``."""
    return {k: {"device_ms": sum(dev_us(e) for e in mine) / 1e3,
                "count": sum(e.count for e in mine)}
            for k, func in KERNEL_FUNCS.items()
            for mine in [[e for e in dev if func in e.key]]}


def profile_factor(torch, stt, sess, shape, op, nb, dtype, gen, top=12):
    from torch.profiler import ProfilerActivity, profile

    h = register(torch, stt, sess, shape, op, nb, gen, dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            route_copies() as copies:
        t0 = time.perf_counter()
        info = sess.factor_info(h)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if info != 0:
        raise AssertionError(f"{op} factor: info {info}")
    sess.unregister(h)
    # the same factor again without the profiler: its wall time, and P3's
    # rounds by stack shape with their plans
    h = register(torch, stt, sess, shape, op, nb, gen, dtype)
    torch.cuda.synchronize()
    with p3_rounds() as rounds, herk_recursion(torch) as herk:
        t0 = time.perf_counter()
        sess.factor_info(h)
        torch.cuda.synchronize()
        unprofiled = time.perf_counter() - t0
    sess.unregister(h)
    events = prof.key_averages()
    ranges = [e for e in events if e.key == ROUTE_RANGE]
    copies["device_ms"] = max(
        [0.0] + [getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0)) / 1e3
                 for e in ranges])
    dev = [e for e in events if on_device(e) and e.key != ROUTE_RANGE]
    host = [e for e in events if not on_device(e)]
    busy_us = sum(dev_us(e) for e in dev)
    port = port_kernels(dev)
    # cuBLAS's gemm kernels ("nvjet" in its bf16 ones)
    gemm = [e for e in dev if "gemm" in e.key.lower() or "nvjet" in e.key]
    gemm_ms = sum(dev_us(e) for e in gemm) / 1e3
    return {
        "op": op, "shape": list(shape), "nb": nb,
        "dtype": str(dtype).split(".")[1], "wall_s": wall,
        "unprofiled_wall_s": unprofiled,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_events": sum(e.count for e in dev),
        "p3_rounds": rounds,
        # potrf's recursive trailing updates, in the unprofiled run
        "herk_lower_rec": {**herk, "share_of_unprofiled_wall":
                           herk["stream_ms"] / 1e3 / unprofiled},
        "port_kernels": port,
        **({"route_copies": copies} if copies["copies"] else {}),
        "gemm": {"device_ms": gemm_ms, "count": sum(e.count for e in gemm)},
        # shares of the device busy time
        "shares": {"gemm": gemm_ms * 1e3 / busy_us if busy_us else None,
                   **{k: v["device_ms"] * 1e3 / busy_us if busy_us else None
                      for k, v in port.items() if v["count"]}},
        "top_device": [{"name": e.key[:80], "count": e.count,
                        "device_ms": dev_us(e) / 1e3}
                       for e in sorted(dev, key=lambda e: -dev_us(e))[:top]],
        "top_host": [{"name": e.key[:80], "count": e.count,
                      "self_cpu_ms": e.self_cpu_time_total / 1e3}
                     for e in sorted(host,
                                     key=lambda e: -e.self_cpu_time_total)
                     [:top]]}


EIG_FACTORS = ("heev_qr", "heev_2stage", "heev_dc", "hegv")


def eig_ranges():
    """Each stage function heev and hegv call (``obs/stages.py``) under a
    ``record_function`` range "eig::<stage>", whose device events the
    profiler attributes to it."""
    from torch.profiler import record_function
    from slate_tpu_torch.obs.stages import wrapped_stages

    def ranged(name, fn):
        def run(*args, **kw):
            with record_function(f"eig::{name}"):
                return fn(*args, **kw)
        return run
    return wrapped_stages(ranged)


def profile_eig(torch, stt, name, n, nb, gen, top=12):
    """heev (MethodEig.QR; "heev_2stage" with eig_stage1 "two_stage";
    "heev_dc" MethodEig.DC) or hegv (itype 1, its default method) of a
    float64 operator (Gaussian, symmetrized; hegv's
    B = G·Gᵀ/n + I) under torch.profiler, then once more without it: the
    walls, device busy time and share, device events, the port's kernels,
    each stage's range (device ms, CPU ms, events), the matrix-vector
    kernels' ("gemv" in the name) device time beside the latrd columns'
    bytes bound, and events per he2td column and per hb2td hop."""
    from torch.profiler import ProfilerActivity, profile
    from slate_tpu_torch.linalg import eig
    g = torch.randn((n, n), generator=gen, device="cuda",
                    dtype=torch.float64)
    a = 0.5 * (g + g.T)
    A = stt.hermitian(a, nb, stt.Uplo.Lower, device="cuda")
    opts = stt.Options(method_eig=stt.MethodEig.DC if name == "heev_dc"
                       else stt.MethodEig.QR,
                       eig_stage1="two_stage" if name == "heev_2stage"
                       else "auto")
    if name == "hegv":
        opts = stt.Options()
        b = g @ g.T / n + torch.eye(n, dtype=g.dtype, device="cuda")
        B = stt.hermitian(b, nb, stt.Uplo.Lower, device="cuda")
        run = lambda: stt.hegv(A, B, opts)  # noqa: E731
    else:
        run = lambda: stt.heev(A, opts)  # noqa: E731
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, eig_ranges():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    events = prof.key_averages()
    ranges = {e.key[len("eig::"):]: e for e in events
              if e.key.startswith("eig::")}
    dev = [e for e in events if on_device(e) and not e.key.startswith("eig::")]
    host = [e for e in events if not on_device(e)
            and not e.key.startswith("eig::")]
    busy_us = sum(dev_us(e) for e in dev)
    gemv = [e for e in dev if "gemv" in e.key.lower()]
    npad = -(-n // nb) * nb
    hops = sum(eig.chase_hops(npad, nb))
    return {
        "n": n, "nb": nb, "dtype": "float64",
        "method": opts.method_eig.value, "wall_s": wall,
        "unprofiled_wall_s": unprofiled,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_events": sum(e.count for e in dev),
        "port_kernels": port_kernels(dev),
        "stages": {k: {"device_ms": getattr(e, "device_time_total",
                                            getattr(e, "cuda_time_total",
                                                    0.0)) / 1e3,
                       "cpu_ms": e.cpu_time_total / 1e3, "calls": e.count}
                   for k, e in ranges.items()},
        "gemv": {"device_ms": sum(dev_us(e) for e in gemv) / 1e3,
                 "count": sum(e.count for e in gemv),
                 # the latrd columns' matrix-vector products read the
                 # trailing block once each: Σ (npad − 1 − j)² entries
                 "bytes_bound_ms": sum((npad - 1 - j) ** 2
                                       for j in range(npad - 1))
                 * 8 / 3.35e12 * 1e3},
        "columns": npad - 1, "hops": hops,
        "top_device": [{"name": e.key[:80], "count": e.count,
                        "device_ms": dev_us(e) / 1e3}
                       for e in sorted(dev, key=lambda e: -dev_us(e))[:top]],
        "top_host": [{"name": e.key[:80], "count": e.count,
                      "self_cpu_ms": e.self_cpu_time_total / 1e3}
                     for e in sorted(host,
                                     key=lambda e: -e.self_cpu_time_total)
                     [:top]]}


SVD_FACTORS = ("svd_dc",)


def profile_svd(torch, stt, n, nb, gen, top=12):
    """svd with vectors of an n × n float32 Gaussian under Auto (DC at
    n ≥ 2048: ge2bd, bdsqr on stedc and P9, the back-transforms) under
    torch.profiler with CUDA activity only (with CPU activity as well, a
    profile at 8192 did not finish in 15 minutes: ge2bd's columns make
    hundreds of host ops each), then once more without it: the walls,
    device busy time and share, device events, the port's kernels, each
    stage's ms in the profiled run by CUDA events around its call
    (``obs/stages.SVD_STAGES``; bdsqr holds its stedc), the matrix-vector
    kernels' device time beside the bytes bound of ge2bd's two products a
    labrd column, and device events a column."""
    from torch.profiler import ProfilerActivity, profile
    from slate_tpu_torch.obs.stages import wrapped_svd_stages
    stage_ms = {}

    def timed(name, fn):
        def run(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            e1.synchronize()
            stage_ms[name] = stage_ms.get(name, 0.0) + e0.elapsed_time(e1)
            return out
        return run

    a = torch.randn((n, n), generator=gen, device="cuda",
                    dtype=torch.float32) / math.sqrt(n)
    A = stt.from_dense(a, nb, device="cuda")
    run = lambda: stt.svd(A, stt.Options(), want_vectors=True)  # noqa: E731
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            wrapped_svd_stages(timed):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if on_device(e)]
    busy_us = sum(dev_us(e) for e in dev)
    gemv = [e for e in dev if "gemv" in e.key.lower()]
    npad = -(-n // nb) * nb
    return {
        "n": n, "nb": nb, "dtype": "float32", "method": "auto",
        "vectors": True, "wall_s": wall, "unprofiled_wall_s": unprofiled,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_events": sum(e.count for e in dev),
        "port_kernels": port_kernels(dev),
        "stages_ms": stage_ms,
        "gemv": {"device_ms": sum(dev_us(e) for e in gemv) / 1e3,
                 "count": sum(e.count for e in gemv),
                 # labrd column j reads the trailing block twice: Aᴴ·v on
                 # (npad − j) × (npad − j − 1), A·u one row fewer
                 "bytes_bound_ms": sum(
                     (2 * (npad - j) - 1) * (npad - j - 1)
                     for j in range(npad)) * 4 / 3.35e12 * 1e3},
        "columns": npad,
        "events_per_column": sum(e.count for e in dev) / npad,
        "top_device": [{"name": e.key[:80], "count": e.count,
                        "device_ms": dev_us(e) / 1e3}
                       for e in sorted(dev, key=lambda e: -dev_us(e))[:top]]}


SOLVE_REPS = 16


def profile_solve(torch, stt, sess, shape, op, nb, gen, top=8):
    """One-column solves against a resident factor, eager and replayed
    from the graph that ``Session.warmup`` captures (see the module
    docstring). The eager arm runs before the warmup on the same
    Session and factor, so both read the same payload."""
    from torch.profiler import ProfilerActivity, profile

    h = register(torch, stt, sess, shape, op, nb, gen, torch.float32)
    if sess.factor_info(h) != 0:
        raise AssertionError(f"{op} factor failed")
    b = torch.randn((shape[0], 1), generator=gen, device="cuda")
    B = stt.from_dense(b, nb, device="cuda")

    def arm():
        X = sess.solve_matrix(h, B)  # ends in a device sync
        for _ in range(2):
            sess.solve_matrix(h, B)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sess.solve_matrix(h, B)
        walls = []
        for _ in range(SOLVE_REPS):
            t0 = time.perf_counter()
            sess.solve_matrix(h, B)
            walls.append(time.perf_counter() - t0)
        dev = [e for e in prof.key_averages() if on_device(e)]
        walls.sort()
        return X.dense().clone(), {
            "unprofiled_wall_s": {"median": walls[len(walls) // 2],
                                  "min": walls[0], "max": walls[-1]},
            "device_busy_ms": sum(dev_us(e) for e in dev) / 1e3,
            "device_events": sum(e.count for e in dev),
            "port_kernels": {k: v for k, v in port_kernels(dev).items()
                             if v["count"]},
            "top_device": [{"name": e.key[:80], "count": e.count,
                            "device_ms": dev_us(e) / 1e3}
                           for e in sorted(dev, key=lambda e: -dev_us(e))
                           [:top]]}

    x_eager, eager = arm()
    compiles = sess.metrics.get("aot_compiles")
    t0 = time.perf_counter()
    sess.warmup(h)
    capture_s = time.perf_counter() - t0
    if sess.metrics.get("aot_compiles") != compiles + 1:
        raise AssertionError(f"{op}: warmup captured no graph")
    res = sess.factor(h)
    x_graph, graph = arm()
    out = {"op": op, "shape": list(shape), "nb": nb, "dtype": "float32",
           "rhs_cols": 1, "eager": eager, "graph": graph,
           "capture_s": capture_s,
           "graph_bytes": sum(g.nbytes for g in res.graphs.values()),
           "bit_equal": bool(torch.equal(x_eager, x_graph)),
           "max_abs_diff": float((x_eager - x_graph).abs().max())}
    sess.unregister(h)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nb", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--factors", default=None,
                    help="which factors to profile, comma-separated "
                    "(default chol,lu,qr,chol_nb128 unless --solves is "
                    "given; also nopiv, calu, chol_f64, chol_nb1024, "
                    "qr_f64_nb32, chol_c64, lu_c64, chol_c64_nb128, "
                    "qr_c64, chol_bf16, chol_bf16_nb128, lu_bf16, and the "
                    "eigensolvers heev_qr, heev_2stage, heev_dc, hegv at "
                    "--eig-n, and svd_dc at --svd-n)")
    ap.add_argument("--eig-n", type=int, default=4096)
    ap.add_argument("--eig-nb", type=int, default=256)
    ap.add_argument("--svd-n", type=int, default=8192)
    ap.add_argument("--svd-nb", type=int, default=1024)
    ap.add_argument("--solves", default="",
                    help="which solves to profile eager and graph-replayed, "
                    "comma-separated: chol, lu, qr, chol_nb128")
    args = ap.parse_args(argv)
    if args.factors is None:
        args.factors = "" if args.solves else "chol,lu,qr,chol_nb128"

    import torch
    if not torch.cuda.is_available():
        print("profile_factors: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import slate_tpu_torch as stt
    from slate_tpu_torch.core.precision import full_precision
    from slate_tpu_torch.ops import _build

    _build.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    n, f32, f64, c64 = args.n, torch.float32, torch.float64, torch.complex64
    factors = {"chol": ((n, n), "chol", args.nb, f32),
               "lu": ((n, n), "lu", args.nb, f32),
               "qr": ((2 * n, n // 2), "qr", args.nb, f32),
               "chol_nb128": ((n, n), "chol", n // 128, f32),
               "nopiv": ((n, n), "nopiv", args.nb, f32),
               "calu": ((n, n), "calu", args.nb, f32),
               "chol_f64": ((n, n), "chol", args.nb, f64),
               "chol_nb1024": ((n, n), "chol", 1024, f32),
               "qr_f64_nb32": ((8 * n, 64), "qr", 32, f64),
               "chol_c64": ((n, n), "chol", args.nb, c64),
               "lu_c64": ((n, n), "lu", args.nb, c64),
               "chol_c64_nb128": ((n, n), "chol", n // 128, c64),
               "qr_c64": ((2 * n, n // 2), "qr", args.nb, c64),
               "chol_bf16": ((n, n), "chol_bf16", args.nb, f32),
               "chol_bf16_nb128": ((n, n), "chol_bf16", n // 128, f32),
               "lu_bf16": ((n, n), "lu_bf16", args.nb, f32)}
    chosen = [c for c in args.factors.split(",") if c]
    solves = [c for c in args.solves.split(",") if c]
    eigs = [c for c in chosen if c in EIG_FACTORS]
    svds = [c for c in chosen if c in SVD_FACTORS]
    chosen = [c for c in chosen if c not in EIG_FACTORS + SVD_FACTORS]
    if not set(chosen) <= set(factors):
        ap.error(f"--factors: choose from {sorted(factors)} or "
                 f"{', '.join(EIG_FACTORS + SVD_FACTORS)}")
    if not set(solves) <= {"chol", "lu", "qr", "chol_nb128"}:
        ap.error("--solves: choose from chol, lu, qr, chol_nb128")
    warm = {((1024, 1024) if op != "qr" else (2048, 512), op, dt)
            for _, op, _, dt in (factors[c] for c in chosen + solves)}
    sess = stt.Session(hbm_budget=8 << 30, device="cuda")
    with full_precision():
        for shape, op, dt in sorted(warm, key=str):
            h = register(torch, stt, sess, shape, op, min(args.nb, 256), gen,
                         dt)
            if sess.factor_info(h) != 0:
                raise AssertionError(f"warm-up {op} {dt} factor failed")
            sess.unregister(h)
        for name in chosen:
            shape, op, nb, dt = factors[name]
            print(json.dumps({"factor": name, **profile_factor(
                torch, stt, sess, shape, op, nb, dt, gen)}), flush=True)
        for name in solves:
            shape, op, nb, _ = factors[name]
            print(json.dumps({"solve": name, **profile_solve(
                torch, stt, sess, shape, op, nb, gen)}), flush=True)
        if eigs:  # a warm-up at 512, then each at --eig-n
            for name in eigs:
                profile_eig(torch, stt, name, 512, 128, gen)
        for name in eigs:
            print(json.dumps({"factor": name, **profile_eig(
                torch, stt, name, args.eig_n, args.eig_nb, gen)}),
                flush=True)
        if svds:  # a warm-up at 2048 (DC, unprofiled), then at --svd-n
            stt.svd(stt.from_dense(torch.randn((2048, 2048), device="cuda"),
                                   256, device="cuda"), want_vectors=True)
            print(json.dumps({"factor": "svd_dc", **profile_svd(
                torch, stt, args.svd_n, args.svd_nb, gen)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
