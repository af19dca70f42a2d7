#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (slate_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: n=16384, nb=512, float32
    python3 chip_smoke.py --n 2048   # a shorter main path

Phases, one JSON line each:

1. env     torch/CUDA versions and the card (nvidia-smi name, power limit);
2. build   nvcc builds every kernel source of slate_tpu_torch/csrc;
3. kernel  each kernel against its plain PyTorch version on the card, at
           the main path's shapes and a few more, plus the failure
           contracts (NaN pivot for chol_tile, zero column for
           lu_panel_base); kernel, plain and library times by CUDA events
           (warm, median of 7);
4. check   posv/gesv on the card at a small uneven size against float64
           numpy;
5. main    the serving path: a Session registers an SPD operator (chol)
           and a general one (lu), factors each once and serves 8
           requests from each resident factor (single right-hand sides
           and 16-column blocks), every scaled residual checked; the
           kernels' launch counters are zeroed just before and read just
           after.

Then a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without a CUDA device, or
without the slate_tpu_torch package beside this file, it exits 2 at once.
This script imports nothing of JAX and nothing of slate_tpu.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense, 700 W): HBM3 3.35 TB/s; FP32 67
# TFLOP/s and FP64 34 TFLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
RESIDUAL_BOUND = 30.0


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 7) -> float:
    """Median device time of ``fn()`` in ms by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype: str):
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of the type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def spd_tile(torch, b, dtype, gen, junk_upper=True):
    x = torch.randn((b, b), generator=gen, device="cuda", dtype=dtype)
    a = x @ x.T / b + torch.eye(b, device="cuda", dtype=dtype)
    if junk_upper:
        junk = torch.randn((b, b), generator=gen, device="cuda", dtype=dtype)
        a = torch.tril(a) + 1e6 * torch.triu(junk, 1)
    return a.contiguous()


def chol_case(torch, ho, b, dtype, gen, timed: bool):
    a = spd_tile(torch, b, dtype, gen)
    lk = ho.chol_tile(a)
    lp = ho.chol_tile_plain(a)
    torch.cuda.synchronize()
    scale = lp.abs().max().item()
    err = (lk - lp).abs().max().item()
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * scale
    check(math.isfinite(err) and err <= tol,
          f"chol_tile b={b} {dtype}: |kernel - plain| = {err} > {tol}")
    check(torch.count_nonzero(torch.triu(lk, 1)).item() == 0,
          f"chol_tile b={b}: nonzero above the diagonal")
    row = {"b": b, "dtype": str(dtype).split(".")[1], "max_abs_err": err,
           "tol": tol}
    if timed:
        row["ms"] = cuda_ms(lambda: ho.chol_tile(a))
        row["plain_ms"] = cuda_ms(lambda: ho.chol_tile_plain(a), reps=5)
        row["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky(a))
        s = a.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            2 * b * b * s, b ** 3 / 3.0, row["dtype"])
    return row


def chol_nan_case(torch, ho, gen):
    b, bad = 512, 300
    a = spd_tile(torch, b, torch.float32, gen)
    a[bad, bad] = -a.abs().sum()
    for name, fn in (("kernel", ho.chol_tile), ("plain", ho.chol_tile_plain)):
        d = fn(a).diagonal()
        check(bool(torch.isfinite(d[:bad]).all()) and
              bool(torch.isnan(d[bad:]).all()),
              f"chol_tile {name}: NaN contract broken at pivot {bad}")
    return {"b": b, "bad_pivot": bad, "nan_from_pivot_on": True}


def lu_case(torch, ho, hh, w, dtype, gen, timed: bool, zero_col=None):
    a = torch.randn((hh, w), generator=gen, device="cuda", dtype=dtype)
    if zero_col is not None:
        a[:, zero_col] = 0
    lk, pk, ik = ho.lu_panel_base(a)
    lp, pp, ip = ho.lu_panel_base_plain(a)
    torch.cuda.synchronize()
    check(torch.equal(pk, pp), f"lu_panel_base {(hh, w)}: perm differs")
    check(int(ik) == int(ip), f"lu_panel_base {(hh, w)}: info {int(ik)} "
          f"!= {int(ip)}")
    if zero_col is not None:
        check(int(ik) == zero_col + 1, f"lu_panel_base: info {int(ik)} for "
              f"a zero column {zero_col}")
    err = (lk - lp).abs().max().item()
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * lp.abs().max().item()
    check(err <= tol, f"lu_panel_base {(hh, w)}: |kernel - plain| = {err}")
    row = {"H": hh, "w": w, "dtype": str(dtype).split(".")[1],
           "max_abs_err": err, "tol": tol, "perm_equal": True,
           "info": int(ik)}
    if timed:
        row["ms"] = cuda_ms(lambda: ho.lu_panel_base(a))
        row["plain_ms"] = cuda_ms(lambda: ho.lu_panel_base_plain(a), reps=5)
        row["library_ms"] = cuda_ms(lambda: torch.linalg.lu_factor(a))
        s = a.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            2 * hh * w * s + 4 * hh + 4, hh * w * w - w ** 3 / 3.0,
            row["dtype"])
    return row


# ---------------------------------------------------------------------------
# phases 4-5: factorizations and the serving path
# ---------------------------------------------------------------------------

def scaled_residuals(torch, A, X, B):
    """Per column ‖b − A·x‖∞ / (n·ε·‖A‖∞·‖x‖∞)."""
    n = A.shape[0]
    eps = torch.finfo(A.dtype).eps
    anorm = A.abs().sum(dim=1).max()
    r = (B - A @ X).abs().max(dim=0).values
    return (r / (n * eps * anorm * X.abs().max(dim=0).values)).tolist()


def small_check(torch, stt, gen):
    import numpy as np
    n, nb = 1000, 128
    x = torch.randn((n, n), generator=gen, device="cuda", dtype=torch.float32)
    spd = x @ x.T / n + torch.eye(n, device="cuda")
    gen_m = torch.randn((n, n), generator=gen, device="cuda") \
        + n ** 0.5 * torch.eye(n, device="cuda")
    b = torch.randn((n, 3), generator=gen, device="cuda")
    out = {}
    for name, A, solve in (
            ("posv", stt.hermitian(spd, nb, stt.Uplo.Lower, device="cuda"),
             stt.posv),
            ("gesv", stt.from_dense(gen_m, nb, device="cuda"), stt.gesv)):
        X, info = solve(A, stt.from_dense(b, nb, device="cuda"))
        xs = X.to_numpy()
        check(int(info) == 0 and xs.shape == (n, 3) and
              np.isfinite(xs).all(), f"{name}: bad output")
        dense = A.to_numpy().astype(np.float64)
        ref = np.linalg.solve(dense, b.double().cpu().numpy())
        rel = float(np.abs(xs - ref).max() / np.abs(ref).max())
        check(rel <= 1e-3, f"{name}: relative error {rel} vs float64 numpy")
        out[name] = rel
    return out


def main_path(torch, stt, ho, n, nb, gen):
    dev = "cuda"
    x = torch.randn((n, n), generator=gen, device=dev)
    spd = x @ x.T / n
    spd.diagonal().add_(1.0)
    del x
    gen_m = torch.randn((n, n), generator=gen, device=dev)
    rhs = [torch.randn((n, k), generator=gen, device=dev)
           for k in (1, 16, 1, 16, 1, 16, 1, 16)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ho.reset_launches()
    sess = stt.Session(hbm_budget=8 << 30, device=dev)
    h_chol = sess.register(stt.hermitian(spd, nb, stt.Uplo.Lower,
                                         device=dev), op="chol")
    h_lu = sess.register(stt.from_dense(gen_m, nb, device=dev), op="lu")
    t0 = time.perf_counter()
    info_chol = sess.factor_info(h_chol)
    t_chol = time.perf_counter() - t0
    after_chol = dict(ho.LAUNCHES)
    t0 = time.perf_counter()
    info_lu = sess.factor_info(h_lu)
    t_lu = time.perf_counter() - t0
    after_lu = dict(ho.LAUNCHES)
    res = {"chol": [], "lu": []}
    for name, h, A in (("chol", h_chol, spd), ("lu", h_lu, gen_m)):
        for b in rhs:
            xs = torch.from_numpy(sess.solve(h, b)).to(dev)
            res[name] += scaled_residuals(torch, A, xs, b)
    launches = dict(ho.LAUNCHES)

    check(info_chol == 0 and info_lu == 0,
          f"factor info chol={info_chol} lu={info_lu}")
    nt = -(-n // nb)
    check(after_chol["chol_tile"] >= nt,
          f"chol_tile launched {after_chol['chol_tile']} < {nt} times")
    check(after_lu["lu_panel_base"] - after_chol["lu_panel_base"] >= nt,
          "lu_panel_base launched fewer than once per panel")
    worst = max(res["chol"] + res["lu"])
    check(math.isfinite(worst) and worst <= RESIDUAL_BOUND,
          f"scaled residual {worst} > {RESIDUAL_BOUND}")
    solve_hist = sess.metrics.histogram("solve_latency")
    from slate_tpu_torch.obs import flops
    return {
        "n": n, "nb": nb, "dtype": "float32",
        "requests_per_operator": len(rhs),
        "chol_factor_s": t_chol,
        "chol_gflops": flops.potrf(n) / t_chol / 1e9,
        "lu_factor_s": t_lu,
        "lu_gflops": flops.getrf(n) / t_lu / 1e9,
        "solve_p50_s": solve_hist["p50"], "solve_p99_s": solve_hist["p99"],
        "solves": solve_hist["count"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "scaled_residual_max": {k: max(v) for k, v in res.items()},
        "residuals_checked": {k: len(v) for k, v in res.items()},
        "launches_chol_factor": after_chol,
        "launches_lu_factor": {k: after_lu[k] - after_chol[k]
                               for k in after_lu},
        "launches": launches,
        "metrics": sess.metrics.snapshot()["counters"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nb", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "slate_tpu_torch")):
        print("chip_smoke: the slate_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import slate_tpu_torch as stt
    from slate_tpu_torch.core.precision import full_precision
    from slate_tpu_torch.ops import _build, hopper_ops as ho

    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    log = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         per_source={k: {"seconds": v["seconds"],
                         "ptxas": [ln for ln in v["ptxas"].splitlines()
                                   if "registers" in ln or "spill" in ln]}
                     for k, v in log.items()})

    # the library yardsticks (torch.linalg) run on cuSOLVER
    torch.backends.cuda.preferred_linalg_library("cusolver")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    with full_precision():
        # b = 200 ends in a ragged panel; float64 at b = 1024 takes the
        # 16-wide panel instance of the kernel
        chol_rows = [chol_case(torch, ho, b, dt, gen,
                               timed=(b, dt) == (args.nb, torch.float32))
                     for b, dt in ((128, torch.float32),
                                   (200, torch.float32),
                                   (512, torch.float32),
                                   (1024, torch.float32),
                                   (512, torch.float64),
                                   (1024, torch.float64))]
        emit("kernel", name="chol_tile", cases=chol_rows,
             nan_case=chol_nan_case(torch, ho, gen))
        lu_rows = [lu_case(torch, ho, hh, w, dt, gen,
                           timed=(hh, w) == (args.n, 128))
                   for hh, w, dt in ((args.n, 128, torch.float32),
                                     (8192, 32, torch.float32),
                                     (512, 64, torch.float32),
                                     (1000, 100, torch.float32),
                                     (256, 4, torch.float32),
                                     (4096, 128, torch.float64))]
        lu_rows.append(lu_case(torch, ho, 1024, 64, torch.float32, gen,
                               False, zero_col=10))
        emit("kernel", name="lu_panel_base", cases=lu_rows)
        emit("check", **small_check(torch, stt, gen))
        main = main_path(torch, stt, ho, args.n, args.nb, gen)
    emit("main", **main)

    k1 = next(r for r in chol_rows if r.get("ms") is not None)
    k2 = next(r for r in lu_rows if r.get("ms") is not None)
    kernels = []
    for name, row, src, rep in (
            ("chol_tile", k1, "slate_tpu_torch/csrc/chol_tile.cu",
             "slate_tpu/ops/pallas_ops.py:342"),
            ("lu_panel_base", k2, "slate_tpu_torch/csrc/lu_panel.cu",
             "slate_tpu/ops/pallas_ops.py:448")):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": main["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
