#!/usr/bin/env python3
"""Where P4's and P5's time per launch goes, on one NVIDIA GPU.

    python3 tools/p45_ablation.py                # the kernels and variants
    python3 tools/p45_ablation.py --kernel-only  # the kernels as built
    python3 tools/p45_ablation.py --kernel-only --small  # and the engine

Builds slate_tpu_torch/csrc/chol_tile_batched.cu (P4) and
qr_panel_batched.cu (P5) as they are and in variants that each take one
part of the kernel out by text substitution (the variants give wrong
results and serve only to time), puts each build in the place of the
library that ``hopper_ops`` loads, and prints the device time per launch
of the public calls ``chol_tile_batched`` and ``qr_panel_batched`` at the
batched engine's shapes (10-50 launches queued behind
``torch.cuda._sleep``, after one warm-up), one JSON line, then the card's
nvidia-smi name and power limit. The variants:

  P4 load_store   the column steps are skipped: the launch, the load and
                  the store of every item
  P4 no_sqrt_div  the IEEE square root returns its argument and the IEEE
                  divisions become products
  P5 load_store   the column loop is skipped: the launch, the load, the
                  store
  P5 no_reduction the sums over the rows for the trailing columns
                  (w_row, or the fused partials) are skipped
  P5 no_update    the rank-1 update of the trailing columns is skipped

Each variant names its substitutions for each kernel design the
repository has had (the first set whose patterns are all in the source
is used), so a copy of this script beside an older tree's
``git archive`` times that tree's kernels. Beside them: the host time
per call of each launcher (perf_counter around 200 calls, nothing
synchronised), P4 at B = 1000, 2000 and 4000 contiguous (32, 32) f32
items (whether more items per SM hide the step chain), and the device
time per call of batched ``torch.linalg.cholesky_ex`` and ``torch.geqrf``
by torch.profiler's events (all device events over the calls), and
each kernel's ``ms``: CUDA events around one call, median of 7, host
launch work included. ``--small`` also runs the ``small`` phase of the
``chip_smoke.py`` beside it (the batched verbs' and the Session's walls
and requests per second) and prints its JSON line.

Exits 2 without a CUDA device. Imports nothing of JAX or slate_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the sources' headers (csrc/cx.cuh), for the variants built elsewhere
CSRC = os.path.join(ROOT, "slate_tpu_torch", "csrc")

SQRT_DIV = [
    ("float div_rn(float x, float y) { return __fdiv_rn(x, y); }",
     "float div_rn(float x, float y) { return __fmul_rn(x, y); }"),
    ("double div_rn(double x, double y) { return __ddiv_rn(x, y); }",
     "double div_rn(double x, double y) { return __dmul_rn(x, y); }"),
    ("float sqrt_rn(float x) { return __fsqrt_rn(x); }",
     "float sqrt_rn(float x) { return x; }"),
    ("double sqrt_rn(double x) { return __dsqrt_rn(x); }",
     "double sqrt_rn(double x) { return x; }")]
# kernel -> variant -> one list of (old, new) substitutions per design
CUTS = {
    "chol_tile_batched": {
        "load_store": [
            # PR 13: one row per lane straight from global memory
            [("    if (j >= s) break;\n    T d;",
              "    if (j >= 0) break;\n    T d;")],
            # coalesced staging, lookahead step
            [("  if (s > 0) {  // the column steps",
              "  if (s < 0) {  // the column steps")]],
        # each design's square roots and divisions (csrc/cx.cuh's since
        # the complex instances)
        "no_sqrt_div": [SQRT_DIV,
                        [("sqrt_rn(bad ? R(1) : d)", "(bad ? R(1) : d)"),
                         ("cx::div_real_rn(", "cx::scale(")]],
    },
    "qr_panel_batched": {
        "load_store": [
            [("  for (int j = 0; j < w; ++j) {\n    T p = T(0);",
              "  for (int j = 0; j < 0; ++j) {\n    T p = T(0);")],
            [("  if (w > 0) {  // the column steps",
              "  if (w < 0) {  // the column steps")]],
        "no_reduction": [
            [("    for (int c = j + 1 + warp; c < w; c += kWarps) {",
              "    for (int c = w + warp; c < w; c += kWarps) {")],
            # rows owned by threads: no partials and no shuffles in the
            # butterfly (the exchange through shared memory stays)
            [("for (int c = j; c < 32; ++c) p[c] += x * m[k][c];",
              "for (int c = 32; c < 32; ++c) p[c] += x * m[k][c];"),
             ("for (int i = 0; i < 32; ++i) p[i] += x * row[i];",
              "for (int i = 32; i < 32; ++i) p[i] += x * row[i];"),
             ("if (r > j1) p[i] += x * val;", "if (r < 0) p[i] += x * val;"),
             ("p[i] = keep + __shfl_xor_sync(kFull, send, O);",
              "p[i] = keep + send;")],
            # chunks of kC columns, the shuffles through cx.cuh (PR 16)
            [("for (int c = j; c < 32; ++c) p[c] += x * m[k][c];",
              "for (int c = 32; c < 32; ++c) p[c] += x * m[k][c];"),
             ("for (int i = 0; i < kC; ++i) p[i] += x * row[i];",
              "for (int i = kC; i < kC; ++i) p[i] += x * row[i];"),
             ("if (r > j1) p[i] += x * val;", "if (r < 0) p[i] += x * val;"),
             ("p[i] = keep + cx::shfl_xor(send, O);", "p[i] = keep + send;"),
             ("for (int o = N; o < 32; o *= 2) s += cx::shfl_xor(s, o);",
              "")]],
        "no_update": [
            [("      for (int e = tid; e < (H - j) * nc; e += kThreads) {",
              "      for (int e = tid; e < 0; e += kThreads) {")],
            [("live[k] ? m[k][c] - tv[k] * wc : m[k][c];", "m[k][c];"),
             ("val = c0 + i > j1 ? val - tv * wr[i] : val;", "")]],
    },
}
# (B, s, dtype, n_big): P4's engine tiles, then the B sweep
P4_CASES = [(1000, 32, "float32", 256), (10000, 32, "float32", None),
            (1000, 32, "float64", 256)]
P4_SWEEP = [(1000, 32, "float32", None), (2000, 32, "float32", None),
            (4000, 32, "float32", None)]
# (B, H, w, dtype, strided)
P5_CASES = [(1000, 512, 32, "float32", True),
            (10000, 64, 32, "float32", False),
            (1000, 512, 32, "float64", False),
            (8, 2000, 128, "float32", False)]


def substitute(src: str, name: str, variant: str) -> str:
    for subs in CUTS[name][variant]:
        if all(old in src for old, _ in subs):
            for old, new in subs:
                src = src.replace(old, new)
            return src
    raise RuntimeError(f"{name} {variant}: no substitution set matches "
                       f"{name}.cu")


def build(src: str, tag: str, out_dir: str, nvcc: str, flags) -> str:
    path = os.path.join(out_dir, f"{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{tag}.so")
    proc = subprocess.run([nvcc, *flags, "-I", CSRC, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    return lib


def install(_build, ho, name: str, lib):
    """Make ``hopper_ops`` launch from ``lib`` (a path or a loaded
    library) for ``name``."""
    _build._libs[name] = ctypes.CDLL(lib) if isinstance(lib, str) else lib
    for sym in [s for s in ho._fns if s.startswith(f"slate_{name}_")]:
        del ho._fns[sym]


def device_ms(torch, fn, launches, cycles=50_000_000) -> float:
    fn()
    torch.cuda.synchronize()
    for c in (cycles, 4 * cycles, 16 * cycles):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(c)
        ev[1].record()
        for _ in range(launches):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / launches
    raise RuntimeError("the host did not queue every launch before the "
                       "sleep ended")


def events_ms(torch, fn, reps=7) -> float:
    """Median time of one call by CUDA events, host launch work
    included (chip_smoke.py's ``ms``)."""
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
    return sorted(times)[reps // 2]


def host_us(torch, fn, calls=200) -> float:
    """Host time per call, nothing synchronised inside the window (the
    queue is long enough not to block at these counts)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def profiled_ms(torch, fn, calls=10) -> float:
    """Device time per call of ``fn()``: all device events under
    torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    return us / 1e3 / calls


def p4_stack(torch, bsz, s, dtype, n_big, gen):
    x = torch.randn((bsz, s, s), generator=gen, device="cuda",
                    dtype=torch.float64)
    a = (x @ x.mT / s + torch.eye(s, device="cuda", dtype=torch.float64)
         ).to(dtype)
    if n_big is None:
        return a
    big = torch.zeros((bsz, n_big, n_big), dtype=dtype, device="cuda")
    view = big[:, n_big - s:, n_big - s:]
    view.copy_(a)
    return view


def p5_stack(torch, bsz, hh, w, dtype, strided, gen):
    a = torch.randn((bsz, hh, w), generator=gen, device="cuda", dtype=dtype)
    if not strided:
        return a
    big = torch.zeros((bsz, hh, 2 * w), dtype=dtype, device="cuda")
    big[:, :, w:] = a
    return big[:, :, w:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="time the kernels as built, no variants")
    ap.add_argument("--small", action="store_true",
                    help="also run chip_smoke.py's small phase")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("p45_ablation: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from slate_tpu_torch.ops import _build, hopper_ops as ho
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dt = {"float32": torch.float32, "float64": torch.float64}
    p4 = {f"{b}x{s}x{s} {d}" + (f" blocks of {n}" if n else ""):
          p4_stack(torch, b, s, dt[d], n, gen)
          for b, s, d, n in P4_CASES + P4_SWEEP}
    p5 = {f"{b}x{h}x{w} {d}" + (" strided" if st else ""):
          p5_stack(torch, b, h, w, dt[d], st, gen)
          for b, h, w, d, st in P5_CASES}
    calls = {"chol_tile_batched": (ho.chol_tile_batched, p4, 20),
             "qr_panel_batched": (ho.qr_panel_batched, p5, 10)}
    host = {f"{name} {key}": host_us(torch, lambda: fn(a))
            for name, (fn, stacks, _) in calls.items()
            for key, a in list(stacks.items())[:2]}
    library = {}
    for key in list(p4)[:3]:
        library[f"cholesky_ex {key}"] = profiled_ms(
            torch, lambda: torch.linalg.cholesky_ex(p4[key]))
    for key in p5:
        library[f"geqrf {key}"] = profiled_ms(
            torch, lambda: torch.geqrf(p5[key]), calls=3)
    nvcc = _build.nvcc_path()
    out_dir = os.path.join(_build.BUILD_DIR, "p45_ablation")
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name, (fn, stacks, launches) in calls.items():
        with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
            base = f.read()
        built = _build.load(name)
        variants = {"kernel": base}
        if not args.kernel_only:
            variants.update({v: substitute(base, name, v)
                             for v in CUTS[name]})
        for v, src in variants.items():
            if v != "kernel":  # the kernel itself: the library as built
                install(_build, ho, name, build(src, f"{name}_{v}", out_dir,
                                                nvcc, _build.NVCC_FLAGS))
            for key, a in stacks.items():
                if v != "kernel" and key.startswith(("2000", "4000")):
                    continue  # the B sweep times the whole kernel only
                out[f"{name} {v} {key}"] = device_ms(
                    torch, lambda: fn(a), launches)
        install(_build, ho, name, built)  # the kernel again
    events = {f"{name} {key}": events_ms(torch, lambda: fn(a))
              for name, (fn, stacks, _) in calls.items()
              for key, a in stacks.items()}
    print(json.dumps({"p45_device_ms": out, "p45_events_ms": events,
                      "host_us_per_call": host,
                      "library_device_ms_profiler": library}), flush=True)
    if args.small:
        import chip_smoke
        import slate_tpu_torch as stt
        ho.reset_launches()
        small = chip_smoke.small_phase(torch, stt, ho, gen)
        print(json.dumps({"small": small, "launches": dict(ho.LAUNCHES)},
                         default=str), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
