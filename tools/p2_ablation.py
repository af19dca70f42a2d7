#!/usr/bin/env python3
"""Where P2's time per launch goes, on one NVIDIA GPU.

    python3 tools/p2_ablation.py                # the kernel and its variants
    python3 tools/p2_ablation.py --kernel-only  # the kernel alone

First the kernel's own device time per launch: ``hopper_ops.lu_nopiv_base``
of a 64 × 64 leaf called 50 times under torch.profiler, the time of the
``lu_nopiv_kernel`` events over their count (the copies the call makes
are not in it), in float32 and float64, and beside it the device time per
call of ``torch.linalg.lu_factor(a, pivot=False)`` (all its device events;
it waits for the host inside every call, so it cannot be queued). That
uses only the public call, so a copy of this script beside an older
tree's ``git archive`` times that tree's kernel (``--kernel-only``). Then
it builds
slate_tpu_torch/csrc/lu_nopiv.cu as it is and in variants that
each take one part of the step out, by text substitution (the variants
give wrong results and serve only to time), and prints the device time
per launch of each at 64 × 64 in float32 and float64 (100 launches
queued behind a device-side sleep, each on a fresh copy of a diagonally
dominant leaf), one JSON line, then the card's nvidia-smi name and power
limit. The variants:

  no_division    the IEEE divisions of the col maker become products
  no_handoff     no warp waits for a published col and none arrives
  no_steps       the step loop is skipped: the launch, the load and the
                 store through the shared tile, the block barriers

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

CUTS = {
    "no_division": [("const T q1 = cx::divide(m1[jk], ds);",
                     "const T q1 = m1[jk];"),
                    ("const T q0 = cx::divide(m0[jk], ds);",
                     "const T q0 = m0[jk];")],
    "no_handoff": [("        mbar_wait0(bar0 + 8 * i);\n", ""),
                   ("    mbar_arrive(bar0 + 8 * k);", "")],
    "no_steps": [("for (int ib = 32 * h; ib < min(s, 32 * h + 32); ib += kCols)",
                  "for (int ib = 32 * h; ib < 0; ib += kCols)")],
}


def build(src: str, name: str, out_dir: str, nvcc: str, flags) -> str:
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([nvcc, *flags, "-I", CSRC, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return lib


def device_ms(torch, fn, launches=100, cycles=50_000_000) -> float:
    fn(0)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for k in range(launches):
        fn(k + 1)
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    ev[2].synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        raise RuntimeError("the host did not queue every launch before the "
                           "sleep ended")
    return ev[1].elapsed_time(ev[2]) / launches


def profiled_ms(torch, fn, key=None, calls=50) -> float:
    """Device time per call of ``fn()`` under torch.profiler: per event
    whose name holds ``key`` (one per call; the profiler may drop some,
    so the events it kept are averaged), or all device events over the
    calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and (key is None or key in e.key)]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in mine)
    if key is None:
        return us / 1e3 / calls
    count = sum(e.count for e in mine)
    if not 0 < count <= calls:
        raise RuntimeError(f"{count} {key} events for {calls} calls")
    return us / 1e3 / count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="time the kernel alone (any tree), no variants")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("p2_ablation: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from slate_tpu_torch.ops import _build, hopper_ops as ho
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        a = torch.randn((64, 64), generator=gen, device="cuda", dtype=dtype)
        a.diagonal().add_(64)
        out[suffix] = profiled_ms(torch, lambda: ho.lu_nopiv_base(a),
                                  "lu_nopiv_kernel")
        out[f"lu_factor {suffix}"] = profiled_ms(
            torch, lambda: torch.linalg.lu_factor(a, pivot=False))
    print(json.dumps({"p2_kernel_device_ms": out}), flush=True)
    if args.kernel_only:
        return smi()
    with open(os.path.join(_build.CSRC_DIR, "lu_nopiv.cu")) as f:
        base = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "p2_ablation")
    os.makedirs(out_dir, exist_ok=True)
    sources = {"kernel": base}
    for name, subs in CUTS.items():
        src = base
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} is not in lu_nopiv.cu")
            src = src.replace(old, new)
        sources[name] = src
    nvcc = _build.nvcc_path()
    libs = {n: ctypes.CDLL(build(src, n, out_dir, nvcc, _build.NVCC_FLAGS))
            for n, src in sources.items()}
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        a = torch.randn((64, 64), generator=gen, device="cuda", dtype=dtype)
        a.diagonal().add_(64)
        pool = a.expand(110, 64, 64).clone()
        slot = torch.zeros((), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            f = getattr(lib, f"slate_lu_nopiv_{suffix}")
            f.argtypes = [p, ll, ll, i, p, i, p]
            pool.copy_(a.expand(110, 64, 64))
            out[f"{name} {suffix}"] = device_ms(
                torch, lambda k: f(pool[k].data_ptr(), 64, 1, 64,
                                   slot.data_ptr(), 0, stream))
    print(json.dumps({"p2_ablation_device_ms": out}), flush=True)
    return smi()


def smi() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
