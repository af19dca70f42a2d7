#!/usr/bin/env python3
"""Where P3's time per launch goes, on one NVIDIA GPU.

    python3 tools/p3_ablation.py

Builds slate_tpu_torch/csrc/lu_panel_batched.cu as it is and in variants
that each take one part of the column step out, by text substitution
(the variants give wrong results and serve only to time), and prints the
device time per launch of each (CUDA events around 10 launches queued
back to back, after one warm-up) at the plans named in CASES, one JSON
line, then the card's nvidia-smi name and power limit. The variants:

  no_remote    every warp pushes its candidate into its own CTA alone,
               so every CTA takes its own best as the pivot, and its own
               slot of that index as the U row: no access to another CTA
               (the cluster barrier stays)
  local_candidates  only the candidates stay in this CTA
  local_u_row  only the U row is read from this CTA (its own slot of
               the pivot's index)
  no_cluster   no_remote, and a block barrier in place of the cluster
               barrier of each column
  no_update    the rank-1 update of the rows other than the warps'
               candidate rows is skipped (the multipliers, column j + 1,
               the candidate rows and the barriers stay)
  no_division  the multipliers are products instead of IEEE divisions
  threads_128  the same kernel with 128 threads a CTA (four warps), and
  threads_512  with 512 (sixteen): alternatives, not cuts

Exits 2 without a CUDA device. Imports nothing of JAX or slate_tpu.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the sources' headers (csrc/cx.cuh), for the variants built elsewhere
CSRC = os.path.join(ROOT, "slate_tpu_torch", "csrc")

REMOTE = [("cluster.map_shared_rank(\n                     cand + ((size_t)"
            "buf * C + r) * kWarps + warp, lane)",
            "(cand + ((size_t)buf * C + lane) * kWarps + warp)"),
           ("cluster.map_shared_rank(base + (size_t)lp * w, owner)",
            "(base + (size_t)lp * w)")]
BARRIER = [("    cluster_wait();\n\n    // (1)",
            "    __syncthreads();\n\n    // (1)"),
           ("    if (M == kStream) __threadfence();\n    cluster_arrive();\n"
            "\n    // (3c)", "\n    // (3c)")]
THREADS = "constexpr int kThreads = 256;"
BOUNDS = "__launch_bounds__(kThreads, 2)"
CUTS = {
    "no_remote": REMOTE,
    "local_candidates": REMOTE[:1],
    "local_u_row": REMOTE[1:],
    "no_cluster": REMOTE + BARRIER,
    "no_update": [("for (int c = j + 2 + lane; c < w; c += 64) {",
                   "for (int c = w + lane; c < w; c += 64) {")],
    "no_division": [("cx::divide(row[j], dsafe)", "row[j]")],
    "threads_128": [(THREADS, THREADS.replace("256", "128")),
                    (BOUNDS, BOUNDS.replace("2)", "4)"))],
    "threads_512": [(THREADS, THREADS.replace("256", "512")),
                    (BOUNDS, BOUNDS.replace("2)", "1)"))],
}
SUFFIX = {"float32": "f32", "float64": "f64"}
# (B, H, w, dtype, C): the plans of the CALU factor's rounds and a small one
CASES = [(1, 1024, 512, "float32", 16), (8, 1024, 512, "float32", 16),
         (16, 1024, 512, "float32", 8), (32, 512, 512, "float32", 4),
         (32, 512, 512, "float32", 8), (5, 45, 45, "float32", 1)]


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


def time_ms(torch, fn, launches: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(launches):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / launches


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("p3_ablation: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from slate_tpu_torch.ops import _build, hopper_ops as ho
    with open(os.path.join(_build.CSRC_DIR, "lu_panel_batched.cu")) as f:
        base = f.read()
    sources = {"kernel": base}
    for name, subs in CUTS.items():
        src = base
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} is not in "
                                   "lu_panel_batched.cu")
            src = src.replace(old, new)
        sources[name] = src
    out_dir = os.path.join(_build.BUILD_DIR, "p3_ablation")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.nvcc_path()
    libs = {n: ctypes.CDLL(build(src, n, out_dir, nvcc, _build.NVCC_FLAGS))
            for n, src in sources.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    p, i = ctypes.c_void_p, ctypes.c_int
    rows = []
    for bsz, hh, w, dt, ctas in CASES:
        dtype = getattr(torch, dt)
        a = torch.randn((bsz, hh, w), generator=gen, device="cuda",
                        dtype=dtype)
        plan = ho.lu_panel_batched_plan_with(hh, w, a.element_size(), ctas)
        lu = torch.empty_like(a)
        perm = torch.empty((bsz, hh), dtype=torch.int32, device="cuda")
        info = torch.empty(bsz, dtype=torch.int32, device="cuda")
        scratch = torch.empty(0 if plan.resident else bsz * ctas * plan.rows
                              * w, dtype=dtype, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        row = {"B": bsz, "H": hh, "w": w, "dtype": dt, "ctas": ctas,
               "mode": plan.mode}
        for name, lib in libs.items():
            f = getattr(lib, "slate_lu_panel_batched_" + SUFFIX[dt])
            f.argtypes = [p] * 5 + [i] * 5 + [p]

            def launch():
                rc = f(a.data_ptr(), lu.data_ptr(), perm.data_ptr(),
                       info.data_ptr(), scratch.data_ptr(), bsz, hh, w, ctas,
                       int(plan.resident), stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            row[name] = time_ms(torch, launch)
        rows.append(row)
    print(json.dumps({"p3_ablation_device_ms": rows}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
