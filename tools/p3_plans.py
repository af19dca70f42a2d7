#!/usr/bin/env python3
"""P3 (``lu_panel_batched``) at every cluster size, on one NVIDIA GPU.

    python3 tools/p3_plans.py                 # the CALU round shapes
    python3 tools/p3_plans.py --shapes 16x1024x512,1x1024x512

For each (B, H, w) stack (Gaussian, seed 0) in float32 and, at the
tournament's two round shapes, in float64: whether the public
``hopper_ops.lu_panel_batched`` call gives lu, perm and info bit for bit
the plain version's and its device time per launch; then the plan that
``hopper_ops.lu_panel_batched_plan`` picks, and for every cluster size C
of ``hopper_ops.P3_CLUSTERS`` that has a plan (``lu_panel_batched_plan_with``:
resident or streaming), the most clusters the card holds at once
(cudaOccupancyMaxActiveClusters), the same check and the same time. A
copy of this script beside an older tree's ``git archive`` times that
tree's P3 through its public call alone. Times are device time per
launch by CUDA events around ``--launches`` launches queued back to
back (each launch takes longer than the host needs to queue the next,
so host work is not in the time). One JSON line per stack (after the
first, what ptxas reported when it built the kernel: registers, spills,
shared memory), then the card's nvidia-smi name and power limit. The
default shapes are the CALU factor's round shapes at n = 16384,
nb = 512: (32, 512, 512) and (B, 1024, 512) for B = 16, 8, 4, 2, 1.
Exits 2 without a CUDA device. Imports nothing of JAX or slate_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SHAPES = "32x512x512,16x1024x512,8x1024x512,4x1024x512,2x1024x512,1x1024x512"
F64_SHAPES = ((32, 512, 512), (16, 1024, 512))


def same_bits(torch, x, y) -> bool:
    nan = torch.isnan(x)
    return bool(torch.equal(nan, torch.isnan(y))
                and torch.equal(x[~nan], y[~nan]))


def time_ms(torch, fn, launches: int) -> float:
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


def stack_row(torch, ho, shape, dtype, launches, gen):
    bsz, hh, w = shape
    a = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    ref = ho.lu_panel_batched_plain(a)

    def equal(got):
        torch.cuda.synchronize()
        return (same_bits(torch, got[0], ref[0]) and torch.equal(got[1], ref[1])
                and torch.equal(got[2], ref[2]))

    row = {"B": bsz, "H": hh, "w": w, "dtype": str(dtype).split(".")[1],
           "bitwise_equal": equal(ho.lu_panel_batched(a)),
           "device_ms": time_ms(torch, lambda: ho.lu_panel_batched(a),
                                launches)}
    if not hasattr(ho, "lu_panel_batched_plan_for"):
        return row  # an older tree: its one kernel, no plans
    chosen = ho.lu_panel_batched_plan_for(a)
    row["plan"] = {"ctas": chosen.ctas, "mode": chosen.mode}
    row["plans"] = []
    for ctas in ho.P3_CLUSTERS:
        try:
            plan = ho.lu_panel_batched_plan_with(hh, w, a.element_size(),
                                                 ctas)
        except ho.SlateError:
            continue
        row["plans"].append({
            "ctas": ctas, "mode": plan.mode, "smem_bytes": plan.smem_bytes,
            "max_clusters": ho.lu_panel_batched_max_clusters(a, plan),
            "bitwise_equal": equal(ho.lu_panel_batched_launch(a, plan)),
            "device_ms": time_ms(
                torch, lambda: ho.lu_panel_batched_launch(a, plan), launches)})
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default=SHAPES,
                    help="comma-separated BxHxw stacks (float32)")
    ap.add_argument("--launches", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("p3_plans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from slate_tpu_torch.ops import _build, hopper_ops as ho
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [tuple(int(x) for x in s.split("x"))
              for s in args.shapes.split(",")]
    for dtype, todo in ((torch.float32, shapes),
                        (torch.float64, [s for s in F64_SHAPES
                                         if s in shapes])):
        for shape in todo:
            row = stack_row(torch, ho, shape, dtype, args.launches, gen)
            print(json.dumps(row), flush=True)
            if "lu_panel_batched" in _build.BUILD_LOG:
                print(json.dumps({"ptxas": _build.BUILD_LOG.pop(
                    "lu_panel_batched")}), flush=True)
            if not all(p["bitwise_equal"] for p in [row, *row.get("plans",
                                                                  [])]):
                print(f"p3_plans: a plan differs from the plain version at "
                      f"{shape} {dtype}", file=sys.stderr)
                return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
