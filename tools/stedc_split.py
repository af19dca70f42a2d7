#!/usr/bin/env python3
"""Where stedc's time goes on one NVIDIA GPU, and which ``min_k`` to take.

    python3 tools/stedc_split.py                       # n = 4096
    python3 tools/stedc_split.py --min-k 64,256,1024 --kinds random

First P9 (``hopper_ops.secular_roots``) against its plain version at
k = 512 and 4096 on a random spectrum (``chip_smoke.p9_case``: roots and
eigenvector orthogonality, CUDA-event and device ms, the plain version's
and torch.linalg.eigvalsh's ms, the bound). Then, for each tridiagonal of
``--kinds`` (``chip_smoke.stedc_tridiagonal``: random, glued_wilkinson,
ties) and each ``--min-k``, stedc in float64 at ``--n`` with vectors:
one warm-up, then its wall twice (host clock ending in a sync: the
median of ``--reps``), then once more with every stage of a merge timed
on its own (a sync before and after each): "secular" (P9 and the O(k)
transfers around it), "vectors" (the revised ẑ and V), "transform" (the
column transform T, with a rotated merge's sparse columns built on the
host), "products" (the basis products q1·T[:n1], q2·T[n1:]) and "rows"
(the two boundary rows); by device ("cuda" for the merges at or above
min_k, "cpu" for the host subtrees). "host_other_s" is the split run's
wall less every timed stage: the host bookkeeping of the merges and the
leaves' eigh. Each also counts P9's launches and checks
‖ZᵀZ − I‖max < n·1e-13. One JSON line per run; the last line is the
card's nvidia-smi name and power limit. Exits 2 without a CUDA device.
Imports nothing of JAX and nothing of slate_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STAGES = {"_roots": "secular", "_vectors": "vectors",
          "_transform": "transform", "_apply": "products",
          "_boundary_rows": "rows"}


def _device_of(args, out):
    import torch
    for x in (out, *args) if not isinstance(out, tuple) else (*out, *args):
        if isinstance(x, torch.device):
            return x.type
        if isinstance(x, torch.Tensor):
            return x.device.type
    return "cpu"


@contextlib.contextmanager
def timed_stages(torch, sd):
    """Each merge stage of ``linalg/stedc.py`` (``STAGES``) timed by the
    host clock between syncs while in use; yields seconds by
    "stage/device"."""
    secs = {}
    saved = {name: getattr(sd, name) for name in STAGES}

    def wrap(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            key = f"{STAGES[name]}/{_device_of(args, out)}"
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    for name, fn in saved.items():
        setattr(sd, name, wrap(name, fn))
    try:
        yield secs
    finally:
        for name, fn in saved.items():
            setattr(sd, name, fn)


def split_run(torch, ho, sd, cs, kind, n, min_k, reps, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    d, e = cs.stedc_tridiagonal(kind, n, rng)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sd.stedc(d, e, device="cuda", min_k=min_k)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run()
    walls = []
    for _ in range(reps):
        before = ho.LAUNCHES["secular_roots"]
        (w, z), wall = run()
        walls.append(wall)
        launches = ho.LAUNCHES["secular_roots"] - before
    orth = float((z.T @ z - torch.eye(n, dtype=z.dtype,
                                      device="cuda")).abs().max())
    del z
    with timed_stages(torch, sd) as secs:
        _, split_wall = run()
    if not orth < n * 1e-13:
        raise AssertionError(f"stedc {kind} min_k={min_k}: orthogonality "
                             f"{orth}")
    return {"kind": kind, "n": n, "min_k": min_k,
            "wall_s": statistics.median(walls), "walls_s": walls,
            "secular_roots_launches": launches, "orthogonality": orth,
            "split_wall_s": split_wall, "stages_s": secs,
            "host_other_s": split_wall - sum(secs.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--min-k", default="64,256,1024")
    ap.add_argument("--kinds", default="random,glued_wilkinson,ties")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("stedc_split: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke as cs
    from slate_tpu_torch.linalg import stedc as sd
    from slate_tpu_torch.ops import _build, hopper_ops as ho

    t0 = time.perf_counter()
    _build.load("secular")
    print(json.dumps({"build": "secular",
                      "seconds": time.perf_counter() - t0,
                      "ptxas": _build.BUILD_LOG.get("secular", {})
                      .get("ptxas", "")}), flush=True)
    rng = np.random.default_rng(args.seed)
    for k in (512, 4096):
        print(json.dumps({"p9": cs.p9_case(torch, ho, k, "random", rng)}),
              flush=True)
    for kind in args.kinds.split(","):
        for mk in (int(x) for x in args.min_k.split(",")):
            print(json.dumps({"stedc": split_run(
                torch, ho, sd, cs, kind, args.n, mk, args.reps,
                args.seed)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
