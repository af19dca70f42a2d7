#!/usr/bin/env python3
"""Where P9's time per launch goes, on one NVIDIA GPU.

    python3 tools/p9_ablation.py                 # the kernel and variants
    python3 tools/p9_ablation.py --kernel-only   # the kernel as built
    python3 tools/p9_ablation.py --ks 64,4096 --out FILE

Builds slate_tpu_torch/csrc/secular.cu (P9, ``secular_roots``) as it is
and in variants that each change one part of the kernel by text
substitution, puts each build in the place of the library that
``hopper_ops`` loads, and prints the device time per launch of the
public call ``secular_roots`` at k = 64, 512, 4096 and 16384 on a
Gaussian spectrum (δ sorted normal, z normal and unit, ρ = 0.7: the
smoke's "random" P9 rows), launches queued behind ``torch.cuda._sleep``
(``chip_smoke.device_ms``), and each variant's largest root error
against the plain version (the cut variants give wrong results and
serve only to time). The variants:

  ieee_div     IEEE division 1.0/den in place of the reciprocal (the
               rcp.approx.ftz.f64 seed and two Newton–Raphson steps)
  lanes_4, lanes_8, lanes_16, lanes_32
               every k at that many lanes a root (the plan's other
               choices follow from it)
  tiled        the poles staged SECULAR_TILE at a time on every pass at
               every k (resident in shared memory up to
               SECULAR_RESIDENT_MAX as built)
  poles_global every pass reads the poles straight from global memory
               (L2), coalesced, at every k
  no_butterfly each lane keeps its own partial sum (wrong results; the
               butterfly's cost)
  warps_8, warps_32
               at most 8 or 32 warps a CTA (16 as built; the lanes a root
               follow, since they fill one wave of such CTAs)
  unroll_1, unroll_4
               the pole loop unrolled 1 or 4 deep (8 as built)

Each variant names its substitutions for each design the kernel has had
(the first set whose patterns are all in the source is used; a variant
no set matches is skipped and listed under "variants_without_a_match"),
so a copy of this script beside an older tree's ``git archive`` times
that tree's kernel (``--kernel-only``). Beside the times: each build's
plan at each k (``slate_secular_plan``, where the build has it), ptxas's
registers and spill stores per kernel instance, and a count of the
instructions of interest in each instance's SASS (``cuobjdump -sass``:
DFMA, DADD, DMUL, MUFU.RCP64H, SHFL, BAR, CALL and branches), which
shows whether a term's division carries a slow-path call. One JSON line
(also to ``--out``), then the card's nvidia-smi name and power limit.

Exits 2 without a CUDA device. Imports nothing of JAX or slate_tpu.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CSRC = os.path.join(ROOT, "slate_tpu_torch", "csrc")
NAME = "secular"

RECIP_BODY = """  double x;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(x) : "d"(d));
  double e = fma(-d, x, 1.0);
  x = fma(x, e, x);
  e = fma(-d, x, 1.0);
  return fma(x, e, x);
"""
TILE_LOOP = "    for (int t0 = 0; t0 < k; t0 += kTile) {\n"
BUTTERFLY = ("#pragma unroll\n  for (int o = 1; o < L; o <<= 1) s += "
             "__shfl_xor_sync(0xffffffffu, s, o);\n")


def _lanes(n):
    return [[("  p.lanes = lanes_for(k);", f"  p.lanes = {n};")]]


# variant -> one list of (old, new) substitutions per kernel design
CUTS = {
    "ieee_div": [[(RECIP_BODY, "  return 1.0 / d;\n")]],
    "lanes_4": _lanes(4), "lanes_8": _lanes(8), "lanes_16": _lanes(16),
    "lanes_32": _lanes(32),
    "tiled": [[("  p.resident = k <= kResidentMax;",
                "  p.resident = false;")]],
    "poles_global": [[("  p.resident = k <= kResidentMax;",
                       "  p.resident = false;"),
                      (TILE_LOOP, "#pragma unroll 8\n    for (int i = lane; "
                       "i < k; i += L) term(i, delta[i], z2[i]);\n    for "
                       "(int t0 = k; t0 < k; t0 += kTile) {\n")]],
    "no_butterfly": [[(BUTTERFLY, "")]],
    "warps_8": [[("constexpr int kMaxWarps = 16;",
                  "constexpr int kMaxWarps = 8;")]],
    "warps_32": [[("constexpr int kMaxWarps = 16;",
                   "constexpr int kMaxWarps = 32;")]],
    "unroll_1": [[("#pragma unroll 8", "#pragma unroll 1")]],
    "unroll_4": [[("#pragma unroll 8", "#pragma unroll 4")]],
}
# SASS opcodes counted per kernel instance
OPCODES = ("DFMA", "DADD", "DMUL", "MUFU.RCP64H", "SHFL", "BAR", "CALL",
           "BRA", "BSSY")


def substitute(src: str, variant: str):
    """``src`` with the first of ``variant``'s substitution sets whose
    patterns are all in it, or None (a design without that part)."""
    for subs in CUTS[variant]:
        if all(old in src for old, _ in subs):
            for old, new in subs:
                src = src.replace(old, new)
            return src
    return None


def build(src: str, tag: str, out_dir: str, nvcc: str, flags):
    """nvcc of one variant → (library path, ptxas output)."""
    d = os.path.join(out_dir, tag)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, f), d)
    path = os.path.join(d, f"{NAME}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(d, f"lib{NAME}.so")
    proc = subprocess.run([nvcc, *flags, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    return lib, proc.stderr


def install(_build, ho, lib):
    """Make ``hopper_ops`` launch P9 from ``lib`` (a path or a loaded
    library)."""
    _build._libs[NAME] = ctypes.CDLL(lib) if isinstance(lib, str) else lib
    for sym in [s for s in ho._fns if s.startswith(f"slate_{NAME}_")]:
        del ho._fns[sym]


def ptxas_rows(log: str):
    """ptxas's registers and spill stores per function of one build."""
    rows, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            rows.append({"function": fn, "registers": int(m.group(1)),
                         "spill_stores": spill})
            fn, spill = None, 0
    return rows


def sass_counts(nvcc: str, lib: str):
    """Per kernel function of ``lib``: how many of each OPCODES."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    proc = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[:200]}
    out, fn = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = dict.fromkeys(OPCODES, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if m and fn is not None:
            op = m.group(1)
            for want in OPCODES:
                if op == want or op.startswith(want + "."):
                    out[fn][want] += 1
    return out


def built_plan(ho, k: int):
    """The plan the installed build launches at k, or None."""
    try:
        f = ho._fn(NAME, "slate_secular_plan",
                   [ctypes.c_int, ctypes.c_void_p])
    except AttributeError:  # a design without the export
        return None
    out = (ctypes.c_int * 5)()
    if f(k, ctypes.addressof(out)):
        return None
    return {"ctas": out[0], "warps": out[1], "lanes": out[2],
            "resident": bool(out[3]), "smem": out[4]}


def spectrum(torch, k: int, seed: int):
    """The smoke's "random" P9 spectrum at k, on the card."""
    import numpy as np
    rng = np.random.default_rng(seed + k)
    delta = np.sort(rng.standard_normal(k))
    z = rng.standard_normal(k)
    z /= np.linalg.norm(z)
    return (torch.as_tensor(delta, device="cuda"),
            torch.as_tensor(z * z, device="cuda"), 0.7)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="time the kernel as built, no variants")
    ap.add_argument("--ks", default="64,512,4096,16384")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("p9_ablation: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke as cs
    from slate_tpu_torch.ops import _build, hopper_ops as ho
    t_start = time.perf_counter()
    ks = [int(x) for x in args.ks.split(",")]
    eps = float(np.finfo(np.float64).eps)
    cases = {}
    for k in ks:
        delta, z2, rho = spectrum(torch, k, args.seed)
        up, mu = ho.secular_roots_plain(delta, z2, rho)
        idx = torch.arange(k, device="cuda")
        lam = delta[idx + up.long()] + mu
        scale = max(float(delta.abs().max()), rho)
        cases[k] = (delta, z2, rho, lam, scale)

    def measure():
        """Device ms, plan and root error at every k for the installed
        build."""
        res = {}
        for k, (delta, z2, rho, lam, scale) in cases.items():
            up, mu = ho.secular_roots(delta, z2, rho)
            idx = torch.arange(k, device="cuda")
            err = float((delta[idx + up.long()] + mu - lam).abs().max())
            launches = 10 if k >= 4096 else 50
            res[str(k)] = {
                "device_ms": cs.device_ms(
                    lambda: ho.secular_roots(delta, z2, rho), launches),
                "err_over_eps_scale": err / (eps * scale),
                "plan": built_plan(ho, k)}
        return res

    nvcc = _build.nvcc_path()
    out_dir = os.path.join(_build.BUILD_DIR, "p9_ablation")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(CSRC, f"{NAME}.cu")) as f:
        base = f.read()
    srcs, unmatched = {"kernel": base}, []
    for v in CUTS if not args.kernel_only else ():
        src = substitute(base, v)
        if src is None:
            unmatched.append(v)
        else:
            srcs[v] = src
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        futs = {v: pool.submit(build, src, v, out_dir, nvcc,
                               _build.NVCC_FLAGS)
                for v, src in srcs.items()}
        libs = {v: fut.result() for v, fut in futs.items()}
    res, ptx, sass = {}, {}, {}
    for v, (lib, log) in libs.items():
        install(_build, ho, lib)
        res[v] = measure()
        ptx[v] = ptxas_rows(log)
        sass[v] = sass_counts(nvcc, lib)
    if not args.kernel_only:  # the kernel again, after the variants
        install(_build, ho, libs["kernel"][0])
        res["kernel_again"] = measure()
    line = json.dumps({"p9": res, "ptxas": ptx, "sass": sass,
                       "variants_without_a_match": unmatched,
                       "sm_clock": subprocess.run(
                           ["nvidia-smi", "--query-gpu=clocks.sm,"
                            "clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True,
                           timeout=60).stdout.strip(),
                       "seconds": time.perf_counter() - t_start})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
