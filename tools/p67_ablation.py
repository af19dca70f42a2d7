#!/usr/bin/env python3
"""Where P6's and P7's time per launch goes, on one NVIDIA GPU.

    python3 tools/p67_ablation.py                # the kernels and variants
    python3 tools/p67_ablation.py --kernel-only  # the kernels as built

Builds slate_tpu_torch/csrc/chol_update.cu (P6) and qr_append.cu (P7) as
they are and in variants that each take one part of the kernel out by
text substitution (the variants give wrong results and serve only to
time), puts each build in the place of the library that ``hopper_ops``
loads, and prints the device time per launch of the public calls
``chol_update_sweep`` and ``qr_append_build`` at the update phase's
shapes of ``chip_smoke.py`` (n = 16384 f32 at kb = 16 and kb = 1, the
(1000, 256, 256) stack at kb = 2; R 8192² f32 with P = 16 appended
rows): launches queued behind ``torch.cuda._sleep``, each after a copy
that restores the operand (so a variant's wrong values cannot drift into
slow paths), less the copies' own device time. The variants:

  no_math      the IEEE square root returns its argument and the IEEE
               divisions become products (csrc/cx.cuh, so both kernels)
  no_barrier   the block-wide barrier (P6 parent: the one before the
               rows apply a column's pairs; P7 parent: the one before the
               columns apply a reflector) or, in the wavefront designs,
               the warps' waits on the front's step counter
  no_loads     the global loads on the chain: P6's tile loads, P7's
               alpha and R-row loads (the staging, in the new designs)
  no_wait      the inter-CTA spin on the publishing CTA's progress

Each variant names its substitutions for each kernel design the
repository has had (the first set whose patterns are all in the sources
is used), so a copy of this script beside an older tree's ``git
archive`` times that tree's kernels. Beside them: each kernel's ``ms``
(CUDA events around one call, median of 7, host launch work included)
and ptxas's registers and spill stores for every instance of the two
sources as built. One JSON line, then the card's nvidia-smi name and
power limit.

Exits 2 without a CUDA device. Imports nothing of JAX or slate_tpu.
"""

from __future__ import annotations

import argparse
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

# (file, old, new): "cu" the kernel's source, "cx" csrc/cx.cuh
NO_MATH = [
    ("cx", "float div_rn(float x, float y) { return __fdiv_rn(x, y); }",
     "float div_rn(float x, float y) { return __fmul_rn(x, y); }"),
    ("cx", "double div_rn(double x, double y) { return __ddiv_rn(x, y); }",
     "double div_rn(double x, double y) { return __dmul_rn(x, y); }"),
    ("cx", "float sqrt_rn(float x) { return __fsqrt_rn(x); }",
     "float sqrt_rn(float x) { return x; }"),
    ("cx", "double sqrt_rn(double x) { return __dsqrt_rn(x); }",
     "double sqrt_rn(double x) { return x; }")]
# source -> variant -> one list of substitutions per design
CUTS = {
    "chol_update": {
        "no_math": [NO_MATH],
        "no_barrier": [
            # row per thread: one thread makes a column's pairs, a barrier
            [("cu", "      __syncthreads();\n      if (valid && tid > owner)"
              " apply_column(cc);", "      if (valid && tid > owner) "
              "apply_column(cc);")],
            # wavefront: the warps below the front wait on its step counter
            [("cu", "        wait_front(q.base + t + 1);\n", "")]],
        "no_loads": [
            [("cu", "    load_tile(j0, kTw);\n", "\n"),
             ("cu", "    load_tile(j0, w);\n", "\n")],
            # wavefront: the blocks' cp.async fetches
            [("cu", "cp_async<sizeof(T)>(blk + rr", "if (false) "
              "cp_async<sizeof(T)>(blk + rr")]],
        "no_wait": [
            [("cu", "      while (*reinterpret_cast<volatile int*>(prog + "
              "src) < need) {\n      }\n", "")],
            [("cu", "      while (ld_acquire_gpu(prog + src) < need) {\n"
              "      }\n", "")]],
    },
    "qr_append": {
        "no_math": [NO_MATH],
        "no_barrier": [
            [("cu", "      __syncthreads();\n      if (valid && col > j) {",
              "      if (valid && col > j) {")],
            [("cu", "while (ld_acquire(&s_front) < need) {\n", "while "
              "(false) {\n")]],
        "no_loads": [
            [("cu", "        const T alpha = *rjj;",
              "        const T alpha = T(1);"),
             ("cu", "      if (valid && col > j) {\n        T* rj = R + "
              "(size_t)j * rsr + col;\n        T top = *rj;",
              "      if (valid && col > j) {\n        T* rj = R + "
              "(size_t)j * rsr + col;\n        T top = T(0);")],
            # staged rows: their cp.async fetches
            [("cu", "cp_async<sizeof(T)>(st + s * kCols", "if (false) "
              "cp_async<sizeof(T)>(st + s * kCols")]],
        "no_wait": [
            [("cu", "      while (*reinterpret_cast<volatile int*>(progress"
              " + src) < need) {\n      }\n", "")],
            [("cu", "      while (ld_acquire_gpu(progress + src) < need) {\n"
              "      }\n", "")]],
    },
}
# (n, kb, B) of P6 and (npad, P) of P7: the update phase's shapes
P6_CASES = [(16384, 16, None, 3), (16384, 1, None, 3), (256, 2, 1000, 20)]
P7_CASES = [(8192, 16, 3)]


def substitute(srcs: dict, name: str, variant: str) -> dict:
    for subs in CUTS[name][variant]:
        if all(old in srcs[f] for f, old, _ in subs):
            out = dict(srcs)
            for f, old, new in subs:
                out[f] = out[f].replace(old, new)
            return out
    raise RuntimeError(f"{name} {variant}: no substitution set matches "
                       f"{name}.cu and cx.cuh")


def build(srcs: dict, name: str, tag: str, out_dir: str, nvcc: str, flags):
    """nvcc of one variant (its source beside its own cx.cuh) → (library
    path, ptxas output)."""
    d = os.path.join(out_dir, tag)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, f), d)
    with open(os.path.join(d, "cx.cuh"), "w") as f:
        f.write(srcs["cx"])
    path = os.path.join(d, f"{name}.cu")
    with open(path, "w") as f:
        f.write(srcs["cu"])
    lib = os.path.join(d, f"lib{name}.so")
    proc = subprocess.run([nvcc, *flags, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    return lib, proc.stderr


def install(_build, ho, name: str, lib):
    """Make ``hopper_ops`` launch from ``lib`` (a path or a loaded
    library) for ``name``."""
    _build._libs[name] = ctypes.CDLL(lib) if isinstance(lib, str) else lib
    for sym in [s for s in ho._fns if s.startswith(f"slate_{name}_")]:
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
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and rows:
        out = subprocess.run([cxxfilt], input="\n".join(
            r["function"] for r in rows), capture_output=True, text=True,
            timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, nm in zip(rows, names):
                r["function"] = nm
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="time the kernels as built, no variants")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("p67_ablation: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from slate_tpu_torch.ops import _build, hopper_ops as ho
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    f32 = torch.float32
    t_start = time.perf_counter()

    def p6_call(n, kb, bsz):
        npad = n if bsz is not None else -(-n // 512) * 512
        l0 = cs.update_factor(torch, n, npad, f32, gen, bsz)
        w = cs.update_vectors(torch, n if bsz else npad, n, kb, kb, f32, gen,
                              0.01, bsz)
        lt = l0.clone()
        narg = None if bsz is not None else n
        return (lambda: lt.copy_(l0),
                lambda: ho.chol_update_sweep(lt, w, 1, narg))

    def p7_call(npad, P):
        r0, u = cs.qr_append_operands(torch, npad, npad, P, P, f32, gen)
        rt = r0.clone()
        return (lambda: rt.copy_(r0),
                lambda: ho.qr_append_build(rt, u, npad))

    calls = {"chol_update": {
        f"n={n} kb={kb}" + (f" B={b}" if b else ""): (*p6_call(n, kb, b), k)
        for n, kb, b, k in P6_CASES},
        "qr_append": {f"npad={n} P={p}": (*p7_call(n, p), k)
                      for n, p, k in P7_CASES}}

    def timed(reset, fn, launches):
        """(device ms per call less the reset copy's, the copy's)."""
        both = cs.device_ms(lambda: (reset(), fn()), launches)
        copy = cs.device_ms(reset, launches)
        return both - copy, copy

    nvcc = _build.nvcc_path()
    out_dir = os.path.join(_build.BUILD_DIR, "p67_ablation")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(CSRC, "cx.cuh")) as f:
        cx_src = f.read()
    out, copies, events, regs = {}, {}, {}, {}
    for name, cases in calls.items():
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            base = {"cu": f.read(), "cx": cx_src}
        built = _build.load(name)
        regs[name] = ptxas_rows(_build.BUILD_LOG.get(name, {}).get(
            "ptxas", ""))
        variants = {"kernel": base}
        if not args.kernel_only:
            variants.update({v: substitute(base, name, v)
                             for v in CUTS[name]})
        for v, srcs in variants.items():
            if v != "kernel":  # the kernel itself: the library as built
                lib, _ = build(srcs, name, f"{name}_{v}", out_dir, nvcc,
                               _build.NVCC_FLAGS)
                install(_build, ho, name, lib)
            for key, (reset, fn, launches) in cases.items():
                ms, copy = timed(reset, fn, launches)
                out[f"{name} {v} {key}"] = ms
                copies[f"{name} {v} {key}"] = copy
        install(_build, ho, name, built)  # the kernel again
        for key, (reset, fn, _) in cases.items():
            reset()
            events[f"{name} {key}"] = cs.cuda_ms(fn)
    print(json.dumps({"p67_device_ms": out, "reset_copy_device_ms": copies,
                      "p67_events_ms": events, "ptxas": regs,
                      "seconds": time.perf_counter() - t_start}),
          flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
