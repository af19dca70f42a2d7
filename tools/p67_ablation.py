#!/usr/bin/env python3
"""Where P6's, P7's and P8's time per launch goes, on one NVIDIA GPU.

    python3 tools/p67_ablation.py                # the kernels and variants
    python3 tools/p67_ablation.py --kernel-only  # the kernels as built
    python3 tools/p67_ablation.py --sources qr_append --out FILE

Builds slate_tpu_torch/csrc/chol_update.cu (P6) and qr_append.cu (P7 and
P8) as they are and in variants that each take one part of a kernel out
or change one of its constants by text substitution (the cut variants
give wrong results and serve only to time), puts each build in the place
of the library that ``hopper_ops`` loads, and prints the device time per
launch of the public calls ``chol_update_sweep``, ``qr_append_build``
and ``qr_append_apply`` at the update phase's shapes of
``chip_smoke.py`` (n = 16384 f32 at kb = 16 and kb = 1, the
(1000, 256, 256) stack at kb = 2; R 8192² f32 with P = 16 appended rows;
P8 on 8192 steps of a 512-column right-hand side, the appended solve's
16 columns padded to nb = 512, at P = 16 and 8 in float32 and
complex64): launches queued behind ``torch.cuda._sleep``, each after a
copy that restores the operand (so a variant's wrong values cannot drift
into slow paths), less the copies' own device time. The variants:

  no_math      the IEEE square root returns its argument and the IEEE
               divisions become products (csrc/cx.cuh: P6 and P7); P8's
               reflection replaced by one add
  no_barrier   the block-wide barrier (P6 parent: the one before the
               rows apply a column's pairs; P7 parent: the one before the
               columns apply a reflector) or, in the wavefront designs,
               the warps' waits on the front's step counter
  no_loads     the loads on the chain: P6's tile loads, P7's alpha and
               R-row loads (the staging, in the new designs); P8's w, tau
               and ct's row (the staged design: the staging and the
               shared-memory reads), each step reflecting with its own d
               as the reflector, which keeps the chain: P8's chain floor
  no_wait      the inter-CTA spin on the publishing CTA's progress
  threads_32, threads_64   P8's CTA at 32 or 64 column threads (128)
  split_none   every P8 column on one lane (two from P = 16, or 8 in
               complex types, as built)
  bufs_2       P8's chunks staged one ahead (two as built)
  unroll_2, unroll_4       P8's step loop unrolled by 2 or 4 in every
               type (4 in real types, 2 in complex, as built)

Each variant names its substitutions for each kernel design the
repository has had (for each kernel the first set whose patterns are all
in the sources is used; a variant no set of a kernel's matches leaves it
as it is and is listed under "variants_without_a_match"), so a copy of
this script beside an older tree's ``git archive`` times that tree's
kernels. Beside them: each kernel's ``ms`` (CUDA events around one call,
median of 7, host launch work included), ptxas's registers and spill
stores for every instance of the sources as built and of P8 in each
variant; the cycles of one dependent rounded add and multiply in float32
and float64, of a lane-pair shuffle and add, and per add of eight
independent chains (clock64() on one warp), the SM clock they ran at
and P8's chain bound at (8192, 16) in each type at the top SM clock
(n·(3 multiplies + (P + 1) adds) in real types, P + 4 adds in complex);
and, unless ``--no-solve``, the update phase's qr operator (32768 × 8192,
nb = 512) on a Session: its replayed 16-column solve before and after 16
appended rows and the append's wall, then the append again on a second
Session under torch.profiler (device time by kernel: P7, copies and
fills, reductions, the rest). One JSON line (also to ``--out``), then
the card's nvidia-smi name and power limit.

Exits 2 without a CUDA device. Imports nothing of JAX or slate_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
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
# source -> kernel -> variant -> one list of substitutions per design
CUTS = {
    "chol_update": {"P6": {
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
    }},
    "qr_append": {"P7": {
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
    }, "P8": {
        # the reflection replaced by one add that keeps w's last entry and
        # tau read
        "no_math": [
            # a thread per column, w, tau and ct's row loaded in the step
            [("cu", "    reflect<T, P>(top, d, w, tau[j]);",
              "    top = add_rn(top, add_rn(w[P - 1], tau[j]));")],
            # staged chunks ahead, a step's operands one step ahead
            [("cu", "      top = apply_step<T, H, L>(top, d, wv, tj);",
              "      top = add_rn(top, add_rn(wv[H - 1], tj));")]],
        # no loads of w, tau or ct's row: the step reflects with its own d
        # as the reflector (the same chain of P + 4 operations)
        "no_loads": [
            [("cu", "w[p] = W[(size_t)p * npad + j];", "w[p] = T(0);"),
             ("cu", "    T top = *cj;", "    T top = d[0];"),
             ("cu", "    reflect<T, P>(top, d, w, tau[j]);",
              "    reflect<T, P>(top, d, d, d[P - 1]);")],
            [("cu", "    if (i * kApplyStep < n)\n", "    if (false)\n"),
             ("cu", "    if (ahead < n)\n", "    if (false)\n"),
             ("cu", "      lds_row(w_, ws + s * P);\n", ""),
             ("cu", "      top_ = tops[s * kColsCta];", "      top_ = d[0];"),
             ("cu", "      top = apply_step<T, H, L>(top, d, wv, tj);",
              "      top = apply_step<T, H, L>(top, d, d, d[H - 1]);")]],
        # the CTA's width (right results)
        "threads_32": [[("cu", "constexpr int kApplyThreads = 128;",
                         "constexpr int kApplyThreads = 32;")]],
        "threads_64": [[("cu", "constexpr int kApplyThreads = 128;",
                         "constexpr int kApplyThreads = 64;")]],
        # every column on one lane; two buffers (staged one chunk ahead)
        "split_none": [[("cu", "constexpr int kApplySplitP = 16;",
                         "constexpr int kApplySplitP = 64;")]],
        "bufs_2": [[("cu", "constexpr int kApplyBufs = 3;",
                     "constexpr int kApplyBufs = 2;")]],
        # the step loop unrolled by 2 or 4 in every type (as built: 4 in
        # real types, 2 in complex)
        "unroll_2": [[("cu", "#pragma unroll(kUnroll)", "#pragma unroll 2")]],
        "unroll_4": [[("cu", "#pragma unroll(kUnroll)", "#pragma unroll 4")]],
    }},
}
# (n, kb, B) of P6, (npad, P) of P7 and (npad, q, P) of P8: the update
# phase's shapes (P8: the appended solve's 16 columns padded to nb = 512)
P6_CASES = [(16384, 16, None, 3), (16384, 1, None, 3), (256, 2, 1000, 20)]
P7_CASES = [(8192, 16, 3)]
# (npad, q, P, dtype) of P8, the served one first: the split's threshold
# is read at P = 8 and in complex64 too
P8_CASES = [(8192, 512, 16, "float32", 20), (8192, 512, 8, "float32", 20),
            (8192, 512, 16, "complex64", 10), (8192, 512, 8, "complex64", 10)]
# a dependent chain of add_rn or mul_rn on one warp, timed by clock64():
# the latency of one rounded operation, and the SM clock it ran at
LATENCY_SRC = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float op(float x, float y, int mul) {
  return mul ? __fmul_rn(x, y) : __fadd_rn(x, y);
}
__device__ __forceinline__ double op(double x, double y, int mul) {
  return mul ? __dmul_rn(x, y) : __dadd_rn(x, y);
}
// KIND 0: a chain of adds, 1: of multiplies, 2: of shuffles (a lane pair
// swapping) each followed by an add, 3: eight independent add chains
template <typename R, int KIND>
__global__ void chain(R* out, long long* cycles, int iters, R y) {
  R x = R(1) + R(threadIdx.x), v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = x + R(k);
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      if (KIND == 3)
        v[k % 8] = op(v[k % 8], y, 0);
      else if (KIND == 2)
        x = op(__shfl_xor_sync(0xffffffffu, x, 1), y, 0);
      else
        x = op(x, y, KIND);
    }
  }
  const long long t1 = clock64();
#pragma unroll
  for (int k = 0; k < 8; ++k) x = x + v[k];
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}
template <typename R>
int launch(void* out, void* cycles, int iters, int kind, cudaStream_t st) {
  R* o = static_cast<R*>(out);
  long long* c = static_cast<long long*>(cycles);
  const R y = kind == 1 ? R(1.0000001) : R(1e-6);
  switch (kind) {
    case 0: chain<R, 0><<<1, 32, 0, st>>>(o, c, iters, y); break;
    case 1: chain<R, 1><<<1, 32, 0, st>>>(o, c, iters, y); break;
    case 2: chain<R, 2><<<1, 32, 0, st>>>(o, c, iters, y); break;
    default: chain<R, 3><<<1, 32, 0, st>>>(o, c, iters, y); break;
  }
  return (int)cudaGetLastError();
}
extern "C" int dep_chain(void* out, void* cycles, int iters, int f64,
                         int kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(out, cycles, iters, kind, st)
             : launch<float>(out, cycles, iters, kind, st);
}
"""


def substitute(srcs: dict, name: str, variant: str):
    """The sources of ``name`` with ``variant``'s cuts for each of its
    kernels (the first set whose patterns are all in the sources) → (the
    sources, the kernels cut). A variant no set of a kernel's matches
    leaves that kernel as it is (a design without that part)."""
    out, cut = dict(srcs), []
    for kernel, variants in CUTS[name].items():
        for subs in variants.get(variant, []):
            if all(old in out[f] for f, old, _ in subs):
                for f, old, new in subs:
                    out[f] = out[f].replace(old, new)
                cut.append(kernel)
                break
    return out, cut


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


def latency(torch, nvcc: str, out_dir: str):
    """Cycles per dependent rounded add and multiply in float32 and float64
    (one warp, 64 × iters operations between two clock64() reads), per
    shuffle-then-add of a lane pair, and per add of eight independent add
    chains (one warp's issue rate); and the SM clock in MHz that the chains
    ran at (cycles over their CUDA-event time)."""
    d = os.path.join(out_dir, "latency")
    os.makedirs(d, exist_ok=True)
    src = os.path.join(d, "latency.cu")
    with open(src, "w") as f:
        f.write(LATENCY_SRC)
    lib = os.path.join(d, "liblatency.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, src], check=True, capture_output=True)
    fn = ctypes.CDLL(lib).dep_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.zeros(32, dtype=torch.float64, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res, mhz = {}, []
    for f64, dt in ((0, "float32"), (1, "float64")):
        for mul, kind in ((0, "add"), (1, "mul"), (2, "shfl_add"),
                          (3, "add_8_chains")):
            iters = 40000
            fn(out.data_ptr(), cyc.data_ptr(), 100, f64, mul, stream)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            rc = fn(out.data_ptr(), cyc.data_ptr(), iters, f64, mul, stream)
            e1.record()
            e1.synchronize()
            if rc:
                raise RuntimeError(f"dep_chain: CUDA error {rc}")
            cycles = int(cyc.item())
            res.setdefault(dt, {})[kind] = cycles / (64 * iters)
            mhz.append(cycles / e0.elapsed_time(e1) / 1e3)
    return res, statistics.median(mhz)


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def chain_bound_ms(n: int, P: int, complex_: bool, lat: dict,
                   mhz: float) -> float:
    """n steps of P8's dependent chain at ``mhz``: three rounded multiplies
    and P + 1 adds in real types (P + 4 operations), P + 4 adds in complex
    ones (P + 7: a product part by part is a multiply and then an add)."""
    adds = P + 4 if complex_ else P + 1
    return n * (3 * lat["mul"] + adds * lat["add"]) / (mhz * 1e3)


def appended_solve(torch, stt, cs, gen, n: int, nb: int, reps: int = 5):
    """The update phase's qr operator (2n × n/2, nb): its replayed
    16-column solve before and after 16 appended rows (CUDA events around
    ``solve_matrix``, median of ``reps``), the append's wall, and, on a
    second Session, the append under torch.profiler: its device time by
    kernel (P7, copies and fills, reductions, the rest) and its wall."""
    from torch.profiler import ProfilerActivity, profile
    dev = "cuda"
    m_q, n_q = 2 * n, n // 2
    aq = torch.randn((m_q, n_q), generator=gen, device=dev)
    u = torch.randn((16, n_q), generator=gen, device=dev)
    b0 = stt.from_dense(torch.randn((m_q, 16), generator=gen, device=dev),
                        nb, device=dev)
    b1 = stt.from_dense(torch.randn((m_q + 16, 16), generator=gen,
                                    device=dev), nb, device=dev)
    out = {}

    def session():
        sess = stt.Session(device=dev)
        h = sess.register(stt.from_dense(aq, nb, device=dev), op="qr")
        sess.warmup(h, nrhs=16, update_k=16)
        torch.cuda.synchronize()
        return sess, h

    sess, h = session()
    m = sess.metrics
    r0 = m.get("graph_replays")
    out["base_solve_ms"] = cs.cuda_ms(lambda: sess.solve_matrix(h, b0),
                                      reps)
    t0 = time.perf_counter()
    sess.update(h, u)
    torch.cuda.synchronize()
    out["append_wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["appended_solve_ms"] = cs.cuda_ms(lambda: sess.solve_matrix(h, b1),
                                          reps)
    out["replays"] = m.get("graph_replays") - r0  # 2·(1 + reps): all replayed
    sess.close()
    sess, h = session()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.update(h, u)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    sess.close()
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and str(e.device_type).endswith("CUDA"):
            kernels[e.key] = (us / 1e3, e.count)
    split = {"P7": 0.0, "copies_and_fills": 0.0, "reductions": 0.0,
             "other": 0.0}
    for k, (ms, _) in kernels.items():
        low = k.lower()
        part = ("P7" if "qr_append_build" in k else "copies_and_fills" if any(
            t in low for t in ("copy", "memcpy", "memset", "fill")) else
            "reductions" if "reduce" in low else "other")
        split[part] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    out["append_profiled"] = {
        "wall_ms": wall, "device_ms": split,
        "busy_ms": sum(split.values()),
        "top_kernels": [{"name": k[:80], "ms": ms, "count": c}
                        for k, (ms, c) in top]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="time the kernels as built, no variants")
    ap.add_argument("--sources", default="chol_update,qr_append",
                    help="comma-separated sources to time")
    ap.add_argument("--no-solve", action="store_true",
                    help="skip the appended solve and the latency chains")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("p67_ablation: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import slate_tpu_torch as stt
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

    def p8_call(npad, q, P, dtype):
        # the reflectors of a P7 run with one zero appended row, as the
        # smoke's P8 rows
        dt = getattr(torch, dtype)
        r0, u = cs.qr_append_operands(torch, npad, npad, P, P - 1, dt, gen)
        w, tau = ho.qr_append_build(r0, u, npad)
        c0 = torch.randn((npad, q), generator=gen, device="cuda",
                         dtype=torch.float64).to(dt)
        d = torch.zeros((P, q), device="cuda", dtype=dt)
        d[:P - 1] = torch.randn((P - 1, q), generator=gen, device="cuda",
                                dtype=torch.float64).to(dt)
        ct = c0.clone()
        return (lambda: ct.copy_(c0),
                lambda: ho.qr_append_apply(ct, d, w, tau, npad))

    cases = {
        "P6": {f"n={n} kb={kb}" + (f" B={b}" if b else ""):
               (*p6_call(n, kb, b), k) for n, kb, b, k in P6_CASES},
        "P7": {f"npad={n} P={p}": (*p7_call(n, p), k)
               for n, p, k in P7_CASES},
        "P8": {f"npad={n} q={q} P={p} {dt}": (*p8_call(n, q, p, dt), k)
               for n, q, p, dt, k in P8_CASES}}

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
    out, copies, events, regs, variant_regs, uncut = {}, {}, {}, {}, {}, {}
    for name in args.sources.split(","):
        kernels = list(CUTS[name])
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            base = {"cu": f.read(), "cx": cx_src}
        built = _build.load(name)
        regs[name] = ptxas_rows(_build.BUILD_LOG.get(name, {}).get(
            "ptxas", ""))
        variants = {"kernel": (base, kernels)}
        if not args.kernel_only:
            for v in dict.fromkeys(v for k in kernels for v in CUTS[name][k]):
                srcs, cut = substitute(base, name, v)
                uncut[f"{name} {v}"] = [k for k in kernels
                                        if v in CUTS[name][k] and k not in cut]
                if cut:
                    variants[v] = (srcs, cut)
        for v, (srcs, cut) in variants.items():
            if v != "kernel":  # the kernel itself: the library as built
                lib, log = build(srcs, name, f"{name}_{v}", out_dir, nvcc,
                                 _build.NVCC_FLAGS)
                install(_build, ho, name, lib)
                if "P8" in cut:
                    variant_regs[v] = [r for r in ptxas_rows(log)
                                       if "apply" in r["function"]]
            for kernel in cut:
                for key, (reset, fn, launches) in cases[kernel].items():
                    ms, copy = timed(reset, fn, launches)
                    out[f"{kernel} {v} {key}"] = ms
                    copies[f"{kernel} {v} {key}"] = copy
        install(_build, ho, name, built)  # the kernel again
        for kernel in kernels:
            for key, (reset, fn, _) in cases[kernel].items():
                reset()
                events[f"{kernel} {key}"] = cs.cuda_ms(fn)
    res = {"p67_device_ms": out, "reset_copy_device_ms": copies,
           "p67_events_ms": events, "ptxas": regs,
           "ptxas_p8_variants": variant_regs,
           "variants_without_a_match": {k: v for k, v in uncut.items() if v}}
    if not args.no_solve:
        lat, mhz = latency(torch, nvcc, out_dir)
        max_mhz = float(smi("clocks.max.sm").split()[0])
        res["dep_latency_cycles"] = lat
        res["chain_clock_mhz"] = mhz
        res["max_sm_clock_mhz"] = max_mhz
        res["p8_chain_bound_ms"] = {
            dt: chain_bound_ms(8192, 16, dt.startswith("complex"),
                               lat[real], max_mhz)
            for dt, real in (("float32", "float32"), ("float64", "float64"),
                             ("complex64", "float32"),
                             ("complex128", "float64"))}
        res["appended_solve"] = appended_solve(torch, stt, cs, gen, 16384,
                                               512)
    res["sm_clock"] = smi("clocks.sm,clocks.max.sm")
    res["seconds"] = time.perf_counter() - t_start
    line = json.dumps(res)
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
