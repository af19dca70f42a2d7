"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``slate_tpu_torch/csrc/`` is compiled on first use into
its own shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

into ``slate_tpu_torch/_build/`` (listed in ``.gitignore``). The file name
carries a hash of the source, of every header (``*.cuh``) in ``csrc/``
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded. Only the sources in the repository are
used, ``--use_fast_math`` is never passed (the kernels' NaN contracts
need IEEE arithmetic), and a failed build raises.

Host libraries (``csrc/host/*.cc``: the steqr QR iteration) take the
same route through the host compiler::

    g++ -O3 -fPIC -fopenmp -shared -o _build/lib<name>-<hash>.so <name>.cc

built at first use into the same directory, hashed the same way, and a
failed build raises ``SlateError`` naming the command: there is no
Python fallback.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

from ..core.exceptions import SlateError

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("chol_tile", "lu_panel", "qr_panel", "herk_lower",
           "trtri_leaves", "lu_nopiv", "lu_panel_batched",
           "chol_tile_batched", "qr_panel_batched", "chol_update",
           "qr_append", "secular")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_DIR = os.path.join(CSRC_DIR, "host")
HOST_SOURCES = ("steqr",)
GXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-shared")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build of each source printed (ptxas register/smem use)
BUILD_LOG: Dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise SlateError("slate_tpu_torch: nvcc not found (set CUDA_HOME or "
                     "put nvcc on PATH) — the CUDA kernels cannot be built")


def gxx_path() -> str:
    cand = shutil.which("g++")
    if not cand:
        raise SlateError("slate_tpu_torch: no host C++ compiler (g++) found "
                         "— the host libraries cannot be built")
    return cand


def _host_lib_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    with open(os.path.join(HOST_DIR, f"{name}.cc"), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _lib_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _built(name: str, out: str, compiler: str, flags, src: str) -> str:
    """``out``, compiled from ``src`` unless it exists (written under a
    temporary name, then moved into place). A failed build raises,
    naming the command and what the compiler printed."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SlateError(f"build failed for {os.path.basename(src)} (exit "
                         f"{proc.returncode}): {' '.join(cmd)}\n"
                         f"{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": proc.stderr.strip()}
    return out


def _compile(name: str) -> str:
    return _built(name, _lib_path(name), nvcc_path(), NVCC_FLAGS,
                  os.path.join(CSRC_DIR, f"{name}.cu"))


def _compile_host(name: str) -> str:
    return _built(name, _host_lib_path(name), gxx_path(), GXX_FLAGS,
                  os.path.join(HOST_DIR, f"{name}.cc"))


def build_all() -> Dict[str, dict]:
    """Compile every kernel source and host library, one compiler per
    source, all started together. Returns BUILD_LOG (seconds and what the
    compiler printed per source: ptxas's registers and spills for nvcc)."""
    jobs = [(_compile, s) for s in SOURCES] + [(_compile_host, s)
                                               for s in HOST_SOURCES]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        for fut in [pool.submit(fn, s) for fn, s in jobs]:
            fut.result()
    return dict(BUILD_LOG)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_compile(name))
        return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``csrc/host/<name>.cc`` (built with g++ on
    first use; a failed build raises)."""
    key = f"host/{name}"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = _libs[key] = ctypes.CDLL(_compile_host(name))
        return lib
