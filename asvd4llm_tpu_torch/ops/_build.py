"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own shared library under ``build/`` (listed in
``.gitignore``). The library name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds on its next use. Nothing is built when a
module is imported: the first call that launches a kernel builds it, and
``build()`` builds every missing library at once, one ``nvcc`` per source,
all started together.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("fused_lowrank", "latent_attention", "fused_lowrank_q8",
           "fused_lowrank_q4", "paged_dense_attention", "paged_latent_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
# compiler output of each build in this process (ptxas register/smem lines)
build_logs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from csrc/ on first use")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, in
    parallel. Returns the wall seconds spent; raises with the compiler's
    output if any build fails."""
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{fn(err).decode()} (cudaError {err})")
