"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` file (one process per file, all
started together) and links them into one shared library with a plain C
interface, at first use, into ``build/torch_kernels/<hash>/``
beside the package (a directory ``.gitignore`` lists). The hash covers
the sources and the flags, so an edited kernel rebuilds and an unchanged
one loads from the cache. The library is loaded with ``ctypes``; each C
entry point returns ``cudaGetLastError()`` and ``check`` raises when it is
not 0.

Nothing here runs at import time: the CPU tests import every module.
``kernel_library`` holds a lock while it builds and loads, so threads
that ask for it at once (first requests of a threaded server) run one
build and share one library.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

__all__ = ["kernel_library", "check", "NVCC_FLAGS"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
_lock = threading.Lock()

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, lib, path, build_seconds, ptxas_log, cached):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log
        self.cached = cached


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (sm_90a) to build")


def kernel_library():
    """Build (once per source hash) and load the kernel library."""
    with _lock:
        return _kernel_library()


@functools.lru_cache(maxsize=None)
def _kernel_library():
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    out_dir = os.path.join(_BUILD_ROOT, h.hexdigest()[:16])
    so_path = os.path.join(out_dir, "libvpr_kernels.so")
    log_path = os.path.join(out_dir, "ptxas.log")
    cached = os.path.exists(so_path)
    t0 = time.perf_counter()
    if not cached:
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
        nvcc = _nvcc()
        with ThreadPoolExecutor(len(sources)) as pool:
            procs = list(pool.map(lambda so: subprocess.run(
                [nvcc, *NVCC_FLAGS, "-c", "-o", so[1], so[0]],
                capture_output=True, text=True), zip(sources, objs)))
        logs = [proc.stdout + proc.stderr for proc in procs]
        link = None
        if all(proc.returncode == 0 for proc in procs):
            link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if link is None or link.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        with open(log_path, "w", encoding="utf-8") as f:
            f.write("".join(logs))
        os.replace(tmp, so_path)
    seconds = time.perf_counter() - t0
    ptxas = ""
    if os.path.exists(log_path):
        with open(log_path, encoding="utf-8") as f:
            ptxas = f.read()
    return KernelLibrary(ctypes.CDLL(so_path), so_path, seconds, ptxas,
                         cached)


def check(err, name):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
