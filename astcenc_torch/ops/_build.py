"""Build and load the CUDA kernels of ``astcenc_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with nvcc for sm_90a into ``build/lib<name>-<key>.so`` at the
repository root and loaded with ctypes. ``key`` hashes the sources (the
``.cu`` file and every ``.cuh``) and the nvcc flags, so a library is reused
only if it was built from exactly these sources with these flags.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG_DIR), "build")

# No --use_fast_math: the trial errors and the least-squares refit need
# IEEE divides and square roots. --fmad=false keeps a*b+c as two roundings,
# as the reference computes it.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-lineinfo"]

_lock = threading.Lock()
_libs: dict = {}
#: Seconds from the start of the nvcc batch to each library compiled by
#: this process (empty if every library was found built).
build_seconds: dict = {}


def check(t, name: str, dtype, shape) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address for a ctypes call."""
    return ctypes.c_void_p(t.data_ptr())


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            p = os.path.join(cand, "bin", "nvcc")
            if os.path.isfile(p):
                return p
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return p


def build_key(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, the headers and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    deps = [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                   if f.endswith(".cuh"))
    for f in deps:
        h.update(f.encode())
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


#: The kernel sources: K1 msearch, K2 refine, K3 refine2, K4 psearch, K5
#: refine_round, K6 and K7 refine_round2, K9 quant_lookup.
KERNELS = ("msearch", "refine", "refine2", "psearch", "refine_round",
           "refine_round2", "quant_lookup")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}-{build_key(name)}.so")


def build(names=KERNELS) -> None:
    """Compile every library of ``names`` not built yet, one nvcc process
    per source, all started together."""
    with _lock:
        todo = [n for n in names if not os.path.isfile(_lib_path(n))]
        if not todo:
            return
        os.makedirs(BUILD, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            tmp = _lib_path(name) + f".{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        errors = []
        for name, (tmp, proc) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}:\n{err}")
                continue
            os.replace(tmp, _lib_path(name))
            build_seconds[name] = time.perf_counter() - t0
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """Build (unless built from the same sources and flags) and load
    ``csrc/<name>.cu``; later calls return the loaded library at once
    (the source hash is not taken again on every launch)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib
