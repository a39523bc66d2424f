"""Build and load the CUDA kernels of ``astcenc_torch/csrc``, and decide
whether a call runs a kernel or its plain version.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with nvcc for sm_90a into ``build/lib<name>-<key>.so`` at the
repository root and loaded with ctypes. ``key`` hashes the sources (the
``.cu`` file and every ``.cuh``) and the nvcc flags, so a library is reused
only if it was built from exactly these sources with these flags.
Nothing here runs at import time.

The kernel switch lives here and nowhere else: every router of ``ops/``
asks ``use_kernel(family, tensor)``, and no other module reads
``ASTC_DISABLE_KERNELS`` or takes a flag that picks a kernel or its plain
version. The answer is False for CPU tensors (any device but the CPU and
CUDA raises), False inside ``plain()``, and otherwise True, except that
``ASTC_DISABLE_KERNELS="msearch,refine"`` switches those two families off,
as in the JAX package (``gather_pallas._kernel_enabled``, read by its
``codec/trial.py``), which honours exactly these two; other names are
ignored. ``kernel_scope()`` reads the variable once for a whole encode
(``compress.compress_image``); outside one it is read at each call.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

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


def stream(device_index: int) -> int:
    """The handle of the current CUDA stream of a device, for a launch: the
    raw handle, without the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream()`` builds around it."""
    return torch._C._cuda_getCurrentRawStream(device_index)


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
#: refine_round, K6 and K7 refine_round2, K8 row_gather, K9 color_pack (the
#: colour pack, in place of the TPU's colour quantizer lookup), and, with
#: no TPU kernel, texel_sum (the glue's texel sums in the CPU's order) and
#: color_unpack (the colour endpoint decode).
KERNELS = ("msearch", "refine", "refine2", "psearch", "refine_round",
           "refine_round2", "row_gather", "color_pack", "texel_sum",
           "color_unpack")


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


# --- the kernel switch -------------------------------------------------------

#: The families a router asks about: K1 msearch; K2, K3 and K5-K7 refine;
#: K4 psearch; K8 row_gather; K9 color_pack; color_unpack (the decode).
#: texel_sum asks nothing: the card's sums must add in the CPU's order.
FAMILIES = ("msearch", "refine", "psearch", "row_gather", "color_pack",
            "color_unpack")
#: The families ``ASTC_DISABLE_KERNELS`` can switch off.
SWITCHED = ("msearch", "refine")

# The families switched off in this context: None outside any scope (read
# the environment at each call).
_off: contextvars.ContextVar = contextvars.ContextVar("astc_kernels_off",
                                                      default=None)


def disabled_kernels() -> frozenset:
    """The names in ``ASTC_DISABLE_KERNELS`` now, parsed as the JAX package
    parses them: comma-separated, whitespace stripped, empty names
    dropped. Only those in ``SWITCHED`` switch a family off."""
    dis = os.environ.get("ASTC_DISABLE_KERNELS", "")
    return frozenset(s.strip() for s in dis.split(",") if s.strip())


def _env_off() -> frozenset:
    return disabled_kernels().intersection(SWITCHED)


@contextlib.contextmanager
def _scope(off: frozenset):
    token = _off.set(off)
    try:
        yield
    finally:
        _off.reset(token)


def plain():
    """A scope in which every router runs its plain version on any
    device: the reference the kernels are compared with on the card."""
    return _scope(frozenset(FAMILIES))


def kernel_scope():
    """A scope that reads ``ASTC_DISABLE_KERNELS`` once, for the calls
    inside it; inside ``plain()`` it stays all plain."""
    off = _off.get()
    return _scope(_env_off() if off is None else off)


def kernel_on(family: str) -> bool:
    """Whether ``family`` runs its kernel on CUDA tensors now."""
    off = _off.get()
    return family not in (_env_off() if off is None else off)


def use_kernel(family: str, t) -> bool:
    """Whether a call of ``family`` on tensor ``t`` runs the kernel: for
    CUDA tensors as ``kernel_on`` says, never for CPU tensors; any other
    device raises."""
    if t.is_cuda:
        return kernel_on(family)
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False
