"""Rehearse the CUDA kernels' card tests on a CPU.

Builds every kernel of ``astcenc_torch/csrc`` with g++ through ``shim.h``
(a stand-in of the CUDA runtime: one std::thread per CUDA thread), points
the port's ctypes libraries at those builds, and runs
``tests/test_torch_cuda.py`` with the card replaced by the CPU: CPU
tensors report ``is_cuda`` so the routers take the kernel wrappers, and
the ``cuda_device`` fixture hands out the CPU. A kernel runs thousands of
times slower than on the card, so pick small tests with ``-k``::

    python tools/cuda_cpu_shim/rehearse.py -k "footprints and 8"

Before and after a change that must not move a kernel's results, record
every wrapper's outputs from both source trees and compare them bit for
bit::

    python tools/cuda_cpu_shim/rehearse.py --src OLD/astcenc_torch/csrc \\
        --record old.pt -k "refine_round or color_pack"
    python tools/cuda_cpu_shim/rehearse.py --record new.pt \\
        -k "refine_round or color_pack"
    python tools/cuda_cpu_shim/rehearse.py --compare old.pt new.pt

What such a run cannot see: CUDA's libm (atan2f in K1 differs from
glibc's in the last bit, so K1 is held against itself, not the card), the
card's memory model beyond barriers and shuffles, and anything PyTorch's
CUDA build computes otherwise than its CPU build (ROADMAP §C).
"""

import argparse
import concurrent.futures
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(ROOT, "astcenc_torch", "csrc")
sys.path.insert(0, ROOT)

from astcenc_torch.ops import _build  # noqa: E402

_SHARED = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")
_LAUNCH = re.compile(r"([\w:]+(?:<\w+>)?)<<<(.+?)>>>\((.*?)\);", re.S)


def _launch_call(m) -> str:
    """``k<<<grid, block[, smem[, stream]]>>>(args);`` as a function call."""
    cfg = [c.strip() for c in m.group(2).split(",")]
    cfg += ["0", "nullptr"][len(cfg) - 2:]
    return (f"shim_launch({m.group(1)}, {cfg[0]}, {cfg[1]}, {cfg[2]}, "
            f"{m.group(3)});")


def _translate(src: str, dst: str) -> None:
    for f in os.listdir(src):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(src, f)) as fh:
                s = fh.read()
            s = _SHARED.sub(r"\1* \2 = reinterpret_cast<\1*>(shim_smem);", s)
            s = _LAUNCH.sub(_launch_call, s)
            with open(os.path.join(dst, f), "w") as fh:
                fh.write(s)


def build(src: str, out: str, names=_build.KERNELS) -> dict:
    """g++ builds of ``src/<name>.cu`` into ``out``, all started together;
    the path of each library by name."""
    os.makedirs(out, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=out)
    _translate(src, tmp)
    paths = {n: os.path.join(out, f"lib{n}.so") for n in names}

    def one(n):
        cmd = ["g++", "-std=c++20", "-O2", "-ffp-contract=off",
               "-fno-fast-math", "-shared", "-fPIC", "-w", "-I", HERE,
               "-include", "shim.h", "-x", "c++",
               os.path.join(tmp, n + ".cu"), "-o", paths[n], "-lpthread"]
        r = subprocess.run(cmd, capture_output=True, text=True)
        return n, r.returncode, r.stderr

    with concurrent.futures.ThreadPoolExecutor(len(paths)) as ex:
        for n, rc, err in ex.map(one, paths):
            if rc:
                raise SystemExit(f"g++ failed on {n}.cu:\n{err[:6000]}")
    return paths


class _Stream:
    cuda_stream = 0


def _wrappers():
    """(module, name) of every kernel wrapper (the ``*_cuda`` functions)."""
    from astcenc_torch.ops import (color_pack, gather, msearch, psearch,
                                   refine)
    for mod in (color_pack, gather, msearch, psearch, refine):
        for name in dir(mod):
            if name.endswith("_cuda") and callable(getattr(mod, name)):
                yield mod, name


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x.detach().clone()]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return []


class Plugin:
    """Replaces the card by the CPU for one pytest session."""

    def __init__(self, libs: dict, record: str | None):
        self.record = record
        self.calls = []
        for n, p in libs.items():
            _build._libs[n] = ctypes.CDLL(p)
        torch.cuda.is_available = lambda: True
        torch.cuda.synchronize = lambda *a, **k: None
        torch.cuda.current_stream = lambda *a, **k: _Stream()
        torch.Tensor.is_cuda = property(lambda self: True)
        _build.stream = lambda i: 0
        if record:
            for mod, name in _wrappers():
                setattr(mod, name, self._recorded(name, getattr(mod, name)))

    def _recorded(self, name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            self.calls.append((name, _flat(out)))
            return out
        return call

    @pytest.hookimpl(tryfirst=True)
    def pytest_pyfunc_call(self, pyfuncitem):
        if "cuda_device" in pyfuncitem.funcargs:
            pyfuncitem.funcargs["cuda_device"] = torch.device("cpu")

    def pytest_sessionfinish(self):
        if self.record:
            torch.save(self.calls, self.record)
            print(f"\nrecorded {len(self.calls)} wrapper calls to "
                  f"{self.record}")


def compare(a: str, b: str) -> int:
    """Bit-for-bit comparison of two recordings; the number that differ."""
    ca, cb = torch.load(a), torch.load(b)
    bad = 0
    if [n for n, _ in ca] != [n for n, _ in cb]:
        print("the recordings made different calls")
        return 1
    for i, ((name, ta), (_, tb)) in enumerate(zip(ca, cb)):
        for j, (x, y) in enumerate(zip(ta, tb)):
            if x.shape != y.shape or x.dtype != y.dtype:
                same = False
            elif x.dtype.is_floating_point:
                same = bool((x.view(torch.int32 if x.element_size() == 4
                                    else torch.int64)
                             == y.view(torch.int32 if y.element_size() == 4
                                       else torch.int64)).all())
            else:
                same = bool((x == y).all())
            if not same:
                bad += 1
                print(f"call {i} {name} output {j}: differs")
    print(f"{len(ca)} calls, {bad} outputs differ")
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=CSRC,
                    help="kernel sources (default: this checkout's)")
    ap.add_argument("--out", default=None,
                    help="build directory (default: a temporary one)")
    ap.add_argument("--record", default=None,
                    help="save every kernel wrapper's outputs to this file")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two recordings bit for bit and exit")
    args, rest = ap.parse_known_args()
    if args.compare:
        sys.exit(1 if compare(*args.compare) else 0)
    out = args.out or tempfile.mkdtemp(prefix="cuda_cpu_shim_")
    libs = build(os.path.abspath(args.src), out)
    rc = pytest.main(["--noconftest", "-m", "cuda", "-q", "-p",
                      "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_torch_cuda.py")]
                     + rest, plugins=[Plugin(libs, args.record)])
    sys.exit(int(rc))


if __name__ == "__main__":
    main()
