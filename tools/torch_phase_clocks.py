"""Cycle shares per phase of kernels K1 (mode search) and K2 (1-plane
refinement) of astcenc_torch, and their registers, shared memory and
spills, on one CUDA card.

    python3 tools/torch_phase_clocks.py [--tree DIR] [--out FILE]

``--tree`` names a checkout of the repository (default: this one). Its
``csrc/msearch.cu`` and ``csrc/refine.cu`` are built with nvcc and the
package's flags plus ``-DASTC_PHASE_CLOCKS`` into ``build/phase/``. Each
source marks its own phases (``PHASE_START``/``PHASE_MARK`` of
``csrc/common.cuh``, the names on its ``// phases:`` lines); the tool
stops on a source without marks. At each mark the marking threads (thread
0 of each CTA in K1, lane 0 of each warp in K2) add the ``clock64()``
cycles since their previous mark to the phase's counter.

The kernels' inputs are those a 512x512 main-path encode (seed 1, the
``chip_smoke.py`` capture) hands each form on its first call: K1 at 1
partition, 2 planes, 2 and 3 partitions; K2 at 1, 2 and 3 partitions.
Each form runs once through the checkout's own wrapper with the
instrumented library; the script prints one JSON line per form (phase
names, cycles, shares, and the milliseconds per launch of the
uninstrumented kernel over 5 launches, CUDA events) and the ``-Xptxas -v``
lines of the uninstrumented build of each kernel. The instrumentation
costs time, so its cycle counts are shares, not kernel times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _phases(src: str, name: str) -> list:
    """The phase names a kernel source declares on its "// phases:" lines."""
    m = re.search(r"// phases:((?:.*\n//  .*)*.*)", src)
    if "PHASE_MARK" not in src or m is None:
        raise SystemExit(f"{name}.cu marks no phases")
    return m.group(1).replace("//", " ").split()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=_HERE,
                    help="checkout whose kernels are measured")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("torch_phase_clocks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from astcenc_torch import api, testdata
    from astcenc_torch.ops import _build, msearch, psearch, refine
    assert os.path.dirname(os.path.dirname(_build.CSRC)) == tree, _build.CSRC
    smi = chip_smoke._smi()
    lines = []

    def emit(rec):
        rec["card"] = smi
        line = json.dumps(rec)
        print(line, flush=True)
        lines.append(line)

    out_dir = os.path.join(tree, "build", "phase")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.nvcc_path()
    libs, names = {}, {}
    for name in ("msearch", "refine"):
        path = os.path.join(_build.CSRC, name + ".cu")
        with open(path) as fh:
            names[name] = _phases(fh.read(), name)
        so = os.path.join(out_dir, f"lib{name}_phase.so")
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-DASTC_PHASE_CLOCKS",
                            "-o", so, path], capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{r.stderr}")
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                            os.path.join(out_dir, f"lib{name}_v.so"), path],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"nvcc -Xptxas -v failed for {name}:\n{r.stderr}")
        emit({"kernel": name, "ptxas": [
            ln.strip() for ln in r.stderr.splitlines()
            if "Used" in ln or "spill" in ln or "smem" in ln]})
        libs[name] = ctypes.CDLL(so)
        libs[name].astc_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]

    dev = torch.device("cuda", 0)
    ctx = api.context_alloc(api.config_init(api.Profile.LDR, 6, 6, 1,
                                            api.Quality.MEDIUM, 0), device=dev)
    img = testdata.synthetic_image(chip_smoke.CAPTURE, chip_smoke.CAPTURE, 1,
                                   independent_alpha=True)
    seen, restore = chip_smoke._capture((msearch, refine, psearch))
    try:
        api.compress_image(ctx, img)
    finally:
        restore()
    torch.cuda.synchronize()

    runs = [("msearch", "K1", f, lambda a, kw: msearch.mode_search_cuda(*a, **kw))
            for f in ("pc1", "two", "pc2", "pc3")]
    runs += [("refine", "K2", f, lambda a, kw: refine.trial1_refine_cuda(*a))
             for f in ("pc1", "pc2", "pc3")]
    buf = (ctypes.c_ulonglong * 9)()
    for name, kern, form, call in runs:
        a, kw = seen[(kern, form)]
        lib = libs[name]
        saved = _build._libs.get(name)
        _build._libs[name] = lib
        try:
            call(a, kw)                         # warm-up
            torch.cuda.synchronize()
            lib.astc_phase_cycles(buf, 1)
            call(a, kw)
            torch.cuda.synchronize()
            lib.astc_phase_cycles(buf, 0)
        finally:
            _build._libs[name] = saved
        cyc = [int(c) for c in buf][:len(names[name])]
        tot = sum(cyc) or 1
        emit({"kernel": kern, "form": form, "tree": tree,
              "ms": chip_smoke._time_ms(lambda: call(a, kw), 5),
              "phases": dict(zip(names[name], cyc)),
              "shares": {k: round(c / tot, 4)
                         for k, c in zip(names[name], cyc)}})
    if args.out:
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
