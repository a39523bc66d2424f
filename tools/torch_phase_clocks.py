"""Cycle shares per phase of kernels K1 (mode search), K2 (1-plane
refinement), K3 (2-plane refinement) and K4 (partition line errors) of
astcenc_torch, and their registers, shared memory and spills, on one CUDA
card.

    python3 tools/torch_phase_clocks.py [--tree DIR] [--kernels K3,K4]
        [--against OLD] [--out FILE]

``--tree`` names a checkout of the repository (default: this one);
``--kernels`` picks some of K1-K4 (default: all four). Their sources
(``csrc/msearch.cu``, ``refine.cu``, ``refine2.cu``, ``psearch.cu``) are
built with nvcc and the package's flags plus ``-DASTC_PHASE_CLOCKS`` into
``build/phase/``. Each source marks its own phases
(``PHASE_START``/``PHASE_MARK`` of ``csrc/common.cuh``, the names on its
``// phases:`` lines); of a source without marks (an older tree's) the
tool reports the time and registers alone. At each mark the marking
threads (thread 0 of each CTA in K1, lane 0 of each warp in K2-K4) add the
``clock64()`` cycles since their previous mark to the phase's counter.
``--against`` names another checkout whose sources of the same kernels
(with the same C interface) are built too and run through this tree's
wrappers on the same inputs: the tool reports how many output values
differ from this tree's kernels, bit for bit.

The kernels' inputs are those a 512x512 main-path encode (seed 1, the
``chip_smoke.py`` capture) hands each form on its first call: K1 at 1
partition, 2 planes, 2 and 3 partitions; K2 at 1, 2 and 3 partitions; K3
(two planes); K4 at 2 and 3 partitions.
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


def _phases(src: str) -> list:
    """The phase names a kernel source declares on its "// phases:" lines
    (none if it marks no phases)."""
    m = re.search(r"// phases:((?:.*\n//  .*)*.*)", src)
    if "PHASE_MARK" not in src or m is None:
        return []
    return m.group(1).replace("//", " ").split()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=_HERE,
                    help="checkout whose kernels are measured")
    ap.add_argument("--kernels", default="K1,K2,K3,K4",
                    help="comma-separated kernels to measure")
    ap.add_argument("--against", help="checkout whose kernels' outputs are "
                    "compared bit for bit")
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
    sources = {"K1": "msearch", "K2": "refine", "K3": "refine2",
               "K4": "psearch"}
    want = [k.strip() for k in args.kernels.split(",")]
    libs, names = {}, {}
    for name in (sources[k] for k in want):
        path = os.path.join(_build.CSRC, name + ".cu")
        with open(path) as fh:
            names[name] = _phases(fh.read())
        if names[name]:
            so = os.path.join(out_dir, f"lib{name}_phase.so")
            r = subprocess.run([nvcc, *_build.NVCC_FLAGS,
                                "-DASTC_PHASE_CLOCKS", "-o", so, path],
                               capture_output=True, text=True)
            if r.returncode:
                raise SystemExit(f"nvcc failed for {name}:\n{r.stderr}")
            libs[name] = ctypes.CDLL(so)
            libs[name].astc_phase_cycles.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_int]
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                            os.path.join(out_dir, f"lib{name}_v.so"), path],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"nvcc -Xptxas -v failed for {name}:\n{r.stderr}")
        emit({"kernel": name, "ptxas": [
            ln.strip() for ln in r.stderr.splitlines()
            if "Used" in ln or "spill" in ln or "smem" in ln]})

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
    runs += [("refine2", "K3", "two",
              lambda a, kw: refine.trial2_refine_cuda(*a))]
    runs += [("psearch", "K4", f, lambda a, kw: psearch.line_errors_cuda(*a))
             for f in ("P2", "P3")]
    runs = [r for r in runs if r[1] in want]
    against = {}
    if args.against:
        for name in (sources[k] for k in want):
            so = os.path.join(out_dir, f"lib{name}_against.so")
            r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", so,
                                os.path.join(os.path.abspath(args.against),
                                             "astcenc_torch", "csrc",
                                             name + ".cu")],
                               capture_output=True, text=True)
            if r.returncode:
                raise SystemExit(f"nvcc failed for {name}:\n{r.stderr}")
            against[name] = ctypes.CDLL(so)

    def flat(x):
        if torch.is_tensor(x):
            return [x]
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in flat(x[k])]
        return [t for v in x for t in flat(v)]

    buf = (ctypes.c_ulonglong * 9)()
    for name, kern, form, call in runs:
        a, kw = seen[(kern, form)]
        rec = {"kernel": kern, "form": form, "tree": tree,
               "ms": chip_smoke._time_ms(lambda: call(a, kw), 5)}
        if name in against:
            mine = [t.clone() for t in flat(call(a, kw))]
            saved = _build._libs.get(name)
            _build._libs[name] = against[name]
            try:
                theirs = flat(call(a, kw))
            finally:
                _build._libs[name] = saved
            rec["against"] = os.path.abspath(args.against)
            rec["values_differing"] = sum(
                int((x.view(torch.int32) != y.view(torch.int32)).sum())
                if x.dtype == torch.float32 else int((x != y).sum())
                for x, y in zip(mine, theirs))
            rec["values"] = sum(x.numel() for x in mine)
        if name not in libs:
            emit(rec)
            continue
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
        emit({**rec, "phases": dict(zip(names[name], cyc)),
              "shares": {k: round(c / tot, 4)
                         for k, c in zip(names[name], cyc)}})
    if args.out:
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
