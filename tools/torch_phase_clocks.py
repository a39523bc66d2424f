"""Cycle shares per phase of kernels K1 (mode search), K2 (1-plane
refinement), K3 (2-plane refinement), K4 (partition line errors), K5 (one
1-plane HDR round) and K6 (one 2-plane HDR round) of astcenc_torch, and
their registers, shared memory, spills and occupancy, on one CUDA card.

    python3 tools/torch_phase_clocks.py [--tree DIR] [--kernels K5,K6]
        [--against OLD] [--out FILE]

``--tree`` names a checkout of the repository (default: this one);
``--kernels`` picks some of K1-K6 (default: all six). Their sources
(``csrc/msearch.cu``, ``refine.cu``, ``refine2.cu``, ``psearch.cu``,
``refine_round.cu``, ``refine_round2.cu``) are built with nvcc and the
package's flags into ``build/phase/``, once with ``-Xptxas -v`` (the
library that is timed) and once with ``-DASTC_PHASE_CLOCKS``. Each source
marks its own phases (``PHASE_START``/``PHASE_MARK`` of
``csrc/common.cuh``, the names on its ``// phases:`` lines); of a source
without marks (an older tree's) the tool reports the time, registers and
occupancy alone. At each mark the marking threads (thread 0 of each CTA in
K1, lane 0 of each warp in K2-K4 and K6, of each half-warp in K5) add the
``clock64()`` cycles since their previous mark to the phase's counter.
``--against`` names another checkout whose sources of the same kernels
(with the same C interface) are built too and run through this tree's
wrappers on the same inputs: the tool reports how many output values
differ from this tree's kernels, bit for bit.

The kernels' inputs are those an encode hands each form on its first call:
a 512x512 main-path encode (seed 1, the ``chip_smoke.py`` capture) for K1
at 1 partition, 2 planes, 2 and 3 partitions, K2 at 1, 2 and 3
partitions, K3 (two planes) and K4 at 2 and 3 partitions; a 512x512
synthetic float16 encode at 6x6 ``-medium -ch`` (seed 1, phase 7's
capture, ``chip_smoke._capture_hdr``) for K5's bootstrap (``boot``) and
its rounds at 1, 2 and 3 partitions and for K6 (``two``).
Each form runs through the checkout's own wrapper; the script prints one
JSON line per form and the ``-Xptxas -v`` lines of each kernel. A form's
line holds the milliseconds per call of the uninstrumented kernel's
wrapper over 20 calls (``ms``, CUDA events: where the wrapper's host time
exceeds the kernel's, this is the host's); the launch record the CUDA
profiler keeps for it through ``torch.profiler`` (``launch``: grid, block,
registers per thread, shared memory, blocks and warps per SM, the
estimated occupancy, and ``device_ms``, the kernel's mean device time over
another 20 calls); with marks, the phase names, cycles and shares of one
launch of the instrumented kernel. The instrumentation costs time, so its
cycle counts are shares, not kernel times.
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

_SOURCES = {"K1": "msearch", "K2": "refine", "K3": "refine2",
            "K4": "psearch", "K5": "refine_round", "K6": "refine_round2"}
# The kernel function of each form, as the profiler names it.
_FUNCS = {"K1": "msearch_kernel", "K2": "refine_kernel",
          "K3": "refine2_kernel", "K4": "psearch_kernel",
          "K5": "refine_round_kernel", "K6": "refine_round2_kernel"}
REPS = 20                  # timed calls per form
_LAUNCH_KEYS = ("grid", "block", "registers per thread", "shared memory",
                "blocks per SM", "warps per SM", "est. achieved occupancy %")


def _phases(src: str) -> list:
    """The phase names a kernel source declares on its "// phases:" lines
    (none if it marks no phases)."""
    m = re.search(r"// phases:((?:.*\n//  .*)*.*)", src)
    if "PHASE_MARK" not in src or m is None:
        return []
    return m.group(1).replace("//", " ").split()


def _nvcc(nvcc, flags, so, path):
    """Start one nvcc build of ``path`` into ``so``."""
    return subprocess.Popen([nvcc, *flags, "-o", so, path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _launch_record(torch, fn, func, path, reps):
    """The profiler's record of kernel ``func`` over ``reps`` calls of
    ``fn``: its last launch's grid, block, registers, shared memory and
    occupancy, and the mean device time of its launches (None if it keeps
    none, the error if it fails)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
    except RuntimeError as e:
        return {"error": str(e)[:200]}
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    os.remove(path)
    rec, durs = None, []
    for ev in events:
        if ev.get("cat") == "kernel" and re.search(
                r"\b" + func + r"\b", ev.get("name", "")):
            args = ev.get("args", {})
            rec = {k: args.get(k) for k in _LAUNCH_KEYS}
            durs.append(float(ev.get("dur", 0.0)))
    if rec is not None:
        rec["device_ms"] = sum(durs) / len(durs) / 1e3
        rec["launches"] = len(durs)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=_HERE,
                    help="checkout whose kernels are measured")
    ap.add_argument("--kernels", default="K1,K2,K3,K4,K5,K6",
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
    from astcenc_torch.ops import color_pack_hdr as cph
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
    want = [k.strip() for k in args.kernels.split(",")]
    names = {}
    procs = {}                 # (name, kind) -> (library path, nvcc)
    for name in (_SOURCES[k] for k in want):
        path = os.path.join(_build.CSRC, name + ".cu")
        with open(path) as fh:
            names[name] = _phases(fh.read())
        so = os.path.join(out_dir, f"lib{name}_v.so")
        procs[(name, "v")] = (so, _nvcc(
            nvcc, [*_build.NVCC_FLAGS, "-Xptxas", "-v"], so, path))
        if names[name]:
            so = os.path.join(out_dir, f"lib{name}_phase.so")
            procs[(name, "phase")] = (so, _nvcc(
                nvcc, [*_build.NVCC_FLAGS, "-DASTC_PHASE_CLOCKS"],
                so, path))
        if args.against:
            so = os.path.join(out_dir, f"lib{name}_against.so")
            procs[(name, "against")] = (so, _nvcc(
                nvcc, _build.NVCC_FLAGS, so,
                os.path.join(os.path.abspath(args.against), "astcenc_torch",
                             "csrc", name + ".cu")))
    _build.build()             # the package's own kernels, meanwhile
    libs = {"v": {}, "phase": {}, "against": {}}
    for (name, kind), (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc ({kind}) failed for {name}:\n{err}")
        libs[kind][name] = ctypes.CDLL(so)
        if kind == "v":
            emit({"kernel": name, "ptxas": [
                ln.strip() for ln in err.splitlines()
                if "Used" in ln or "spill" in ln or "smem" in ln]})
        if kind == "phase":
            libs[kind][name].astc_phase_cycles.argtypes = [ctypes.c_void_p,
                                                           ctypes.c_int]

    dev = torch.device("cuda", 0)
    seen = {}
    if any(k in want for k in ("K1", "K2", "K3", "K4")):
        ctx = api.context_alloc(api.config_init(
            api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0), device=dev)
        img = testdata.synthetic_image(chip_smoke.CAPTURE, chip_smoke.CAPTURE,
                                       1, independent_alpha=True)
        seen, restore = chip_smoke._capture((msearch, refine, psearch))
        try:
            api.compress_image(ctx, img)
        finally:
            restore()
    if any(k in want for k in ("K5", "K6")):
        ctx_h = api.context_alloc(api.config_init(
            api.Profile.HDR_RGB_LDR_A, 6, 6, 1, api.Quality.MEDIUM, 0),
            device=dev)
        seen_h, restore = chip_smoke._capture_hdr(refine, cph)
        try:
            api.compress_image(ctx_h, testdata.synthetic_hdr_image(
                chip_smoke.CAPTURE, chip_smoke.CAPTURE, 1,
                independent_alpha=True))
        finally:
            restore()
        seen.update({k: (a, {}) for k, a in seen_h.items()})
    torch.cuda.synchronize()

    runs = [("msearch", "K1", f, lambda a, kw: msearch.mode_search_cuda(*a, **kw))
            for f in ("pc1", "two", "pc2", "pc3")]
    runs += [("refine", "K2", f, lambda a, kw: refine.trial1_refine_cuda(*a))
             for f in ("pc1", "pc2", "pc3")]
    runs += [("refine2", "K3", "two",
              lambda a, kw: refine.trial2_refine_cuda(*a))]
    runs += [("psearch", "K4", f, lambda a, kw: psearch.line_errors_cuda(*a))
             for f in ("P2", "P3")]
    runs += [("refine_round", "K5", f,
              lambda a, kw: refine.refine_round_1plane_cuda(*a))
             for f in ("boot", "pc1", "pc2", "pc3")]
    runs += [("refine_round2", "K6", "two",
              lambda a, kw: refine.refine_round_2plane_cuda(*a))]
    runs = [r for r in runs if r[1] in want]

    def flat(x):
        if torch.is_tensor(x):
            return [x]
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in flat(x[k])]
        return [t for v in x for t in flat(v)]

    def using(name, lib, fn):
        """fn() with ``lib`` as the package's library ``name``."""
        saved = _build._libs.get(name)
        _build._libs[name] = lib
        try:
            return fn()
        finally:
            _build._libs[name] = saved

    trace = os.path.join(out_dir, "launch_trace.json")
    buf = (ctypes.c_ulonglong * 9)()
    for name, kern, form, call in runs:
        a, kw = seen[(kern, form)]
        lib = libs["v"][name]
        rec = {"kernel": kern, "form": form, "tree": tree,
               "ms": using(name, lib, lambda: chip_smoke._time_ms(
                   lambda: call(a, kw), REPS)),
               "launch": using(name, lib, lambda: _launch_record(
                   torch, lambda: call(a, kw), _FUNCS[kern], trace,
                   REPS))}
        if name in libs["against"]:
            mine = [t.clone() for t in flat(using(name, lib,
                                                  lambda: call(a, kw)))]
            theirs = flat(using(name, libs["against"][name],
                                lambda: call(a, kw)))
            rec["against"] = os.path.abspath(args.against)
            rec["values_differing"] = sum(
                int((x.view(torch.int32) != y.view(torch.int32)).sum())
                if x.dtype == torch.float32 else int((x != y).sum())
                for x, y in zip(mine, theirs))
            rec["values"] = sum(x.numel() for x in mine)
        if name not in libs["phase"]:
            emit(rec)
            continue
        plib = libs["phase"][name]

        def clocked():
            call(a, kw)                         # warm-up
            torch.cuda.synchronize()
            plib.astc_phase_cycles(buf, 1)
            call(a, kw)
            torch.cuda.synchronize()
            plib.astc_phase_cycles(buf, 0)

        using(name, plib, clocked)
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
