"""Where an encode of a benchmark cell waits on the card, and whether the
program's tracing (``astcenc_torch.obs``) sees every wait.

    python3 tools/torch_sync_audit.py [--workload CELL ...] [--rounds N]
        [--out DIR]

On a CUDA card. For each cell of ``BENCHMARK.json`` named (default: every
cell) it makes the cell's texture set (``benchmark/texgen.py``), warms up
on the first texture on a stream of its own, as the harness's client does,
and then:

1. ``sites``: encodes that texture under
   ``torch.cuda.set_sync_debug_mode("warn")`` and counts every call that
   synchronises by the innermost frame in ``astcenc_torch``;
2. ``audit``: encodes the cell's stretch (``stretch_per_client`` textures)
   under ``torch.profiler`` with the program's tracing on, and holds the
   spans against the trace: the CUDA runtime's stream and device
   synchronisations inside the encodes against the ``sync`` counters (each
   one outside a ``sync`` span named by the ATen operator around it, each
   ``sync`` span with none inside by its site), each ``h2d`` and ``d2h``
   span against the ``cudaMemcpyAsync`` inside it, and per span class
   (preparation, stages, the rest of ``compress_image``) the host time,
   waits, copies, launches and the card's idle time per image;
3. ``same``: every texture of the set encoded with the tracing off and on,
   the blocks compared;
4. ``cost``: the set encoded ``--rounds`` times, tracing off and on in
   turns, the mean image time of each.

Prints one JSON line per cell and part, and writes the audit's details to
``--out`` (default ``build/sync_audit``).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx")
PREP = ("image_to_blocks", "h2d", "d2h", "assemble")
STAGES = ("stage1", "stage2a", "stage2b", "finalize")


def union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a, b):
    """The intersection of two unions of intervals, as sorted disjoint
    intervals."""
    a, b = union(a), union(b)
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def common(a, b) -> int:
    """Length of the intersection of two unions of intervals."""
    return sum(e - s for s, e in intersect(a, b))


def minus(a, b):
    """The union ``a`` without the union ``b``."""
    a = union(a)
    if not a:
        return []
    lo, hi = a[0][0], a[-1][1]
    return intersect(a, [(s, e) for s, e in
                         zip([lo] + [e for _, e in union(b)],
                             [s for s, _ in union(b)] + [hi]) if e > s])


def inside(t, iv) -> bool:
    """Whether ``t`` lies in the union of ``iv`` (sorted disjoint
    intervals, as ``union`` gives them)."""
    k = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return k >= 0 and iv[k][0] <= t <= iv[k][1]


def enclosing(t, ops) -> str:
    """The name of the shortest of ``ops`` ((start, end, name) by start)
    that holds ``t``, looking back over at most 5000 of them."""
    k = bisect.bisect_right(ops, (t, float("inf"), ""))
    best = None
    for s, e, n in reversed(ops[max(0, k - 5000):k]):
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return best[2] if best else "none"


def sync_sites(encode) -> dict:
    """Synchronising calls of ``encode()`` by the innermost frame in the
    port (PyTorch's sync debug mode)."""
    import torch
    sites = {}
    pkg = os.sep + "astcenc_torch" + os.sep

    def hook(message, category, filename, lineno, file=None, line=None):
        key = f"{filename}:{lineno}"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if pkg in fr.filename and not fr.filename.endswith("obs.py"):
                key = (f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno} "
                       f"{fr.name}")
                break
        sites[key] = sites.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            encode()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def audit(encode_all, n_images: int, symbols: dict) -> tuple:
    """Profile ``encode_all()`` with the program's tracing on; returns
    (summary, details)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from astcenc_torch import obs
    from benchmark import trace as bt

    obs.collect()
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        encode_all()
    obs.disable()
    got = obs.collect()
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        rec = (s, s + ev.duration_ns(), ev.name(), ev.correlation_id(),
               ev.start_thread_id())
        (dev if ev.device_type() == DeviceType.CUDA else host).append(rec)
    spans = got.spans
    by = {}
    for sp in spans:
        by.setdefault(sp.name, []).append(sp)
    calls = union((s.start, s.end) for s in by.get("compress_image", []))
    sync_iv = union((s.start, s.end) for s in by.get("sync", []))
    rt_sync = [h for h in host if h[2] in SYNCS and inside(h[0], calls)]
    threads = {}
    for h in rt_sync:
        threads[h[4]] = threads.get(h[4], 0) + 1
    aten = sorted(h[:3] for h in host if h[2].startswith("aten::"))
    unmatched = {}
    for h in rt_sync:
        if not inside(h[0], sync_iv):
            op = enclosing(h[0], aten)
            unmatched[op] = unmatched.get(op, 0) + 1
    empty = {}
    for sp in by.get("sync", []):
        if not any(sp.start <= h[0] <= sp.end for h in rt_sync):
            site = sp.attrs["site"]
            empty[site] = empty.get(site, 0) + 1
    memcpy = [h for h in host if h[2] == "cudaMemcpyAsync"]
    copies = {}
    for way in ("h2d", "d2h"):
        ok = slack = 0
        worst = None
        for sp in by.get(way, []):
            m = [h for h in memcpy if sp.start <= h[0] and h[1] <= sp.end]
            ok += bool(m)
            for h in m:
                slack = min(h[0] - sp.start, sp.end - h[1])
                worst = slack if worst is None else min(worst, slack)
        copies[way] = {"spans": len(by.get(way, [])), "containing": ok,
                       "least_slack_us": None if worst is None
                       else worst / 1e3}
    # The card's idle time inside the stretch, by span class.
    port = {h[3] for h in dev if bt.base_name(h[2]) in symbols}
    launches = [h for h in host if h[2] in LAUNCHES]
    dev_iv = [(d[0], d[1]) for d in dev] or calls
    t0, t1 = min(s for s, _ in dev_iv), max(e for _, e in dev_iv)
    idle = minus([(t0, t1)], dev_iv)
    classes = {n: [(s.start, s.end) for s in by.get(n, [])]
               for n in PREP + STAGES}
    for pc in (2, 3, 4):
        iv = [(s.start, s.end) for s in by.get("stage2b", [])
              if s.attrs.get("pc") == pc]
        if iv:
            classes[f"stage2b.pc{pc}"] = iv
    classes.pop("stage2b", None)
    named = [iv for v in classes.values() for iv in v]
    classes["other"] = minus(calls, named)
    syncs = by.get("sync", [])
    rows = {}
    for name, iv in classes.items():
        iv = union(iv)
        w = [s for s in syncs if inside(s.start, iv)]
        rows[name] = {
            "host_ms": sum(e - s for s, e in union(iv)) / 1e6 / n_images,
            "syncs": len(w) / n_images,
            "sync_ms": sum(s.end - s.start for s in w) / 1e6 / n_images,
            "h2d_bytes": sum(s.attrs.get("bytes", 0) for s in w
                             if s.attrs.get("copy") == "h2d") / n_images,
            "d2h_bytes": sum(s.attrs.get("bytes", 0) for s in w
                             if s.attrs.get("copy") == "d2h") / n_images,
            "launches": sum(inside(h[0], iv) for h in launches) / n_images,
            "port_launches": sum(inside(h[0], iv) and h[3] in port
                                 for h in launches) / n_images,
            "idle_ms": common(idle, iv) / 1e6 / n_images,
            "idle_in_sync_ms": common(intersect(idle, iv),
                                      [(s.start, s.end) for s in w])
            / 1e6 / n_images,
        }
    win = t1 - t0
    prep = union(iv for n in PREP for iv in classes[n])
    c = got.counters
    summary = {
        "images": n_images,
        "runtime_syncs_in_encodes": len(rt_sync),
        "runtime_syncs_by_thread": threads,
        "sync_counters": sum(v for k, v in c.items()
                             if k.startswith("sync.")),
        "unmatched_runtime_syncs_by_op": unmatched,
        "sync_spans_without_runtime_sync": empty,
        "copies": copies,
        "device_idle_pct": 100.0 * sum(e - s for s, e in idle) / win,
        "idle_prep_pct": 100.0 * common(idle, prep) / win,
        "idle_dispatch_pct": 100.0 * common(idle, minus(calls, prep)) / win,
        "counters": dict(sorted(c.items())),
        "by_class": rows,
    }
    return summary, {"spans": len(spans), "device_ops": len(dev)}


def run_cell(name: str, rounds: int, out: str, device: str = "cuda",
             size=None) -> None:
    import numpy as np
    import torch

    from astcenc_torch import api, obs
    from astcenc_torch.ops import _build
    from benchmark import harness, texgen
    from benchmark import trace as bt

    cell = harness.find_cell(harness.load_benchmark(ROOT), name, ROOT)
    traffic = dict(cell.traffic, sizes=[size]) if size else cell.traffic
    textures = texgen.make_set(traffic, threads=4)
    ctx = api.context_alloc(harness.port_config(api, cell.config),
                            device=device)
    on_card = device == "cuda"
    stream = torch.cuda.Stream() if on_card else None
    n_stretch = int(cell.traffic.get("stretch_per_client", 1))
    symbols = bt.kernel_symbols(_build.CSRC)

    def enc(img):
        if not on_card:
            return api.compress_image(ctx, img)
        with torch.cuda.stream(stream):
            return api.compress_image(ctx, img)

    enc(textures[0])

    def emit(part, value):
        print(json.dumps({"cell": name, part: value}), flush=True)

    if on_card:
        emit("sites", sync_sites(lambda: enc(textures[0])))
    summary, details = audit(
        lambda: [enc(t) for t in textures[:n_stretch]], n_stretch, symbols)
    emit("audit", summary)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, name + ".json"), "w") as fh:
        json.dump({"audit": summary, "details": details}, fh, indent=1)

    differ = []
    for i, t in enumerate(textures):
        off = enc(t)
        obs.enable()
        on = enc(t)
        obs.disable()
        obs.collect()
        if not np.array_equal(off, on):
            differ.append(i)
    emit("same", {"textures": len(textures), "differing": differ})

    times = {"off": [], "on": []}
    for r in range(rounds):
        for i, t in enumerate(textures):
            order = ("off", "on") if (r + i) % 2 == 0 else ("on", "off")
            for mode in order:
                if mode == "on":
                    obs.enable()
                t0 = time.perf_counter()
                enc(t)
                times[mode].append(time.perf_counter() - t0)
                obs.disable()
                obs.collect()
    mean = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
    pairs = [a / b for a, b in zip(times["on"], times["off"])]
    emit("cost", {"encodes_each": len(times["on"]),
                  "mean_ms_off": mean["off"], "mean_ms_on": mean["on"],
                  "on_over_off_pct": 100.0 * (mean["on"] / mean["off"] - 1),
                  "pair_median_pct": 100.0 * (statistics.median(pairs) - 1),
                  "pair_quartiles_pct": [100.0 * (q - 1) for q in
                                         statistics.quantiles(pairs, n=4)]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "sync_audit"))
    ap.add_argument("--cpu-size", type=int, default=0,
                    help="rehearse on the CPU with textures of this side "
                    "(no sites: the CPU has nothing to wait for)")
    args = ap.parse_args(argv)
    import torch
    from astcenc_torch.ops import _build
    from benchmark import harness
    if args.cpu_size:
        device, size = "cpu", [args.cpu_size, args.cpu_size]
    elif torch.cuda.is_available():
        device, size = "cuda", None
        _build.build()
        for k in _build.KERNELS:
            _build.load(k)
    else:
        print("torch_sync_audit: no CUDA device", file=sys.stderr)
        return 1
    names = args.workload or [w["name"] for w in
                              harness.load_benchmark(ROOT)["workloads"]]
    for name in names:
        run_cell(name, args.rounds, args.out, device, size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
