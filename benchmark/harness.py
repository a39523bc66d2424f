"""Runs one cell of ``BENCHMARK.json`` once.

Everything a cell is made of is found by name: the configuration's file
(``configs/<config>.json``, named in ``BENCHMARK.json``), the traffic mix
(``traffic/<traffic>.json``), the limits of its correctness check
(``limits/<cell>.json``) and one reader per metric (``metrics/<metric>.py``).

A run, in one process: the port's kernels are built (or found built) under
the checkout's ``build/``; the traffic file's texture set is made; each
client gets a context and a CUDA stream of its own and runs in a thread of
its own; client 0 warms up on its first texture (the port's lazy set-up,
its tables and kernel libraries, runs then: every client shares them, and
nothing compiles later); then the window: each client encodes the set's
textures back to back in the seed's order from its own offset (a closed
loop) until the window closes, and finishes the encode in flight.
With ``--trace 1`` the clients then encode a few more textures each under
the profiler (the stretch). Then the peak memory is read, the program's
state is freed, and the reference judges every answer.

The cells run one client (``clients`` in the traffic file): one process
uses the card, and clients beyond the first are threads of it, which
hand one interpreter lock back and forth.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import threading
import time
import traceback
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Seconds past the window's close that a client's last encode may take
#: before it counts as never come.
LATE_S = 60.0


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``bench``, with its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = os.path.join(root, "benchmark")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"],
        config=_json(os.path.join(root, cfg["file"])),
        traffic=_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )


def metric_module(name: str, root: str = ROOT):
    """The reader of metric ``name``: ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Span:
    """One encode: its client, texture, host-clock start and end, the
    texels it encodes (``work``) and the phase it ran in."""
    client: int
    texture: int
    start: float
    end: float
    work: int
    phase: str
    ok: bool = True
    blocks: object = None


def port_config(api, config: dict):
    """The port's ASTCConfig for a configuration file."""
    flags = 0
    for f in config.get("flags", []):
        flags |= int(getattr(api.Flags, f))
    bx, by, bz = (list(config["block"]) + [1])[:3]
    return api.config_init(getattr(api.Profile, config["profile"]), bx, by,
                           bz, getattr(api.Quality, config["preset"].upper()),
                           flags)


class _Clients:
    """The client threads, and the barriers at which they and the main
    thread meet between phases: client 0's warm-up (the window opens), the
    window's close, and the stretch's start and end."""

    def __init__(self, api, ctxs, streams, textures, order, phases):
        self.api, self.ctxs, self.streams = api, ctxs, streams
        self.textures, self.order = textures, order
        self.n = len(ctxs)
        self.warmup, self.stretch = phases["warmup"], phases["stretch"]
        self.window_s = phases["seconds"]
        self.min_encodes = phases.get("min_encodes", 0)
        self.t0 = self.deadline = None
        self.spans = [[] for _ in range(self.n)]
        self.errors = []
        parties = self.n + 1
        self.opened = threading.Barrier(parties, action=self._open)
        self.closed = threading.Barrier(parties)
        self.traced = threading.Barrier(parties)
        self.untraced = threading.Barrier(parties)

    def _open(self):
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.window_s

    def _encode(self, c: int, k: int, phase: str) -> None:
        i = self.order[c][k % len(self.order[c])]
        img = self.textures[i]
        t = time.perf_counter()
        try:
            blocks = self.api.compress_image(self.ctxs[c], img)
            ok = True
        except Exception:
            self.errors.append(traceback.format_exc())
            blocks, ok = None, False
        e = time.perf_counter()
        if phase != "warmup":
            self.spans[c].append(Span(c, i, t, e, img.shape[0] * img.shape[1],
                                      phase, ok, blocks))

    def _main(self, c: int) -> None:
        import torch
        stream = self.streams[c]
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                if c == 0:
                    for k in range(self.warmup):
                        self._encode(c, k, "warmup")
                self.opened.wait()
                k = 0
                while (time.perf_counter() < self.deadline
                       or k < self.min_encodes):
                    self._encode(c, k, "window")
                    k += 1
                self.closed.wait()
                if self.stretch:
                    self.traced.wait()
                    for _ in range(self.stretch):
                        self._encode(c, k, "stretch")
                        k += 1
                    self.untraced.wait()
        except threading.BrokenBarrierError:
            pass
        except Exception:
            self.errors.append(traceback.format_exc())
            for b in (self.opened, self.closed, self.traced, self.untraced):
                b.abort()

    def start(self) -> None:
        self.threads = [threading.Thread(target=self._main, args=(c,),
                                         name=f"client{c}", daemon=True)
                        for c in range(self.n)]
        for t in self.threads:
            t.start()


def _meet(barrier, timeout=None) -> bool:
    """The main thread's side of a barrier: False if it broke or timed out
    (a client failed or hangs)."""
    try:
        barrier.wait(timeout=timeout)
        return True
    except threading.BrokenBarrierError:
        return False


def _port():
    """The port's modules that the harness drives and probes."""
    from astcenc_torch import api
    from astcenc_torch.ops import _build, msearch
    return types.SimpleNamespace(api=api, build=_build, msearch=msearch,
                                 csrc=_build.CSRC)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_origin: float | None = None,
             program_config: dict | None = None, min_encodes: int = 0,
             log=None) -> dict:
    """Run ``cell`` once and return its result line (a dict). The program
    runs ``program_config`` where one is given (a control), the
    configuration's own otherwise; the reference always judges by the
    configuration's. ``min_encodes`` keeps each client encoding past the
    window's close until it has done that many (the readings of
    ``readings.py``, which need every texture of the set answered)."""
    import torch

    from . import texgen, trace as trace_mod
    from .reference import check

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_origin = time.perf_counter() if t_origin is None else t_origin
    traffic = cell.traffic
    if traffic.get("loop", "closed") != "closed":
        raise ValueError(f"{cell.name}: only a closed loop is implemented")
    clients = int(traffic["clients"])
    cores = len(os.sched_getaffinity(0))
    torch.set_num_threads(max(1, cores // clients))
    log(f"cell {cell.name}: seed {seed}, {seconds} s window, trace "
        f"{int(trace)}; {clients} clients; cores {cores}, "
        f"{torch.get_num_threads()} CPU threads for PyTorch")

    marks = [("imports", time.perf_counter())]
    port = _port()
    api = port.api
    on_card = torch.device(device).type == "cuda"
    if on_card:
        port.build.build()
        for name in port.build.KERNELS:
            port.build.load(name)
    marks.append(("port and kernels", time.perf_counter()))

    textures = texgen.make_set(traffic, threads=4)
    marks.append(("textures", time.perf_counter()))
    n = len(textures)
    cfg = port_config(api, program_config or cell.config)
    ctxs = [api.context_alloc(cfg, device=device) for _ in range(clients)]
    streams = ([torch.cuda.Stream(device=device) for _ in range(clients)]
               if on_card else [None] * clients)
    order = texgen.encode_order(n, clients, seed)
    stretch_n = int(traffic.get("stretch_per_client", 1)) if trace else 0
    cl = _Clients(api, ctxs, streams, textures, order,
                  {"warmup": int(traffic.get("warmup_encodes", 1)),
                   "stretch": stretch_n, "seconds": float(seconds),
                   "min_encodes": int(min_encodes)})
    marks.append(("contexts", time.perf_counter()))
    cl.start()
    if not _meet(cl.opened):
        raise RuntimeError("a client failed in its warm-up:\n"
                           + "\n".join(cl.errors))
    marks.append(("warm-up", cl.t0))
    setup_s = cl.t0 - t_origin
    prev = t_origin
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    log("set-up s: " + ", ".join(parts))
    window_done = _meet(cl.closed, timeout=None if min_encodes
                        else seconds + LATE_S)
    t1 = cl.deadline

    tr = None
    probes = {}
    if stretch_n and window_done:
        symbols = trace_mod.kernel_symbols(port.csrc)
        readers = {m["name"]: metric_module(m["name"]) for m in cell.per_layer}
        for name, mod in readers.items():
            if hasattr(mod, "probe"):
                probes[name] = mod.probe(port)
        stretch = trace_mod.Stretch(symbols)
        if on_card:
            torch.cuda.synchronize()
        stretch.start()
        for p in probes.values():
            p.start()
        _meet(cl.traced)
        _meet(cl.untraced, timeout=LATE_S * 4)
        for p in probes.values():
            p.stop()
        texels = sum(s.work for sp in cl.spans for s in sp
                     if s.phase == "stretch")
        tr = stretch.stop(texels)
    for t in cl.threads:
        t.join(timeout=LATE_S)
    hung = sum(t.is_alive() for t in cl.threads)
    for msg in cl.errors:
        log(msg.rstrip())

    peak = (torch.cuda.max_memory_allocated(device) if on_card else 0)
    device_name = (torch.cuda.get_device_name(torch.device(device))
                   if on_card else "cpu")
    spans = [s for sp in cl.spans for s in sp]
    del ctxs, streams, cl.ctxs, cl.streams
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    readings, quality = _judge(cell, textures, spans, hung, device, check)
    correct, checks = check.judge(readings, cell.limits)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s for "
        f"{readings['answers']} answers ({readings['distinct']} distinct)")

    run = types.SimpleNamespace(
        cell=cell, seed=seed, seconds=float(seconds), window=(cl.t0, t1),
        spans=spans, setup_s=setup_s, quality=quality, trace=tr,
        probes=probes, peak_bytes=peak, device_name=device_name,
        window_spans=[s for s in spans if s.phase == "window" and s.ok])
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(spans) + hung
    failed = sum(1 for s in spans if not s.ok) + hung
    log(f"window: {len(run.window_spans)} encodes completed in {seconds} s by "
        f"{clients} clients; {attempted} attempted, {failed} failed; "
        f"set-up {setup_s:.3f} s; peak {peak} bytes")
    dev = {"platform": "gpu" if on_card else "cpu", "kind": device_name,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and failed == 0),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None and tr.active is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
        result["breakdown"] = {"device_ops": tr.device_ops_by_time(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def _judge(cell, textures, spans, hung, device, check):
    """The reference's readings over every answer, and each texture's
    quality from its first answer."""
    ref = check.Reference(cell.config, device)
    answers = {}
    for s in spans:
        if s.ok:
            answers.setdefault(s.texture, []).append(s.blocks)
    readings = {"failed_encodes": float(sum(not s.ok for s in spans) + hung),
                "missing_textures": float(len(textures) - len(answers)),
                "illegal_blocks": 0.0, "differing_encodes": 0.0,
                "texture_err_ratio": 0.0, "block_err_ratio": 0.0,
                "answers": sum(len(v) for v in answers.values()),
                "distinct": 0}
    quality = {}
    for i, blocks in sorted(answers.items()):
        groups = {}
        for b in blocks:
            key = hashlib.blake2b(np.ascontiguousarray(b).tobytes(),
                                  digest_size=16).digest()
            groups.setdefault(key, [b, 0])[1] += 1
        first = next(iter(groups))
        readings["differing_encodes"] += len(blocks) - groups[first][1]
        readings["distinct"] += len(groups)
        h, w = textures[i].shape[:2]
        src = ref.source(textures[i])
        for key, (b, count) in groups.items():
            img, illegal = ref.decode(b, h, w)
            e = ref.errors(src, img)
            readings["illegal_blocks"] += illegal * count
            for k in ("texture_err_ratio", "block_err_ratio"):
                readings[k] = max(readings[k], e[k])
            if key == first:
                quality[i] = e
        del src
    return readings, quality
