"""The profiled stretch of a traced run, reduced to what the per-layer
metrics read.

``torch.profiler`` records the stretch: every kernel, copy and fill that
ran on the card (from CUPTI, whichever thread launched it) and the host's
side of it (CUDA runtime calls, and ATen operators of every thread where
this PyTorch can record them). The events are reduced once, here, to
intervals on one clock; the readers in ``metrics/`` take them from there.
"""

from __future__ import annotations

import glob
import os
import re

import torch

from . import stats

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*[(<]")


def kernel_symbols(csrc: str) -> dict:
    """{kernel symbol: source file stem} of every ``__global__`` function
    defined in the port's CUDA sources."""
    out = {}
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu"))
                       + glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(path) as fh:
            for sym in _GLOBAL.findall(fh.read()):
                out[sym] = os.path.splitext(os.path.basename(path))[0]
    return out


def base_name(name: str) -> str:
    """A demangled kernel name without its return type, namespaces,
    template and argument list: ``void (anonymous namespace)::k<2>((anonymous
    namespace)::Args)`` -> ``k``."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[(<\s]", name, maxsplit=1)[0].split("::")[-1]


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig
        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        cfg = None
    if cfg is None:
        return profile(activities=acts)
    return profile(activities=acts, experimental_config=cfg)


class TraceData:
    """One profiled stretch.

    ``device``: (start_ns, end_ns, name, stream) of every device operation;
    ``host``: (start_ns, end_ns, name) of every host event; ``active``: the
    part of the stretch in which every client was encoding (from the first
    device operation of any client's stream to the last one of the client
    that finished first), over which the idle share is taken; ``texels``:
    the texels the stretch's encodes completed.
    """

    def __init__(self, device_ops, host_ops, texels: int, symbols: dict):
        self.device = device_ops
        self.host = host_ops
        self.texels = texels
        self.symbols = symbols
        streams = {}
        for s, e, _, st in device_ops:
            lo, hi = streams.get(st, (s, e))
            streams[st] = (min(lo, s), max(hi, e))
        if streams:
            t0 = min(lo for lo, _ in streams.values())
            t1 = min(hi for _, hi in streams.values())
            self.active = (t0, max(t0, t1))
        else:
            self.active = None

    @property
    def mtexels(self) -> float:
        return self.texels / 1e6

    def is_port_kernel(self, name: str) -> bool:
        return base_name(name) in self.symbols

    def source_of(self, name: str) -> str | None:
        return self.symbols.get(base_name(name))

    def intervals(self):
        return [(s, e) for s, e, _, _ in self.device]

    def busy_s(self) -> float:
        t0, t1 = self.active
        return stats.busy(self.intervals(), t0, t1) / 1e9

    def window_s(self) -> float:
        t0, t1 = self.active
        return (t1 - t0) / 1e9

    def device_ops_by_time(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        tot = {}
        for s, e, name, _ in self.device:
            key = name[:96]
            tot[key] = tot.get(key, 0.0) + (e - s) / 1e9
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """[name, seconds] of the longest stretches of the active part in
        which no device operation ran, each named by the host event that
        overlaps it most (a CUDA runtime call, or an operator), or "host"
        where the trace holds none."""
        t0, t1 = self.active
        gaps = sorted(stats.gaps(self.intervals(), t0, t1),
                      key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host)
        out = []
        for g0, g1 in gaps:
            best, name = 0, "host"
            for s, e, n in host:
                if s >= g1:
                    break
                ov = stats.overlap(s, e, g0, g1)
                if ov > best:
                    best, name = ov, n
            out.append([name[:96], (g1 - g0) / 1e9])
        return out


class Stretch:
    """Starts and stops the profiler around a stretch and reduces it."""

    def __init__(self, symbols: dict):
        self.symbols = symbols
        self.prof = None

    def start(self) -> None:
        self.prof = _profiler()
        self.prof.start()

    def stop(self, texels: int) -> TraceData:
        from torch.autograd import DeviceType
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        device_ops, host_ops = [], []
        for ev in events:
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                device_ops.append((s, e, ev.name(), ev.device_resource_id()))
            elif ev.duration_ns() > 0:
                host_ops.append((s, e, ev.name()))
        self.prof = None
        return TraceData(device_ops, host_ops, texels, self.symbols)
