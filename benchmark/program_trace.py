"""The program's own spans and counters over the traced stretch.

The port records spans and counters of its encodes when its tracing is on
(``astcenc_torch.obs``: off by default; ``enable()``, ``collect()``,
``disable()``). Every metric that reads them makes a ``Probe`` (its
reader's ``probe``); the probes share one recording. The first ``start()``
clears the program's buffers and switches its tracing on, the last
``stop()`` collects them and switches it off: so the tracing is on once,
between the harness's probes' start and stop, inside the profiled
stretch, and never in a run without ``--trace 1``. A program without the
facility records nothing: its probes do nothing and the readers read None.

Span times are nanoseconds on the Unix epoch, the clock of the profiler's
events (``trace.TraceData``), so the two line up.
"""

from __future__ import annotations

import importlib

from . import stats

#: The spans of host preparation: the card waits while the host makes the
#: blocks of an image, copies a chunk each way, or joins the answer.
PREP = ("image_to_blocks", "h2d", "d2h", "assemble")


class _Recording:
    def __init__(self):
        self.users = 0
        self.obs = None
        self.trace = None


_recording = _Recording()


def _program_obs():
    """The program's tracing module, or None where it has none."""
    try:
        return importlib.import_module("astcenc_torch.obs")
    except ImportError:
        return None


class Probe:
    """One metric's share of the recording."""

    def __init__(self):
        self.rec = _recording

    def start(self) -> None:
        rec = self.rec
        if rec.users == 0:
            rec.trace = None
            rec.obs = _program_obs()
            if rec.obs is not None:
                rec.obs.collect()
                rec.obs.enable()
        rec.users += 1

    def stop(self) -> None:
        rec = self.rec
        rec.users -= 1
        if rec.users == 0 and rec.obs is not None:
            rec.trace = rec.obs.collect()
            rec.obs.disable()

    @property
    def trace(self):
        """What the program recorded (``obs.Trace``: ``spans``,
        ``counters``), or None."""
        return self.rec.trace


def recorded(run, metric: str):
    """The program's recording as the probe of ``metric`` saw it, or None
    where there is no probe, no stretch or nothing recorded."""
    p = run.probes.get(metric)
    if p is None or run.trace is None or not run.trace.texels:
        return None
    return p.trace


def counter_sum(counters: dict, prefix: str, parts: int | None = None) -> int:
    """The sum of the counters whose names start with ``prefix``; with
    ``parts``, of those with that many dotted parts alone."""
    return sum(v for k, v in counters.items() if k.startswith(prefix)
               and (parts is None or k.count(".") == parts - 1))


def intervals(trace, names) -> list:
    """(start, end) of the recorded spans whose name is in ``names``."""
    return [(s.start, s.end) for s in trace.spans if s.name in names]


def measure(a, b) -> int:
    """Length of the intersection of two sets of intervals."""
    a, b = stats.union(a), stats.union(b)
    i = j = tot = 0
    while i < len(a) and j < len(b):
        tot += stats.overlap(a[i][0], a[i][1], b[j][0], b[j][1])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_by_class(run, metric: str):
    """(prep, dispatch, active) nanoseconds of the stretch: the card's idle
    time (the gaps ``device_idle_pct`` sums) while a client's thread is in
    a preparation span (``PREP``), while it is in ``compress_image`` but in
    no preparation span, and the active part's length. Each idle
    nanosecond counts once, preparation first. None without a device
    trace or a recording."""
    tr = run.trace
    rec = recorded(run, metric)
    if rec is None or tr.active is None:
        return None
    t0, t1 = tr.active
    gaps = stats.gaps(tr.intervals(), t0, t1)
    prep = intervals(rec, PREP)
    calls = intervals(rec, ("compress_image",))
    in_prep = measure(gaps, prep)
    return in_prep, measure(gaps, calls + prep) - in_prep, t1 - t0
