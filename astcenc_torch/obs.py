"""Spans and counters of an encode, for the benchmark and the operator.

Off by default. ``enable()`` turns it on, ``disable()`` off, and
``collect()`` returns and clears what every thread recorded. Nothing is
written anywhere: the caller reads ``collect()``.

A span is a stretch of host time: its name, start and end, the thread,
its id, the id of the span it lies in, the id of the ``compress_image``
call it belongs to, and a few attributes. Times are integer nanoseconds
on the Unix epoch (``time.time_ns()``), the clock ``torch.profiler``'s
events carry, so spans and a profiler trace of the same run line up. A
counter is a name and a number, summed over the threads.

Each instrumented site reads ``obs.on`` and does nothing more while it is
False: no object is built and nothing is allocated. A span is begun and
ended by two calls, never by a context manager::

    sp = obs.on and obs.begin("stage1", blocks=n)
    ...
    if sp:
        obs.end(sp)

Each thread records into a buffer of its own, registered once under a
lock, so threads that encode side by side share nothing while they run.
What ``collect()`` takes while encodes run may miss an update in flight.

Spans (layer in brackets): ``compress_image`` (api: texels, blocks,
chunks), ``image_to_blocks`` and ``assemble`` (api, host preparation),
``chunk`` (codec glue: first, blocks), ``h2d`` and ``d2h`` (the chunk's
copies: bytes), ``stage1``, ``stage2a``, ``stage2b`` (pc), ``finalize``
(codec glue: blocks entering), and ``sync`` (site): a point where the
host waits on the device, a ``nonzero``, a scalar read or a blocking copy.
Counters: ``sync.<site>`` per wait; ``launch.<kernel>`` per launch of one
of the port's CUDA kernels and ``launch.<kernel>.<form>`` for the forms
``asr``, ``rgbm`` and ``asr+rgbm``; ``blocks.stage1``, ``blocks.const``,
``blocks.stage2a``, ``blocks.stage2b.pc<p>``;
``psearch.partitionings.pc<p>``, the block-partitionings whose line errors
are scored at partition count ``p`` (N x S of each
``ops/psearch.py::line_errors`` call, from host shapes, kernel or plain
version alike); ``copy.h2d.bytes``, ``copy.h2d.count``,
``copy.d2h.bytes``, ``copy.d2h.count``.
"""

from __future__ import annotations

import itertools
import threading
import time

#: Whether spans and counters are recorded; read at every site.
on = False

_lock = threading.Lock()
_buffers = []
_local = threading.local()
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)


class Span:
    """One span. ``end`` is None until it ends; ``parent`` and ``call`` are
    None outside any span and any ``compress_image`` call."""

    __slots__ = ("name", "start", "end", "tid", "id", "parent", "call",
                 "attrs")

    def __init__(self, name, start, tid, span_id, parent, call, attrs):
        self.name, self.start, self.end = name, start, None
        self.tid, self.id, self.parent = tid, span_id, parent
        self.call, self.attrs = call, attrs

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start}, {self.end}, id={self.id}, "
                f"parent={self.parent}, call={self.call}, {self.attrs})")


class Trace:
    """What ``collect()`` returns: the ended spans of every thread, by
    start, and the counters summed over the threads."""

    __slots__ = ("spans", "counters")

    def __init__(self, spans, counters):
        self.spans, self.counters = spans, counters


class _Buffer:
    __slots__ = ("thread", "tid", "spans", "counts", "device_counts",
                 "stack", "call")

    def __init__(self):
        self.thread = threading.current_thread()
        self.tid = threading.get_native_id()
        self.spans, self.counts, self.device_counts = [], {}, []
        self.stack, self.call = [], None


def _buffer() -> _Buffer:
    try:
        return _local.buf
    except AttributeError:
        b = _local.buf = _Buffer()
        with _lock:
            _buffers.append(b)
        return b


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def collect() -> Trace:
    """Return and clear the spans and counters of every thread. Spans still
    open stay with their thread; the buffers of threads that have ended go
    once emptied. Counters of ``count_device`` wait for the device here."""
    with _lock:
        bufs = list(_buffers)
        _buffers[:] = [b for b in bufs if b.thread.is_alive()]
    spans, counters = [], {}
    for b in bufs:
        s, b.spans = b.spans, []
        c, b.counts = b.counts, {}
        d, b.device_counts = b.device_counts, []
        spans.extend(list(s))
        for k, v in c.copy().items():
            counters[k] = counters.get(k, 0) + v
        for k, t in list(d):
            counters[k] = counters.get(k, 0) + int(t)
    spans.sort(key=lambda sp: (sp.start, sp.id))
    return Trace(spans, counters)


def begin(name: str, **attrs) -> Span:
    """Begin a span inside the thread's innermost open span."""
    b = _buffer()
    sp = Span(name, time.time_ns(), b.tid, next(_span_ids),
              b.stack[-1].id if b.stack else None, b.call, attrs)
    b.stack.append(sp)
    return sp


def call(name: str, **attrs) -> Span:
    """Begin the span of a new ``compress_image`` call: it and every span
    inside it carry a new call id. Spans an earlier call left open (it
    raised) are dropped."""
    b = _buffer()
    b.stack.clear()
    b.call = next(_call_ids)
    return begin(name, **attrs)


def end(sp: Span, nbytes: int | None = None) -> None:
    """End ``sp`` and any span begun inside it that is still open. A span
    begun by ``sync`` with a copy direction takes the copy's ``nbytes``."""
    sp.end = time.time_ns()
    b = _buffer()
    if sp in b.stack:
        del b.stack[b.stack.index(sp):]
    if not b.stack:
        b.call = None
    b.spans.append(sp)
    if nbytes is not None:
        sp.attrs["bytes"] = nbytes
        d = sp.attrs.get("copy")
        if d:
            count(f"copy.{d}.bytes", nbytes)
            count(f"copy.{d}.count")


def count(name: str, n: int = 1) -> None:
    c = _buffer().counts
    c[name] = c.get(name, 0) + n


def count_device(name: str, t) -> None:
    """Add the device scalar ``t`` to counter ``name`` when ``collect()``
    reads it, so the encode does not wait for it. Read after the encode
    that made it has returned: its last copy to the host waited for it."""
    _buffer().device_counts.append((name, t))


def sync(site: str, copy: str | None = None) -> Span:
    """Count a host wait on the device at ``site`` and begin its span;
    ``copy`` ("h2d" or "d2h") where the wait is a blocking copy, whose
    bytes ``end`` takes."""
    count("sync." + site)
    if copy:
        return begin("sync", site=site, copy=copy)
    return begin("sync", site=site)
