"""The port's spans and counters (``astcenc_torch.obs``) on the CPU.

One small LDR RGBA texture (36x36, an alpha of its own on the right half,
so stages 2a and 2b run) at 6x6 -medium, encoded once with the tracing
off and once on (with the -dtrace tree, its stage 1 under a CPU-only
``torch.profiler``), and twice more at once in two threads. The blocks,
the nesting of the spans, the counters against the encode's own masks
and the -dtrace tree, thread safety, and the shared clock with the
profiler are held. A 24x24 texture at 12x12 -thorough holds the partition
search's counter against its line-error calls.
"""

import threading

import numpy as np
import pytest
import torch

from astcenc_torch import api, obs, testdata
from astcenc_torch.codec import compress
from astcenc_torch.codec.trace import Tracer, TraceNode
from astcenc_torch.ops import psearch

NAMES = {"compress_image", "image_to_blocks", "chunk", "h2d", "sync",
         "stage1", "stage2a", "stage2b", "finalize", "d2h", "assemble"}


def _encode_traced(ctx, img, monkeypatch):
    """One encode with the tracing on and a -dtrace tree, its stage-1 call
    under a CPU-only profiler; returns the blocks, the recording, the tree
    and the profiler's events (name, start, end)."""
    from torch.profiler import ProfilerActivity, profile
    stage1 = compress.stage1_1plane
    prof = profile(activities=[ProfilerActivity.CPU])

    def profiled(*args, **kw):
        prof.start()
        try:
            return stage1(*args, **kw)
        finally:
            prof.stop()

    monkeypatch.setattr(compress, "stage1_1plane", profiled)
    tracer = Tracer()
    obs.enable()
    try:
        blocks = api.compress_image(ctx, img, tracer=tracer)
    finally:
        obs.disable()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return blocks, obs.collect(), tracer, events


@pytest.fixture(scope="module")
def run():
    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    ctx = api.context_alloc(cfg, device="cpu")
    img = testdata.synthetic_image(36, 36, 3, independent_alpha=True)
    obs.collect()
    off = api.compress_image(ctx, img)
    left = obs.collect()
    with pytest.MonkeyPatch.context() as mp:
        on, got, tracer, events = _encode_traced(ctx, img, mp)
    return {"ctx": ctx, "img": img, "off": off, "left": left, "on": on,
            "got": got, "tracer": tracer, "events": events}


def test_off_by_default_and_blocks_unchanged(run):
    assert not obs.on
    assert run["left"].spans == [] and run["left"].counters == {}
    assert np.array_equal(run["off"], run["on"])


def test_spans_nest_and_share_the_call(run):
    spans = run["got"].spans
    assert {s.name for s in spans} == NAMES
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["compress_image"]
    assert roots[0].attrs == {"texels": 36 * 36, "blocks": 36, "chunks": 1}
    for s in spans:
        assert s.call == roots[0].call is not None
        assert s.start <= s.end
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
    assert {by_id[s.parent].name for s in spans
            if s.name in ("stage1", "stage2a", "stage2b", "h2d",
                          "d2h")} == {"chunk"}
    stage2b = [s.attrs["pc"] for s in spans if s.name == "stage2b"]
    assert stage2b == [2, 3]


def test_counters_match_the_stage_masks(run):
    """blocks.stage2a is the stage-2a mask of a direct stage-1 call on the
    same texels; the -dtrace tree's 2-plane and 2-partition passes lie
    within the blocks the counters say entered those stages."""
    c = run["got"].counters
    ctx = run["ctx"]
    tex = torch.from_numpy(compress.image_to_blocks(ctx, run["img"]))
    scb, aux = compress.stage1_1plane(ctx, tex)
    assert c["blocks.stage1"] == 36 and c["blocks.const"] == int(
        aux["is_const"].sum())
    assert c["blocks.stage2a"] == int((~scb["finished"]
                                       & ~aux["skip2p"]).sum())

    def with_pass(key, value):
        return sum(any(isinstance(p, TraceNode) and p.name == "pass"
                       and [key, value] in p.items for p in b.items)
                   for b in run["tracer"].blocks.values())

    two_plane = with_pass("plane_count", 2)
    two_part = with_pass("partition_count", 2)
    assert 0 < two_plane <= c["blocks.stage2a"]
    assert 0 < two_part <= c["blocks.stage2b.pc2"]
    assert c["sync.compress.stage2a.nonzero"] == 1
    assert c["sync.compress.stage2b.nonzero"] == 2
    assert c["copy.h2d.count"] >= 1
    assert c["copy.d2h.bytes"] == 36 * 16 and c["copy.d2h.count"] == 1
    assert not any(k.startswith("launch.") for k in c)     # plain on a CPU


def test_two_threads_count_twice(run):
    """Two encodes at once, in two threads: each counter reads twice the
    one encode's, and each thread's spans carry a call of their own."""
    ctx2 = api.context_alloc(run["ctx"].config, device="cpu")
    outs = {}

    def enc(k, ctx):
        outs[k] = api.compress_image(ctx, run["img"])

    obs.enable()
    try:
        ts = [threading.Thread(target=enc, args=(k, c))
              for k, c in enumerate((run["ctx"], ctx2))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        obs.disable()
    got = obs.collect()
    one = run["got"].counters
    assert got.counters == {k: 2 * v for k, v in one.items()}
    assert all(np.array_equal(o, run["off"]) for o in outs.values())
    calls = {}
    for s in got.spans:
        calls.setdefault(s.tid, set()).add(s.call)
    assert len(calls) == 2 and all(len(v) == 1 for v in calls.values())
    assert len(set.union(*calls.values())) == 2


def test_spans_share_the_profiler_clock(run):
    """The ATen operators the profiler saw in the stage-1 call lie within
    the ``stage1`` span, to within 1 ms."""
    (s1,) = [s for s in run["got"].spans if s.name == "stage1"]
    ops = [e for e in run["events"] if e[0].startswith("aten::")]
    assert len(ops) > 100
    for _, s, e in ops:
        assert s1.start - 1_000_000 <= s and e <= s1.end + 1_000_000


def test_disabled_sites_record_nothing_and_collect_clears(run):
    assert obs.collect().spans == []
    sp = obs.begin("outer")
    obs.count("x", 3)
    inner = obs.begin("inner")
    obs.end(sp)                    # ends the inner span left open too
    got = obs.collect()
    assert [s.name for s in got.spans] == ["outer"]
    assert inner.end is None and got.counters == {"x": 3}
    assert obs.collect().counters == {}


def test_partitionings_count_the_line_error_calls(monkeypatch):
    """``psearch.partitionings.pc<p>`` is the sum of N x S over the
    line-error calls at partition count p: a 24x24 texture (4 blocks) at
    12x12 -thorough, whose LOW preset row scores 82, 60 and 30
    partitionings a block at 2, 3 and 4 partitions. A call with the
    tracing off records nothing."""
    cfg = api.config_init(api.Profile.LDR, 12, 12, 1, api.Quality.THOROUGH, 0)
    ctx = api.context_alloc(cfg, device="cpu")
    img = testdata.synthetic_image(24, 24, 3, independent_alpha=True)
    line_errors = psearch.line_errors
    calls = []

    def recorded(*args, **kw):
        calls.append((args, kw))
        return line_errors(*args, **kw)

    monkeypatch.setattr(psearch, "line_errors", recorded)
    obs.collect()
    obs.enable()
    try:
        api.compress_image(ctx, img)
    finally:
        obs.disable()
    c = obs.collect().counters
    want, widths = {}, {}
    for args, _ in calls:
        N, S = args[2].shape
        key = f"psearch.partitionings.pc{args[5]}"
        want[key] = want.get(key, 0) + N * S
        widths[args[5]] = S
    assert widths == {2: 82, 3: 60, 4: 30}
    assert {k: v for k, v in c.items()
            if k.startswith("psearch.partitionings.")} == want
    assert c["blocks.stage1"] == 4
    args, kw = calls[-1]
    line_errors(*args, **kw)
    assert obs.collect().counters == {}
