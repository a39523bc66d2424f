"""CPU tests of the metrics that read the program's own spans and counters
(``program_trace.py`` and its seven readers).

    python -m pytest benchmark/test_bench_obs.py -q
"""

from __future__ import annotations

import dataclasses
import os
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, program_trace, trace  # noqa: E402

COUNTERS = ("kernel_launches_per_mtexel", "host_syncs_per_mtexel",
            "sync_wait_ms_per_mtexel", "stage2a_blocks_pct",
            "stage2b_blocks_pct")
IDLE = ("idle_prep_pct", "idle_dispatch_pct")


def _span(name, start, end):
    return types.SimpleNamespace(name=name, start=start, end=end, attrs={})


def _run(spans, counters, device, texels=2_000_000):
    """A run whose every reader's probe holds one recording."""
    rec = types.SimpleNamespace(spans=spans, counters=counters)
    probe = types.SimpleNamespace(trace=rec)
    tr = trace.TraceData(device, [], texels, {})
    return types.SimpleNamespace(
        trace=tr, probes={m: probe for m in COUNTERS + IDLE})


def _read(name, run):
    return harness.metric_module(name, ROOT).read(run)


def test_counter_readers():
    c = {"launch.msearch": 10, "launch.refine": 5, "launch.refine.asr": 3,
         "launch.refine.asr+rgbm": 1, "sync.compress.stage2a.nonzero": 2,
         "sync.ideal.channel_weight": 4, "blocks.stage1": 400,
         "blocks.stage2a": 100, "blocks.stage2b.pc2": 300,
         "blocks.stage2b.pc3": 50, "copy.h2d.bytes": 7}
    spans = [_span("compress_image", 0, 100), _span("sync", 10, 13),
             _span("sync", 20, 30), _span("chunk", 5, 90)]
    run = _run(spans, c, [(0, 5, "k", 7)])
    assert _read("kernel_launches_per_mtexel", run) == 7.5
    assert _read("host_syncs_per_mtexel", run) == 3.0
    assert _read("sync_wait_ms_per_mtexel", run) == pytest.approx(13e-6 / 2)
    assert _read("stage2a_blocks_pct", run) == 25.0
    assert _read("stage2b_blocks_pct", run) == 75.0


def test_zero_counts_read_zero():
    """A count of 0, or one never counted, is the number 0; no stage-1
    blocks, or no recording, is no reading."""
    run = _run([], {"blocks.stage1": 10}, [(0, 5, "k", 7)])
    for name in COUNTERS:
        assert _read(name, run) == 0.0
    assert _read("stage2b_blocks_pct", _run([], {}, [])) is None
    run.probes = {}
    for name in COUNTERS + IDLE:
        assert _read(name, run) is None


def test_idle_split_adds_up_to_the_device_idle():
    """The card runs [0, 10], [30, 40], [70, 100] of the active part [0,
    100]: idle 20 + 30 = 50. The client is in compress_image over [5, 60]
    (a prep span [25, 35] inside a glue span [20, 50], counted once, as
    prep) and over [65, 100] (prep [90, 100]); [60, 65] lies between calls.
    """
    dev = [(0, 10, "k", 7), (30, 40, "k", 7), (70, 100, "k", 7)]
    spans = [_span("compress_image", 5, 60), _span("chunk", 20, 50),
             _span("h2d", 25, 35), _span("sync", 26, 34),
             _span("compress_image", 65, 100), _span("assemble", 90, 100),
             _span("image_to_blocks", 12, 14)]
    run = _run(spans, {}, dev)
    prep = _read("idle_prep_pct", run)
    disp = _read("idle_dispatch_pct", run)
    idle = harness.metric_module("device_idle_pct", ROOT).read(run)
    # Gaps [10, 30] and [40, 70]. Prep: [12, 14] and [25, 30], 7.
    # Dispatch: [10, 30] less the prep, 13; [40, 60], 20; [65, 70], 5.
    assert prep == pytest.approx(7.0)
    assert disp == pytest.approx(38.0)
    assert idle == pytest.approx(50.0)
    assert idle - prep - disp == pytest.approx(5.0)     # between the calls


def test_idle_readers_need_a_device_trace():
    run = _run([_span("compress_image", 0, 10)], {}, [])
    assert run.trace.active is None
    for name in IDLE:
        assert _read(name, run) is None


def test_probes_share_one_recording(monkeypatch):
    """The first start enables the program's tracing, the last stop
    collects it and disables it; every probe then sees the recording."""
    calls = []
    fake = types.SimpleNamespace(
        enable=lambda: calls.append("enable"),
        disable=lambda: calls.append("disable"),
        collect=lambda: calls.append("collect") or "recording")
    monkeypatch.setattr(program_trace, "_program_obs", lambda: fake)
    probes = [program_trace.Probe() for _ in range(3)]
    for p in probes:
        p.start()
    assert calls == ["collect", "enable"]
    for p in probes:
        p.stop()
    assert calls == ["collect", "enable", "collect", "disable"]
    assert [p.trace for p in probes] == ["recording"] * 3


def test_a_program_without_tracing_reads_nothing(monkeypatch):
    monkeypatch.setattr(program_trace, "_program_obs", lambda: None)
    p = program_trace.Probe()
    p.start()
    p.stop()
    assert p.trace is None
    run = types.SimpleNamespace(trace=trace.TraceData([(0, 5, "k", 7)], [],
                                                      10, {}),
                                probes={m: p for m in COUNTERS + IDLE})
    for name in COUNTERS + IDLE:
        assert _read(name, run) is None


def test_traced_cpu_run_reads_the_counters():
    """A whole traced run on the CPU at a tiny size: the counter metrics
    read numbers, the device-trace ones nothing (no card)."""
    from astcenc_torch import obs
    cell = harness.find_cell(harness.load_benchmark(ROOT),
                             "ldr_6x6_medium.rgba1k.c1", ROOT)
    cell = dataclasses.replace(cell, traffic=dict(
        cell.traffic, sizes=[[24, 18]], set_size=2, stretch_per_client=2))
    r = harness.run_cell(cell, 2**31 + 11, 0.2, True, device="cpu",
                         min_encodes=1, log=lambda m: None)
    m = r["metrics"]
    assert r["correct"] and not obs.on
    assert m["kernel_launches_per_mtexel"]["value"] == 0.0   # plain on a CPU
    assert m["host_syncs_per_mtexel"]["value"] > 0
    assert m["sync_wait_ms_per_mtexel"]["value"] > 0
    assert 0 < m["stage2a_blocks_pct"]["value"] <= 100
    assert 0 < m["stage2b_blocks_pct"]["value"] <= 100
    for name in IDLE + ("device_idle_pct",):
        assert name not in m
