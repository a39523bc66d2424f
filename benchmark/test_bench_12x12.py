"""CPU tests of the cells ``ldr_12x12_thorough.rgba1k.c1`` and
``ldr_6x6_medium.rgb1k.c1`` and of the readers of the partition search:
discovery of the cells' files, a whole traced run of the 12x12 cell at a
small size, its control and two planted faults, and the readers
``psearch_partitionings_per_block``, ``stage2b_pc4_blocks_pct`` and
``k4_roofline`` on hand-made runs.

    python -m pytest benchmark/test_bench_12x12.py -q
"""

from __future__ import annotations

import dataclasses
import os
import sys
import types

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import (harness, readings, roofline, roofline_k4,  # noqa: E402
                       trace)

L12 = "ldr_12x12_thorough.rgba1k.c1"
RGB = "ldr_6x6_medium.rgb1k.c1"
NEW_METRICS = ("psearch_partitionings_per_block", "stage2b_pc4_blocks_pct",
               "k4_roofline")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(ROOT)


def _small(name, size, set_size=2, **traffic):
    cell = harness.find_cell(harness.load_benchmark(ROOT), name, ROOT)
    return dataclasses.replace(cell, traffic=dict(
        cell.traffic, sizes=[list(size)], set_size=set_size, **traffic))


@pytest.mark.parametrize("name,block,preset,alpha", [
    (L12, [12, 12, 1], "thorough", True),
    (RGB, [6, 6, 1], "medium", False)])
def test_new_cells_are_found_by_name(bench, name, block, preset, alpha):
    """The configuration, traffic and limits of each new cell are found
    from its name; it reports set-up, the encode rate, the quality and
    the new readers it is listed for."""
    c = harness.find_cell(bench, name, ROOT)
    assert c.chips == 1
    assert c.config["block"] == block and c.config["preset"] == preset
    assert c.config["profile"] == "LDR" and c.config["flags"] == []
    assert c.traffic["content"] == "ldr" and c.traffic["clients"] == 1
    assert c.traffic["independent_alpha"] is alpha
    assert c.traffic["sizes"] == [[1024, 1024]] and c.traffic["set_size"] == 8
    assert set(c.limits) == {"failed_encodes", "missing_textures",
                             "illegal_blocks", "differing_encodes",
                             "texture_err_ratio", "block_err_ratio"}
    e2e = {m["name"] for m in c.end_to_end}
    assert e2e == {"encode_mtexels_s", "psnr_db", "mse_ppm", "setup_s"}
    layer = {m["name"] for m in c.per_layer}
    assert len(layer) == 17 + (name == L12)
    assert ("stage2b_pc4_blocks_pct" in layer) == (name == L12)
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_module(m["name"], ROOT).read)


def test_new_cells_share_a_texture_set_or_have_their_own(bench):
    """The 12x12 cell encodes the 6x6 LDR cell's textures; the colour
    cell a set of its own."""
    l12 = harness.find_cell(bench, L12, ROOT)
    ldr = harness.find_cell(bench, "ldr_6x6_medium.rgba1k.c1", ROOT)
    rgb = harness.find_cell(bench, RGB, ROOT)
    assert l12.traffic == ldr.traffic
    assert rgb.config == ldr.config
    assert rgb.traffic["content_seed"] not in (ldr.traffic["content_seed"],
                                               13002)


def test_traced_12x12_run_is_correct():
    """A whole traced run of the 12x12 cell on the CPU at 48x48 (16
    blocks a texture): correct, every check inside its limit, and the
    partition search's counters read (stage 1 to 2b at 4 partitions)."""
    cell = _small(L12, (48, 48), stretch_per_client=1)
    r = harness.run_cell(cell, 2**31 + 1201, 0.1, True, device="cpu",
                         min_encodes=2, log=lambda m: None)
    assert r["correct"], r["checks"]
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    m = r["metrics"]
    # 82 + 60 partitionings a block at 2 and 3 partitions when every block
    # reaches them, plus 30 for each that reaches 4.
    assert 0 < m["psearch_partitionings_per_block"]["value"] <= 82 + 60 + 30
    assert 0 <= m["stage2b_pc4_blocks_pct"]["value"] <= 100
    assert "k4_roofline" not in m                   # no card, no K4


@pytest.mark.parametrize("mode", ["control", "half", "altered"])
def test_12x12_control_and_faults_are_not_correct(mode):
    """The program under the control profile, and with half of each answer
    left out or one block moved, reads correct false at 12x12. At 192x192
    (16x16 blocks) each block is as smooth against the texture's
    luminance field as a 6x6 block of the 6x6 cells' 96x96 checks, so a
    moved block reads as it does at 1024x1024 (below the limit at 144x144,
    above it here)."""
    cell = _small(L12, (192, 192), set_size=1)
    rows = readings.readings(cell, [2**31 + 1207], 0.1,
                             control=mode == "control",
                             fault=None if mode == "control" else mode,
                             device="cpu")
    assert not rows[0]["correct"], rows[0]


def _run(counters, device=(), probes=None, texels=1_000_000,
         device_name=H100, symbols=None):
    rec = types.SimpleNamespace(spans=[], counters=counters)
    probe = types.SimpleNamespace(trace=rec)
    tr = trace.TraceData(list(device), [], texels, symbols or {})
    return types.SimpleNamespace(
        trace=tr, device_name=device_name,
        probes=probes if probes is not None
        else {m: probe for m in NEW_METRICS})


def _read(name, run):
    return harness.metric_module(name, ROOT).read(run)


def test_partition_search_counter_readers():
    c = {"blocks.stage1": 200, "blocks.stage2b.pc2": 200,
         "blocks.stage2b.pc3": 190, "blocks.stage2b.pc4": 10,
         "psearch.partitionings.pc2": 200 * 82,
         "psearch.partitionings.pc3": 190 * 60,
         "psearch.partitionings.pc4": 10 * 30}
    run = _run(c)
    assert _read("psearch_partitionings_per_block", run) == (
        pytest.approx(82 + 0.95 * 60 + 0.05 * 30))
    assert _read("stage2b_pc4_blocks_pct", run) == 5.0
    # The MID row stops at 3 partitions: no block at 4 reads 0.
    mid = _run({"blocks.stage1": 10, "psearch.partitionings.pc2": 340})
    assert _read("stage2b_pc4_blocks_pct", mid) == 0.0
    assert _read("psearch_partitionings_per_block", mid) == 34.0


def test_partition_search_readers_read_nothing_without_counters():
    """A program older than the counter, no stage-1 blocks or no recording
    read nothing."""
    old = _run({"blocks.stage1": 10, "blocks.stage2b.pc2": 9})
    assert _read("psearch_partitionings_per_block", old) is None
    assert _read("stage2b_pc4_blocks_pct", old) == 0.0
    for name in NEW_METRICS[:2]:
        assert _read(name, _run({})) is None
        assert _read(name, _run({"blocks.stage1": 1}, probes={})) is None


def _fake_psearch():
    def line_errors_cuda(texels, uses_alpha, top, pot_table, count_table,
                         P, wie, cw, cw_scale=None):
        N, S = top.shape
        return torch.zeros(N, S), torch.zeros(N, S)
    return types.SimpleNamespace(line_errors_cuda=line_errors_cuda)


def test_k4_calls_record_shapes_and_restore():
    mod = _fake_psearch()
    orig = mod.line_errors_cuda
    calls = roofline_k4.K4Calls(mod)
    calls.start()
    N, S, T, Q = 5, 7, 144, 11
    ua = torch.tensor([1, 0, 1, 1, 0], dtype=torch.int32)
    tex = torch.zeros(N, T, 4)
    top = torch.zeros(N, S, dtype=torch.int32)
    pot = torch.zeros(Q, T, dtype=torch.int32)
    mod.line_errors_cuda(tex, ua, top, pot, None, 3, 0.5, (1, 1, 1, 1))
    mod.line_errors_cuda(tex[:0], ua[:0], top[:0], pot, None, 2, 0.5,
                         (1, 1, 1, 1))
    calls.stop()
    assert mod.line_errors_cuda is orig
    (N1, S1, T1, P1, ua1, nb), = calls.calls
    assert (N1, S1, T1, P1) == (N, S, T, 3) and ua1 is ua
    assert nb == 4 * (N * T * 4 + N + N * S + Q * T) + 2 * 4 * N * S
    peak = roofline.peaks(H100)
    ops = roofline_k4.ops_k4(N, S, T, 3, 3)
    assert ops == S * (3 * roofline_k4.ops_per_candidate(T, 3, 4)
                       + 2 * roofline_k4.ops_per_candidate(T, 3, 3))
    assert calls.bounds_ms(peak) == pytest.approx(
        max(nb / 3.35e12, ops / 67e12) * 1e3)


def test_ops_per_candidate_by_hand():
    """RGBA at 36 texels and 2 partitions: 119 operations a texel and 191
    a partition; RGB: 87.5 and 128."""
    assert roofline_k4.ops_per_candidate(36, 2, 4) == 36 * 119 + 2 * 191
    assert roofline_k4.ops_per_candidate(36, 2, 3) == 36 * 87.5 + 2 * 128


def test_k4_roofline_reads_psearch_time_alone():
    """The share is the launches' bounds over K4's device time; other
    kernels' time is left out; no card, no recorded launch or no K4 time
    reads nothing."""
    calls = roofline_k4.K4Calls(_fake_psearch())
    ua = torch.ones(100, dtype=torch.int32)
    calls.calls.append((100, 82, 144, 2, ua, 1_000_000))
    peak = roofline.peaks(H100)
    bound_ms = calls.bounds_ms(peak)
    syms = {"psearch_kernel": "psearch", "msearch_kernel": "msearch"}
    dev = [(0, 40_000, "void (anonymous namespace)::psearch_kernel<2>"
            "((anonymous namespace)::Args)", 7),
           (50_000, 90_000, "void (anonymous namespace)::psearch_kernel<2>"
            "((anonymous namespace)::Args)", 7),
           (100_000, 900_000, "(anonymous namespace)::msearch_kernel("
            "(anonymous namespace)::Args)", 7)]
    run = _run({}, dev, probes={"k4_roofline": calls}, symbols=syms)
    assert _read("k4_roofline", run) == pytest.approx(
        100.0 * bound_ms / 0.08)
    assert 0 < _read("k4_roofline", run) < 100
    for bad in (dict(device_name="cpu"), dict(device=dev[2:])):
        r = _run({}, **{"device": dev, **bad}, probes={"k4_roofline": calls},
                 symbols=syms)
        assert _read("k4_roofline", r) is None
    empty = roofline_k4.K4Calls(_fake_psearch())
    assert _read("k4_roofline", _run({}, dev, probes={"k4_roofline": empty},
                                     symbols=syms)) is None
