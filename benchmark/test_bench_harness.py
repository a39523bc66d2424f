"""CPU tests of the benchmark's harness: discovery by name, the form of
BENCHMARK.json, the span and trace arithmetic, the seeded texture sets,
and that a run loads no JAX.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, stats, texgen, trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(ROOT)


def test_benchmark_json_form(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.add(m["name"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    assert len(names) == len(bench["end_to_end"]) + len(bench["per_layer"])
    for x in bench["configs"] + bench["workloads"]:
        assert NAME.match(x["name"])


@pytest.mark.parametrize("cell", ["ldr_6x6_medium.rgba1k.c1",
                                  "hdr_6x6_medium.env1k.c1"])
def test_discovery_by_name(bench, cell):
    """Every file of a cell is found from its name, every metric has a
    reader, and each cell reports set-up, another end-to-end metric and a
    per-layer metric."""
    c = harness.find_cell(bench, cell, ROOT)
    assert c.config["name"] == c.config_name
    assert c.traffic["clients"] >= 1 and c.traffic["set_size"] >= 1
    assert set(c.limits) >= {"illegal_blocks", "texture_err_ratio",
                             "block_err_ratio"}
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_module(m["name"], ROOT).read)
    with pytest.raises(KeyError):
        harness.find_cell(bench, "no_such.cell", ROOT)


class _S:
    def __init__(self, start, end, work):
        self.start, self.end, self.work = start, end, work


def test_window_work_credits_cut_encodes():
    spans = [_S(0.0, 1.0, 100), _S(1.0, 3.0, 100), _S(9.0, 11.0, 100)]
    # The first two lie inside [0, 10]; the last is half inside.
    assert stats.window_work(spans, 0.0, 10.0) == pytest.approx(250.0)
    assert stats.window_work(spans, 2.0, 10.0) == pytest.approx(100.0)


def test_quality_readers_agree():
    """psnr_db and mse_ppm read the same per-texture errors: the mean of
    the PSNRs, and the mean of the linear errors in millionths."""
    import types
    run = types.SimpleNamespace(quality={0: {"psnr": 37.0},
                                         1: {"psnr": 40.0}})
    assert harness.metric_module("psnr_db", ROOT).read(run) == 38.5
    mse = harness.metric_module("mse_ppm", ROOT).read(run)
    assert mse == pytest.approx(1e6 * (10**-3.7 + 10**-4.0) / 2)
    hdr = types.SimpleNamespace(quality={0: {"mpsnr": 48.0}})
    assert harness.metric_module("psnr_db", ROOT).read(hdr) is None
    assert harness.metric_module("mse_ppm", ROOT).read(hdr) == (
        pytest.approx(1e6 * 10**-4.8))


def test_percentile_matches_numpy():
    rng = np.random.default_rng(3)
    v = rng.exponential(1.0, 137).tolist()
    for q in (0, 5, 50, 95, 100):
        assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q))


def test_union_busy_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert stats.union(iv) == [(0, 3), (5, 6), (9, 12)]
    assert stats.busy(iv, 1, 10) == pytest.approx(2 + 1 + 1)
    assert stats.gaps(iv, 1, 10) == [(3, 5), (6, 9)]


def test_trace_reduction_on_made_events():
    """Two client streams: the active part ends where the first client's
    last operation ends; busy time is the union of both streams; port
    kernels are told from PyTorch's by their symbols."""
    syms = {"msearch_kernel": "msearch", "refine_kernel": "refine"}
    dev = [
        (0, 10, "(anonymous namespace)::msearch_kernel((anonymous "
                "namespace)::Args)", 7),
        (5, 20, "void at::native::elementwise_kernel<128, 2>(int)", 8),
        (30, 40, "void (anonymous namespace)::refine_kernel<2>(Args)", 7),
        (45, 60, "Memcpy HtoD (Pageable -> Device)", 8),
        (70, 80, "void at::native::vectorized_elementwise_kernel<4>()", 8),
    ]
    host = [(20, 30, "aten::nonzero"), (40, 45, "cudaMemcpyAsync"),
            (21, 22, "aten::add")]
    tr = trace.TraceData(dev, host, texels=2_000_000, symbols=syms)
    assert tr.active == (0, 40)
    assert tr.busy_s() == pytest.approx(30e-9)
    assert tr.window_s() == pytest.approx(40e-9)
    assert tr.mtexels == 2.0
    assert [tr.is_port_kernel(d[2]) for d in dev] == [True, False, True,
                                                      False, False]
    assert tr.source_of(dev[2][2]) == "refine"
    assert tr.idle_gaps() == [["aten::nonzero", pytest.approx(10e-9)]]
    ops = dict(tr.device_ops_by_time())
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(15e-9)


def test_kernel_symbols_of_the_port():
    syms = trace.kernel_symbols(os.path.join(ROOT, "astcenc_torch", "csrc"))
    assert syms["msearch_kernel"] == "msearch"
    assert syms["refine_round2_kernel"] == "refine_round2"
    assert syms["texel_sum_kernel"] == "texel_sum"


def test_texture_sets_repeat_exactly():
    """The set comes from the traffic file's own seed, the same in every
    run; the run's seed orders it."""
    traffic = {"content": "ldr", "independent_alpha": True,
               "content_seed": 2**31 + 17,
               "sizes": [[40, 30], [24, 36]], "set_size": 3}
    a = texgen.make_set(traffic)
    b = texgen.make_set(traffic, threads=1)
    c = texgen.make_set(dict(traffic, content_seed=2**31 + 18))
    assert [x.shape for x in a] == [(30, 40, 4), (36, 24, 4), (30, 40, 4)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[2])   # each texture has its own seed
    h = texgen.make_set(dict(traffic, content="hdr"), threads=2)
    assert h[0].dtype == np.float16 and float(h[0].max()) > 1.0


def test_encode_order_is_a_permutation_from_the_seed():
    """Every seed orders the whole set; the same seed the same way; each
    client walks it from its own offset."""
    seen = set()
    for seed in (1, 2, 2**31 + 5, 2**33 + 1):
        order = texgen.encode_order(8, 1, seed)
        assert order == texgen.encode_order(8, 1, seed)
        assert sorted(order[0]) == list(range(8))
        seen.add(tuple(order[0]))
    assert len(seen) > 1
    two = texgen.encode_order(8, 2, 7)
    assert two[1] == two[0][4:] + two[0][:4]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "jax_like", object())
    monkeypatch.setitem(sys.modules, "astcenc_tpu_notes", object())
    found = run.forbidden_modules()
    assert "jaxlib" in found
    assert "jax_like" not in found and "astcenc_tpu_notes" not in found
    assert "astcenc_torch" not in found


def test_a_run_loads_no_jax():
    """A whole run on the CPU at a tiny size, in a fresh process: once its
    window has closed, no loaded module's top-level name is jax, jaxlib,
    flax or astcenc_tpu."""
    code = f"""
import dataclasses, json, sys
sys.path.insert(0, {ROOT!r})
from benchmark import harness, run
cell = harness.find_cell(harness.load_benchmark(), "ldr_6x6_medium.rgba1k.c1")
cell = dataclasses.replace(cell, traffic=dict(
    cell.traffic, sizes=[[24, 18]], set_size=2, clients=2))
r = harness.run_cell(cell, 11, 0.2, True, device="cpu",
                     min_encodes=1, log=lambda m: None)
print(json.dumps({{"bad": run.forbidden_modules(),
                  "port": "astcenc_torch" in sys.modules,
                  "correct": r["correct"]}}))
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "port": True, "correct": True}


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ldr_6x6_medium.rgba1k.c1", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout
