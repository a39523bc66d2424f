"""Smoke run of the astcenc_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the script exits non-zero
and never prints the last line:

1. device: refuse to run without CUDA; print the card's name and power
   limit as nvidia-smi reports them;
2. build: compile kernels K1 (mode search) and K2 (refinement rounds) from
   astcenc_torch/csrc with nvcc for sm_90a;
3. kernels: capture the real inputs of both kernels from a 512x512 encode
   of the slice configuration and hold each kernel against its plain
   PyTorch version on the card (the tolerances of tests/test_pallas.py),
   timing both;
4. slice: encode a 2048x2048 synthetic RGBA8 texture through
   api.compress_image (6x6 LDR -medium, partition count limit 1, 2-plane
   correlation limit 0), decode it through api.decompress_image, check the
   launch counts and the PSNR, and compare a 256x256 crop with the encode
   through the plain versions.

The second-to-last lines are the kernel table as JSON and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SIZE = 2048      # side of the slice texture
CAPTURE = 512    # side of the image whose kernel inputs are captured
CROP = 256       # side of the crop compared with the plain versions


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _slice_config(api):
    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    cfg.tune_partition_count_limit = 1
    cfg.tune_2plane_early_out_limit_correlation = 0.0
    return cfg


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def _capture(msearch_ops, refine_ops):
    """Wrap mode_search / trial1_refine to record the inputs of their first
    full-pass call (more than one mode)."""
    seen = {}
    orig_ms = msearch_ops.mode_search
    orig_rf = refine_ops.trial1_refine

    def ms(pt, *args, **kw):
        if "ms" not in seen and pt.quant_m_np.shape[0] > 1:
            seen["ms"] = (pt, [a.clone() if torch.is_tensor(a) else a
                               for a in args])
        return orig_ms(pt, *args, **kw)

    def rf(pt, *args, **kw):
        if "rf" not in seen and pt.quant_m_np.shape[0] > 1:
            seen["rf"] = (pt, [a.clone() if torch.is_tensor(a) else a
                               for a in args])
        return orig_rf(pt, *args, **kw)

    msearch_ops.mode_search = ms
    refine_ops.trial1_refine = rf

    def restore():
        msearch_ops.mode_search = orig_ms
        refine_ops.trial1_refine = orig_rf
    return seen, restore


def _check_msearch(got, want):
    """tests/test_pallas.py::_check_agreement bounds."""
    g = {k: v.cpu().numpy() for k, v in got.items()}
    w = {k: v.cpu().numpy() for k, v in want.items()}
    same = g["mode"] == w["mode"]
    frac = float(same.mean())
    assert frac > 0.96, f"K1 candidate agreement {frac}"
    rel = np.abs(g["err"][same] - w["err"][same]) / np.maximum(
        np.abs(w["err"][same]), 1.0)
    med, p95 = float(np.median(rel)), float(np.percentile(rel, 95))
    assert med < 1e-5 and p95 < 1e-3, f"K1 error rel median {med} p95 {p95}"
    for k in ("dm", "wq", "valid"):
        assert np.array_equal(g[k][same], w[k][same]), f"K1 {k} differs"
    agree = {}
    for k, bound in (("cq", 0.99), ("cqm", 0.99), ("fmt", 0.99),
                     ("uq", 0.995)):
        agree[k] = float((g[k][same] == w[k][same]).mean())
        assert agree[k] > bound, f"K1 {k} agreement {agree[k]}"
    return {"candidate_agreement": frac, "err_rel_median": med,
            "err_rel_p95": p95, **agree}


def _records(rf, wgrid0, N, C):
    """Refine outputs -> per-block records in reference visit order
    [r0-pre, r0-post, r1-post, ...] (codec/trial.py)."""
    R = rf["err_post"].shape[0]
    K = R + 1

    def rec(pre0, post):
        rr = torch.cat([pre0[None], post], 0)
        shp = tuple(rr.shape[2:])
        rr = rr.reshape((K, N, C) + shp)
        return rr.permute((1, 2, 0) + tuple(range(3, 3 + len(shp)))).reshape(
            (N, C * K) + shp).cpu().numpy()

    return {"err": rec(rf["err_pre"], rf["err_post"]),
            "fmt": rec(rf["fmt"][0], rf["fmt"]),
            "vals": rec(rf["vals"][0], rf["vals"]),
            "w": rec(wgrid0, rf["wpost"])}


def _check_refine(got, want):
    """tests/test_pallas.py:322-339 bounds on the trial records."""
    ek, ex = got["err"], want["err"]
    live = ex < 1e29
    rel = np.abs(ek[live] - ex[live]) / np.maximum(np.abs(ex[live]), 1e-30)
    worst = float(rel.max()) if rel.size else 0.0
    assert worst <= 3e-4, f"K2 record error rel {worst} > 3e-4"
    wk, wx = ek.argmin(1), ex.argmin(1)
    win = float((wk == wx).mean())
    assert win > 0.9, f"K2 winner agreement {win}"
    same = wk == wx
    agree = {}
    for k in ("fmt", "vals", "w"):
        a = got[k][same]
        b = want[k][same]
        idx = wk[same].reshape((-1, 1) + (1,) * (a.ndim - 2))
        agree[k] = float((np.take_along_axis(a, idx, 1)
                          == np.take_along_axis(b, idx, 1)).mean())
        assert agree[k] > 0.97, f"K2 {k} agreement {agree[k]}"
    return {"err_rel_max": worst, "winner_agreement": win, **agree}


def _profile(run):
    """Device time by kernel over one run (torch.profiler): K1, K2, the
    other device operations by name, their count, and the share of the
    wall time the device was idle (busy = summed kernel and copy time; the
    encode runs on one stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        rows.append((dev_us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": (1.0 - busy / wall_ms) if busy else None,
           "device_ops": sum(r[2] for r in rows)}
    for tag, pat in (("K1_ms", "msearch_kernel"), ("K2_ms", "refine_kernel")):
        out[tag] = sum(r[0] for r in rows if pat in r[1])
    out["top"] = [[k[:60], round(ms, 3), n] for ms, k, n in rows[:8]]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic images")
    args = ap.parse_args()

    # --- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 1
    from astcenc_torch import api, testdata
    from astcenc_torch.codec import compress as compress_mod
    from astcenc_torch.ops import _build, msearch, refine

    smi = _smi()
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load("msearch")
    _build.load("refine")
    build_s = time.perf_counter() - t0
    if _build.build_seconds:
        how = (f"built with nvcc {' '.join(_build.NVCC_FLAGS)}: "
               f"{build_s:.1f} s (nvcc {json.dumps(_build.build_seconds)})")
    else:
        how = f"cached libraries loaded in {build_s:.1f} s"
    print(f"build: K1 msearch.cu + K2 refine.cu {how}", flush=True)

    ctx = api.context_alloc(_slice_config(api), device=dev)
    rng_seed = args.seed

    # --- 3. kernels vs plain at captured shapes ----------------------------
    img_c = testdata.synthetic_image(CAPTURE, CAPTURE, rng_seed + 1)
    seen, restore = _capture(msearch, refine)
    try:
        api.compress_image(ctx, img_c)
    finally:
        restore()
    pt, ms_args = seen["ms"]
    C = ms_args[-1]
    ms_k = msearch.mode_search_cuda(pt, *ms_args)
    ms_p = msearch.mode_search_plain(pt, *ms_args)
    torch.cuda.synchronize()
    k1 = _check_msearch(ms_k, ms_p)
    k1_ms = _time_ms(lambda: msearch.mode_search_cuda(pt, *ms_args), 5)
    k1_plain = _time_ms(lambda: msearch.mode_search_plain(pt, *ms_args), 2)
    n_blocks = ms_args[0].shape[0]
    print(f"kernels: K1 mode search, {n_blocks} blocks x {C} candidates x "
          f"{pt.quant_m_np.shape[0]} modes: {json.dumps(k1)}; "
          f"kernel {k1_ms:.3f} ms, plain {k1_plain:.3f} ms", flush=True)

    pt2, rf_args = seen["rf"]
    N = rf_args[6].shape[0]
    Cr = rf_args[9]
    rf_k = refine.trial1_refine_cuda(pt2, *rf_args)
    rf_p = refine.trial1_refine_plain(pt2, *rf_args)
    torch.cuda.synchronize()
    k2 = _check_refine(_records(rf_k, rf_args[0], N, Cr),
                       _records(rf_p, rf_args[0], N, Cr))
    k2_ms = _time_ms(lambda: refine.trial1_refine_cuda(pt2, *rf_args), 5)
    k2_plain = _time_ms(lambda: refine.trial1_refine_plain(pt2, *rf_args), 2)
    print(f"kernels: K2 refine, {N * Cr} lanes x {rf_args[10]} rounds: "
          f"{json.dumps(k2)}; kernel {k2_ms:.3f} ms, plain {k2_plain:.3f} ms",
          flush=True)

    # --- 4. the slice ------------------------------------------------------
    img = testdata.synthetic_image(SIZE, SIZE, rng_seed)
    crop = np.ascontiguousarray(img[:CROP, :CROP])
    api.compress_image(ctx, crop)                         # warm-up
    torch.cuda.synchronize()
    msearch.launches = 0
    refine.launches = 0
    t0 = time.perf_counter()
    blocks = api.compress_image(ctx, img)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    launches = {"msearch": msearch.launches, "refine": refine.launches}
    assert launches["msearch"] > 0 and launches["refine"] > 0, launches
    nb = blocks.shape[0]
    side = -(-SIZE // 6)
    assert blocks.shape == (side * side, 16), blocks.shape
    dec = api.decompress_image(ctx, blocks, SIZE, SIZE)[0]
    assert dec.shape == img.shape and np.isfinite(dec).all()
    psnr = _psnr(dec, img)
    assert psnr > 20.0, f"PSNR {psnr} dB"
    mtex = SIZE * SIZE / enc_s / 1e6
    print(f"slice: {SIZE}x{SIZE} RGBA8, {nb} blocks at 6x6, "
          f"encode {enc_s:.3f} s = {mtex:.3f} Mtexels/s, PSNR {psnr:.4f} dB, "
          f"launches {json.dumps(launches)} | {smi}", flush=True)

    print(f"profile: {json.dumps(_profile(lambda: api.compress_image(ctx, img)))}",
          flush=True)

    b_k = api.compress_image(ctx, crop)
    b_p = compress_mod.compress_image(ctx, crop, use_kernels=False)
    ident = float((b_k == b_p).all(1).mean())
    d_k = api.decompress_image(ctx, b_k, CROP, CROP)[0]
    d_p = api.decompress_image(ctx, b_p, CROP, CROP)[0]
    dpsnr = _psnr(d_k, crop) - _psnr(d_p, crop)
    assert ident >= 0.9, f"crop identical blocks {ident}"
    assert abs(dpsnr) <= 0.05, f"crop PSNR delta {dpsnr} dB"
    print(f"crop: {CROP}x{CROP} kernels vs plain versions: "
          f"{ident:.4f} identical blocks, PSNR {_psnr(d_k, crop):.4f} vs "
          f"{_psnr(d_p, crop):.4f} dB", flush=True)

    kernels = [
        {"name": "msearch", "route": "cuda",
         "source": "astcenc_torch/csrc/msearch.cu",
         "replaces": "astcenc_tpu/ops/msearch_pallas.py:281",
         "launches": launches["msearch"],
         "max_abs_err": float((ms_k["err"] - ms_p["err"]).abs()[
             ms_k["mode"] == ms_p["mode"]].max()),
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "refine", "route": "cuda",
         "source": "astcenc_torch/csrc/refine.cu",
         "replaces": "astcenc_tpu/ops/refine_pallas.py:348",
         "launches": launches["refine"],
         "max_abs_err": float((rf_k["err_post"] - rf_p["err_post"]).abs()[
             rf_p["err_post"] < 1e29].max()),
         "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
