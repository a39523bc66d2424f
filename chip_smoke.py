"""Smoke run of the astcenc_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each or more; any failure raises, so the script exits
non-zero and never prints the last line:

1. device: refuse to run without CUDA; print the card's name and power
   limit as nvidia-smi reports them;
2. build: compile kernels K1 (mode search), K2 (1-plane refinement), K3
   (2-plane refinement), K4 (partition line errors), K5 (one 1-plane HDR
   round), K6 and K7 (one 2-plane HDR round, its bootstrap) and K9 (colour
   quantizer lookup) from astcenc_torch/csrc with nvcc for sm_90a, one nvcc
   per source, started together;
3. kernels: capture the real inputs of every kernel form from a 512x512
   main-path encode (K1 with 1 and 2 planes and 2 and 3 partitions, K2 at
   1-3 partitions, K3, K4 at 2 and 3 partitions) and hold each kernel
   against its plain PyTorch version on the card (the tolerances of
   tests/test_pallas.py; K4: 99.9% of the line errors within 1e-4 and
   99% of the selected seeds equal), timing both with CUDA events;
4. stage 1: the earlier slice's configuration (partition count limit 1,
   2-plane correlation limit 0) at 512x512, launch counts read around it;
5. main path: a 2048x2048 synthetic RGBA8 texture (its right half with an
   alpha channel of its own) through api.compress_image at 6x6 LDR
   -medium (MID preset, nothing overridden), after a warm-up encode, and
   back through api.decompress_image: encode rate, PSNR, block counts by
   (partitions, planes) read from the encoded blocks, launch counts; then
   a profiled encode (device ops, idle share, time by kernel);
6. crop: a 256x256 crop encoded through the kernels and through the plain
   versions, >= 99% of blocks identical;
7. HDR kernels: capture the first-call inputs of every HDR kernel form
   from a 512x512 synthetic float16 HDR encode at -ch (K5 bootstrap and
   rounds at 1-3 partitions, K6, K7, K9's first and first 72-wide call)
   and hold each against its plain version (K5, K6: grids identical on
   99.9% of the lanes, errors within 3e-4; K7 within 1e-6; K9 bit-exact);
8. HDR path: a 2048x2048 synthetic float16 HDR texture (right half with an
   alpha of its own) through api.compress_image at 6x6 -medium -ch (phase
   7's encode was the warm-up); a second encode must be identical and is
   timed too; decoded to float32: encode rate, mPSNR, log-RMSE, block
   counts by kind and by endpoint format, launch counts; then a profiled
   encode of its central 1024x1024 quarter;
9. HDR crop: a 256x256 crop of it at -cH through the kernels and through
   the plain versions, >= 99% of blocks identical, HDR alpha present.

The lines before the last are the kernel table as JSON (K1-K4 launches
counted on the LDR main path, K5-K9 on the HDR path) and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}.

Each kernel's ``bound_ms`` is the larger of its bytes (each input tensor
read once, each output written once) over 3.35 TB/s and its float
operations over 67 TFLOP/s (H100 SXM, float32 without tensor cores). The
operation counts are models of the kernels' loops, per texel and weight,
written out in the ``_ops_*`` functions; where the work depends on the
data (lanes that stop refining), they count what the captured inputs need.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SIZE = 2048      # side of the main-path texture
CAPTURE = 512    # side of the images whose kernel inputs are captured
CROP = 256       # side of the crops compared with the plain versions
HDR_SIZE = 2048  # side of the HDR path's texture
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


def _capture(modules):
    """Wrap the kernels' dispatchers to record the inputs of the first call
    of each form. Returns (seen, restore)."""
    msearch, refine, psearch = modules
    seen = {}
    saved = [(msearch, "mode_search"), (refine, "trial1_refine"),
             (refine, "trial2_refine"), (psearch, "line_errors")]
    orig = {name: getattr(mod, name) for mod, name in saved}

    def keep(key, args, kw):
        if key not in seen:
            seen[key] = ([_clone(a) for a in args],
                         {k: _clone(v) for k, v in kw.items()
                          if k != "use_kernel"})

    def ms(pt, *args, **kw):
        if pt.kind != "always":
            keep(("K1", "two" if pt.kind == "two" else f"pc{pt.pc}"),
                 (pt,) + args, kw)
        return orig["mode_search"](pt, *args, **kw)

    def rf1(pt, *args, **kw):
        if pt.kind != "always":
            keep(("K2", f"pc{pt.pc}"), (pt,) + args, kw)
        return orig["trial1_refine"](pt, *args, **kw)

    def rf2(pt, *args, **kw):
        keep(("K3", "two"), (pt,) + args, kw)
        return orig["trial2_refine"](pt, *args, **kw)

    def le(*args, **kw):
        keep(("K4", f"P{args[5]}"), args, kw)
        return orig["line_errors"](*args, **kw)

    msearch.mode_search = ms
    refine.trial1_refine = rf1
    refine.trial2_refine = rf2
    psearch.line_errors = le

    def restore():
        for mod, name in saved:
            setattr(mod, name, orig[name])
    return seen, restore


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _bound(nbytes: int, ops: float):
    b_ms = nbytes / HBM_BYTES_S * 1e3
    o_ms = ops / F32_OPS_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


# --- operation models ----------------------------------------------------
# K1, per block and plane: the decimated ideal weights (16 per texel tap of
# each decimation), the angular sums and extents (8 per weight and angular
# step, 64 steps), and per mode the weight quantization (6 per weight) and
# the weight-set error (11 per texel); per mode the format lookup and the
# top-C insertion (8 + C).
def _ops_k1(pt, args, kw):
    wei = args[1]
    N, T = wei.shape
    D, W = pt.k.wt_n.shape
    M = pt.k.modes.shape[0]
    C = args[7]
    planes = 2 if kw.get("wei2") is not None else 1
    return N * (planes * (16 * D * T + 512 * D * W + M * (6 * W + 11 * T))
                + M * (8 + C))


# K2/K3, per lane and round: the refit (34 per texel and plane), the pack
# and decode (300 per partition), the trial error (40 per texel, twice in
# round 0) and, on lanes still refining, the realign (144 per texel and
# plane). Lanes refine in round r if their round-r error is live.
def _ops_refine(T, pc, planes, err_pre, err_post):
    NC = err_pre.numel()
    R = err_post.shape[0]
    alive = int((err_post < 1e29).sum())
    return (NC * R * (34 * planes * T + 300 * pc + 40 * T) + NC * 40 * T
            + alive * 144 * planes * T)


# K4, per block, candidate and texel: partition sums (8), the direction
# search (10 per channel in use) and both line errors (64).
def _ops_k4(args):
    texels, ua, top = args[0], args[1], args[2]
    N, S = top.shape
    T = texels.shape[1]
    nc = 3 * N + int((ua != 0).sum())
    return S * T * (72 * N + 10 * nc)


def _check_msearch(got, want):
    """tests/test_pallas.py::_check_agreement bounds; >= 99.5% of the
    candidates the same."""
    g = {k: v.cpu().numpy() for k, v in got.items()}
    w = {k: v.cpu().numpy() for k, v in want.items()}
    same = g["mode"] == w["mode"]
    frac = float(same.mean())
    assert frac >= 0.995, f"K1 candidate agreement {frac}"
    rel = np.abs(g["err"][same] - w["err"][same]) / np.maximum(
        np.abs(w["err"][same]), 1.0)
    med, p95 = float(np.median(rel)), float(np.percentile(rel, 95))
    assert med < 1e-5 and p95 < 1e-3, f"K1 error rel median {med} p95 {p95}"
    for k in ("dm", "wq", "valid"):
        assert np.array_equal(g[k][same], w[k][same]), f"K1 {k} differs"
    agree = {}
    for k, bound in (("cq", 0.99), ("cqm", 0.99), ("fmt", 0.99),
                     ("uq", 0.995), ("uq2", 0.995)):
        if k in w:
            agree[k] = float((g[k][same] == w[k][same]).mean())
            assert agree[k] > bound, f"K1 {k} agreement {agree[k]}"
    live = same & (w["err"] < 1e29)
    mae = float(np.abs(g["err"][live] - w["err"][live]).max()) \
        if live.any() else 0.0
    return {"candidate_agreement": frac, "err_rel_median": med,
            "err_rel_p95": p95, **agree}, mae


def _records(rf, grids, N, C):
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

    out = {"err": rec(rf["err_pre"], rf["err_post"]),
           "fmt": rec(rf["fmt"][0], rf["fmt"]),
           "vals": rec(rf["vals"][0], rf["vals"])}
    for name, (g0, post) in grids.items():
        out[name] = rec(g0, rf[post])
    return out


def _check_refine(tag, got, want):
    """tests/test_pallas.py:322-339 bounds on the trial records."""
    ek, ex = got["err"], want["err"]
    live = ex < 1e29
    assert np.array_equal(ek < 1e29, live), f"{tag} live records differ"
    rel = np.abs(ek[live] - ex[live]) / np.maximum(np.abs(ex[live]), 1e-30)
    worst = float(rel.max()) if rel.size else 0.0
    assert worst <= 3e-4, f"{tag} record error rel {worst} > 3e-4"
    wk, wx = ek.argmin(1), ex.argmin(1)
    win = float((wk == wx).mean())
    assert win > 0.9, f"{tag} winner agreement {win}"
    same = wk == wx
    agree = {}
    for k in got:
        if k == "err":
            continue
        a, b = got[k][same], want[k][same]
        idx = wk[same].reshape((-1, 1) + (1,) * (a.ndim - 2))
        agree[k] = float((np.take_along_axis(a, idx, 1)
                          == np.take_along_axis(b, idx, 1)).mean())
        assert agree[k] >= 0.97, f"{tag} {k} agreement {agree[k]}"
    mae = float(np.abs(ek[live] - ex[live]).max()) if live.any() else 0.0
    return {"err_rel_max": worst, "winner_agreement": win, **agree}, mae


def _profile(run):
    """Device time by kernel over one run (torch.profiler): K1-K9, the
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
    for tag, pat in (("K1_ms", "msearch_kernel"), ("K2_ms", "refine_kernel"),
                     ("K3_ms", "refine2_kernel"),
                     ("K4_ms", "psearch_kernel"),
                     ("K5_ms", "refine_round_kernel"),
                     ("K6_ms", "refine_round2_kernel"),
                     ("K7_ms", "refine_boot2_kernel"),
                     ("K9_ms", "quant_lookup_kernel")):
        out[tag] = sum(r[0] for r in rows if pat in r[1])
    out["top"] = [[k[:60], round(ms, 3), n] for ms, k, n in rows[:10]]
    return out


def _reset(msearch, refine, psearch, gather):
    msearch.launches = refine.launches = refine.launches2 = 0
    refine.launches_round1 = refine.launches_round2 = 0
    refine.launches_boot2 = psearch.launches = gather.launches = 0


def _counts(msearch, refine, psearch, gather):
    return {"msearch": msearch.launches, "refine": refine.launches,
            "refine2": refine.launches2, "psearch": psearch.launches,
            "refine_round": refine.launches_round1,
            "refine_round2": refine.launches_round2,
            "refine_boot2": refine.launches_boot2,
            "quant_lookup": gather.launches}


def _capture_hdr(refine, gather):
    """Wrap the HDR kernels' dispatchers to record the inputs of the first
    call of each form: K5 bootstrap and K5 rounds by partition count, K6,
    K7, and K9 (its first call, and its first 72-wide call, the retain-top-
    bits search). Returns (seen, restore)."""
    seen = {}
    orig = {"r1": refine.refine_round_1plane, "r2": refine.refine_round_2plane,
            "q": gather.quant_lookup}

    def keep(key, args):
        if key not in seen:
            seen[key] = [_clone(a) for a in args]

    def r1(pt, *args, **kw):
        keep(("K5", "boot" if args[9] == 0 else f"pc{pt.pc}"), (pt,) + args)
        return orig["r1"](pt, *args, **kw)

    def r2(pt, *args, **kw):
        keep(("K7" if args[10] == 0 else "K6", "two"), (pt,) + args)
        return orig["r2"](pt, *args, **kw)

    def q(qidx, vals, *args, **kw):
        keep(("K9", "first"), (qidx.to(torch.int32).contiguous(),
                               vals.to(torch.int32).contiguous()))
        if vals.shape[1] == 72:
            keep(("K9", "k72"), (qidx.to(torch.int32).contiguous(),
                                 vals.to(torch.int32).contiguous()))
        return orig["q"](qidx, vals, *args, **kw)

    refine.refine_round_1plane = r1
    refine.refine_round_2plane = r2
    gather.quant_lookup = q

    def restore():
        refine.refine_round_1plane = orig["r1"]
        refine.refine_round_2plane = orig["r2"]
        gather.quant_lookup = orig["q"]
    return seen, restore


# K5/K6, per lane: the trial error (40 per texel) before and after, the
# realign (144 per texel and plane) on lanes still alive, the infill (8 per
# texel and plane). K7: the infill alone. K9: a clamp and a lookup (4 per
# element).
def _ops_round(T, planes, lanes, alive, ncolors):
    return (lanes * (80 * T + 8 * planes * T)
            + (alive * 144 * planes * T if ncolors else 0))


def _check_round(tag, got, want, grids):
    """K5/K6 against the plain version: grids identical on >= 99.9% of the
    lanes, errors within 3e-4 relative on live lanes, infills within 1e-6
    relative where the grids agree."""
    same = torch.ones_like(want["err_pre"], dtype=torch.bool)
    for g in grids:
        same &= (got[g] == want[g]).all(1)
    frac = float(same.float().mean())
    assert frac >= 0.999, f"{tag} identical grids {frac}"
    worst = 0.0
    for k in ("err_pre", "err_post"):
        w = want[k][same]
        rel = float(((got[k][same] - w).abs() / w.abs().clamp(min=1e-30))
                    .max()) if w.numel() else 0.0
        worst = max(worst, rel)
    assert worst <= 3e-4, f"{tag} error rel {worst}"
    urel = 0.0
    for u in [k for k in want if k.startswith("undec")]:
        d = (got[u][same] - want[u][same]).abs()
        urel = max(urel, float((d / want[u][same].abs().clamp(min=1e-30))
                               .max()) if d.numel() else 0.0)
    assert urel <= 1e-6, f"{tag} infill rel {urel}"
    assert bool((got["adjusted"][same] == want["adjusted"][same]).all())
    mae = max(float((got[k] - want[k]).abs()[same].max())
              if same.any() else 0.0 for k in ("err_pre", "err_post"))
    return {"identical_grids": frac, "err_rel_max": worst,
            "infill_rel_max": urel}, mae


def _hdr_kinds(decompress, ctx, blocks):
    """Block counts by (partitions, planes) and by endpoint format."""
    kinds = _block_kinds(decompress, ctx, blocks)
    fm = decompress.endpoint_formats(ctx.torch_decode_tables(),
                                     torch.from_numpy(blocks).to(ctx.device))
    vals, counts = torch.unique(fm[fm >= 0], return_counts=True)
    return kinds, {int(v): int(c) for v, c in zip(vals, counts)}


def _block_kinds(decompress, ctx, blocks):
    const, pc, planes = decompress.block_types(
        ctx.torch_decode_tables(), torch.from_numpy(blocks).to(ctx.device))
    out = {"constant": int(const.sum())}
    real = ~const
    for p in (1, 2, 3, 4):
        for pl in (1, 2):
            n = int((real & (pc == p) & (planes == pl)).sum())
            if n:
                out[f"pc{p}_{pl}plane"] = n
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic images")
    args = ap.parse_args()

    # --- 1. device ---------------------------------------------------------
    t_start = time.perf_counter()

    def at() -> str:
        return f"[{time.perf_counter() - t_start:.0f} s]"

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 1
    from astcenc_torch import api, testdata
    from astcenc_torch.codec import compress as compress_mod
    from astcenc_torch.codec import decompress, partition_search
    from astcenc_torch.ops import _build, gather, msearch, psearch, refine
    from astcenc_torch.utils import metrics

    smi = _smi()
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    for name in _build.KERNELS:
        _build.load(name)
    build_s = time.perf_counter() - t0
    if _build.build_seconds:
        how = (f"built with nvcc {' '.join(_build.NVCC_FLAGS)}: "
               f"{build_s:.1f} s (nvcc {json.dumps(_build.build_seconds)})")
    else:
        how = f"cached libraries loaded in {build_s:.1f} s"
    print(f"build: K1 msearch.cu, K2 refine.cu, K3 refine2.cu, K4 psearch.cu, "
          f"K5 refine_round.cu, K6 and K7 refine_round2.cu, K9 "
          f"quant_lookup.cu {how}", flush=True)

    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    ctx = api.context_alloc(cfg, device=dev)

    # --- 3. kernels vs plain at captured shapes ----------------------------
    img_c = testdata.synthetic_image(CAPTURE, CAPTURE, args.seed + 1,
                                     independent_alpha=True)
    seen, restore = _capture((msearch, refine, psearch))
    try:
        api.compress_image(ctx, img_c)
    finally:
        restore()
    want_forms = {("K1", "pc1"), ("K1", "two"), ("K1", "pc2"), ("K1", "pc3"),
                  ("K2", "pc1"), ("K2", "pc2"), ("K2", "pc3"), ("K3", "two"),
                  ("K4", "P2"), ("K4", "P3")}
    missing = want_forms - set(seen)
    assert not missing, f"forms not captured: {sorted(missing)}"
    stats = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0.0,
                 "max_abs_err": 0.0}
             for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K9")}

    def account(kern, form, ms, plain_ms, nbytes, ops, mae, detail):
        s = stats[kern]
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["bytes"] += nbytes
        s["ops"] += ops
        s["max_abs_err"] = max(s["max_abs_err"], mae)
        bms, by = _bound(nbytes, ops)
        print(f"kernels: {kern} {form}: {json.dumps(detail)}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
              f"({by})", flush=True)

    for form in ("pc1", "two", "pc2", "pc3"):
        a, kw = seen[("K1", form)]
        pt = a[0]
        got = msearch.mode_search_cuda(*a, **kw)
        want = msearch.mode_search_plain(*a, **kw)
        torch.cuda.synchronize()
        detail, mae = _check_msearch(got, want)
        k = pt.k
        nbytes = (_nbytes(*a[1:7], *kw.values(), k.tap_w, k.tap_i, k.wt_t,
                          k.wt_i, k.wt_n, k.wcount, k.maxprec, k.modes, k.unq,
                          k.sin_t, k.cos_t, k.levels_used)
                  + _nbytes(*got.values()))
        detail = {"blocks": a[1].shape[0], "candidates": a[7],
                  "modes": int(k.modes.shape[0]), **detail}
        account("K1", form,
                _time_ms(lambda: msearch.mode_search_cuda(*a, **kw), 5),
                _time_ms(lambda: msearch.mode_search_plain(*a, **kw), 2),
                nbytes, _ops_k1(pt, a, kw), mae, detail)

    for form in ("pc1", "pc2", "pc3"):
        a, _ = seen[("K2", form)]
        pt, texels = a[0], a[8]
        N, C = texels.shape[0], a[12]
        got = refine.trial1_refine_cuda(*a)
        want = refine.trial1_refine_plain(*a)
        torch.cuda.synchronize()
        detail, mae = _check_refine(
            f"K2 {form}", _records(got, {"w": (a[1], "wpost")}, N, C),
            _records(want, {"w": (a[1], "wpost")}, N, C))
        k = pt.k
        nbytes = (_nbytes(*a[1:12], k.tap_w, k.tap_i, k.wt_t, k.wt_i, k.wt_n,
                          k.dm_color, k.pn, k.lohi)
                  + _nbytes(*got.values()))
        detail = {"lanes": N * C, "rounds": a[13], **detail}
        account("K2", form,
                _time_ms(lambda: refine.trial1_refine_cuda(*a), 5),
                _time_ms(lambda: refine.trial1_refine_plain(*a), 2),
                nbytes, _ops_refine(texels.shape[1], pt.pc, 1,
                                    want["err_pre"], want["err_post"]),
                mae, detail)

    a, _ = seen[("K3", "two")]
    pt = a[0]
    N, C = a[11].shape[0], a[13]
    got = refine.trial2_refine_cuda(*a)
    want = refine.trial2_refine_plain(*a)
    torch.cuda.synchronize()
    grids = {"w1": (a[1], "w1post"), "w2": (a[2], "w2post")}
    detail, mae = _check_refine("K3", _records(got, grids, N, C),
                                _records(want, grids, N, C))
    k = pt.k
    nbytes = (_nbytes(*a[1:13], k.tap_w, k.tap_i, k.wt_t, k.wt_i, k.wt_n,
                      k.dm_color, k.pn, k.lohi) + _nbytes(*got.values()))
    account("K3", "two", _time_ms(lambda: refine.trial2_refine_cuda(*a), 5),
            _time_ms(lambda: refine.trial2_refine_plain(*a), 2), nbytes,
            _ops_refine(a[9].shape[1], 1, 2, want["err_pre"],
                        want["err_post"]),
            mae, {"lanes": N * C, "rounds": a[14], **detail})

    for form in ("P2", "P3"):
        a, _ = seen[("K4", form)]
        uk, sk = psearch.line_errors_cuda(*a)
        ux, sx = psearch.line_errors_plain(*a)
        torch.cuda.synchronize()
        # A partition whose two longest directions tie to the last bits may
        # take the other one under another summation order; its errors then
        # differ by percents. Such slots must stay rare and must not move
        # the selected seeds.
        within = float(torch.minimum(
            (uk - ux).abs() <= 1e-4 * ux.abs(),
            (sk - sx).abs() <= 1e-4 * sx.abs()).float().mean())
        assert within >= 0.999, f"K4 {form} line errors within 1e-4: {within}"
        P = a[5]
        tabs = ctx.partition_tables(P)
        reqc = min(compress_mod._req_trials(cfg, P),
                   compress_mod._req_index(cfg, P), a[2].shape[1])
        top = a[2].long()
        sel_k = partition_search.select_candidates(uk, sk, tabs.seed, top,
                                                   reqc)
        sel_x = partition_search.select_candidates(ux, sx, tabs.seed, top,
                                                   reqc)
        seeds = float((sel_k[0] == sel_x[0]).float().mean())
        valid = float((sel_k[1] == sel_x[1]).float().mean())
        assert seeds >= 0.99 and valid >= 0.99, (seeds, valid)
        rel = float(torch.maximum(
            ((uk - ux).abs() / ux.abs().clamp(min=1e-30)).max(),
            ((sk - sx).abs() / sx.abs().clamp(min=1e-30)).max()))
        mae = float(torch.maximum((uk - ux).abs().max(),
                                  (sk - sx).abs().max()))
        # The kernel reads each candidate's table row, not the whole table.
        nbytes = (_nbytes(a[0], a[1], a[2], uk, sk)
                  + a[2].numel() * a[3].shape[1] * a[3].element_size())
        account("K4", form, _time_ms(lambda: psearch.line_errors_cuda(*a), 5),
                _time_ms(lambda: psearch.line_errors_plain(*a), 2), nbytes,
                _ops_k4(a), mae,
                {"blocks": a[0].shape[0], "candidates": a[2].shape[1],
                 "within_1e-4": within, "err_rel_max": rel,
                 "seeds_equal": seeds,
                 "valid_equal": valid})

    # --- 4. stage 1 (the earlier slice's configuration) --------------------
    cfg1 = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    cfg1.tune_partition_count_limit = 1
    cfg1.tune_2plane_early_out_limit_correlation = 0.0
    ctx1 = api.context_alloc(cfg1, device=dev)
    img1 = testdata.synthetic_image(CAPTURE, CAPTURE, args.seed + 2)
    counters = (msearch, refine, psearch, gather)
    _reset(*counters)
    t0 = time.perf_counter()
    b1 = api.compress_image(ctx1, img1)
    torch.cuda.synchronize()
    s1 = time.perf_counter() - t0
    n1 = _counts(*counters)
    assert n1["msearch"] > 0 and n1["refine"] > 0, n1
    d1 = api.decompress_image(ctx1, b1, CAPTURE, CAPTURE)[0]
    p1 = _psnr(d1, img1)
    assert np.isfinite(d1).all() and p1 > 20.0, p1
    print(f"{at()} stage 1: {CAPTURE}x{CAPTURE}, partition count limit 1, 2-plane "
          f"limit 0: {b1.shape[0]} blocks in {s1:.3f} s (first call at this "
          f"configuration), PSNR {p1:.4f} dB, launches {json.dumps(n1)}",
          flush=True)

    # --- 5. the main path --------------------------------------------------
    img = testdata.synthetic_image(SIZE, SIZE, args.seed,
                                   independent_alpha=True)
    api.compress_image(ctx, img)                          # warm-up
    torch.cuda.synchronize()
    _reset(*counters)
    t0 = time.perf_counter()
    blocks = api.compress_image(ctx, img)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    launches = _counts(*counters)
    ldr_kernels = ("msearch", "refine", "refine2", "psearch")
    assert all(launches[k] > 0 for k in ldr_kernels), launches
    side = -(-SIZE // 6)
    assert blocks.shape == (side * side, 16), blocks.shape
    t0 = time.perf_counter()
    again = api.compress_image(ctx, img)
    torch.cuda.synchronize()
    enc2_s = time.perf_counter() - t0
    assert (again == blocks).all(), "two encodes of one image differ"
    dec = api.decompress_image(ctx, blocks, SIZE, SIZE)[0]
    assert dec.shape == img.shape and np.isfinite(dec).all()
    psnr = _psnr(dec, img)
    assert psnr > 20.0, f"PSNR {psnr} dB"
    kinds = _block_kinds(decompress, ctx, blocks)
    for need in ("pc1_2plane", "pc2_1plane", "pc3_1plane"):
        assert kinds.get(need, 0) > 0, f"no {need} blocks: {kinds}"
    print(f"{at()} main path: {SIZE}x{SIZE} RGBA8, {blocks.shape[0]} blocks at 6x6 "
          f"-medium, encode {enc_s:.3f} s = {SIZE * SIZE / enc_s / 1e6:.3f} "
          f"Mtexels/s (again: {enc2_s:.3f} s = "
          f"{SIZE * SIZE / enc2_s / 1e6:.3f} Mtexels/s), PSNR {psnr:.4f} dB, "
          f"blocks {json.dumps(kinds)}, launches {json.dumps(launches)} | "
          f"{smi}", flush=True)
    prof = _profile(lambda: api.compress_image(ctx, img))
    print(f"{at()} profile: {json.dumps(prof)} | {smi}", flush=True)

    # --- 6. crop: kernels against plain versions ----------------------------
    crop = np.ascontiguousarray(img[:CROP, SIZE // 2 - CROP // 2:
                                    SIZE // 2 + CROP // 2])
    b_k = api.compress_image(ctx, crop)
    b_p = compress_mod.compress_image(ctx, crop, use_kernels=False)
    ident = float((b_k == b_p).all(1).mean())
    d_k = api.decompress_image(ctx, b_k, CROP, CROP)[0]
    d_p = api.decompress_image(ctx, b_p, CROP, CROP)[0]
    assert ident >= 0.99, f"crop identical blocks {ident}"
    print(f"{at()} crop: {CROP}x{CROP} (half of it with independent alpha) kernels "
          f"vs plain versions: {ident:.4f} identical blocks, PSNR "
          f"{_psnr(d_k, crop):.4f} vs {_psnr(d_p, crop):.4f} dB, blocks "
          f"{json.dumps(_block_kinds(decompress, ctx, b_k))}",
          flush=True)

    # --- 7. HDR kernels vs plain at captured shapes ------------------------
    cfg_h = api.config_init(api.Profile.HDR_RGB_LDR_A, 6, 6, 1,
                            api.Quality.MEDIUM, 0)
    ctx_h = api.context_alloc(cfg_h, device=dev)
    seen, restore = _capture_hdr(refine, gather)
    try:
        api.compress_image(ctx_h, testdata.synthetic_hdr_image(
            CAPTURE, CAPTURE, args.seed + 1, independent_alpha=True))
    finally:
        restore()
    want_forms = {("K5", "boot"), ("K5", "pc1"), ("K5", "pc2"), ("K5", "pc3"),
                  ("K6", "two"), ("K7", "two"), ("K9", "first"),
                  ("K9", "k72")}
    missing = want_forms - set(seen)
    assert not missing, f"HDR forms not captured: {sorted(missing)}"

    for form in ("boot", "pc1", "pc2", "pc3"):
        a = seen[("K5", form)]
        pt, ncolors = a[0], a[10]
        got = refine.refine_round_1plane_cuda(*a)
        want = refine.refine_round_1plane_plain(*a)
        torch.cuda.synchronize()
        detail, mae = _check_round(f"K5 {form}", got, want, ("grid",))
        k = pt.k
        nbytes = (_nbytes(*a[1:9], k.tap_w, k.tap_i, k.wt_t, k.wt_i, k.wt_n,
                          k.dm_color, k.pn) + _nbytes(*got.values()))
        lanes = a[1].shape[0]
        account("K5", form, _time_ms(lambda: refine.refine_round_1plane_cuda(
                    *a), 5),
                _time_ms(lambda: refine.refine_round_1plane_plain(*a), 2),
                nbytes, _ops_round(a[7].shape[1], 1, lanes,
                                   int(a[4].sum()), ncolors), mae,
                {"lanes": lanes, **detail})

    a = seen[("K6", "two")]
    got = refine.refine_round_2plane_cuda(*a)
    want = refine.refine_round_2plane_plain(*a)
    torch.cuda.synchronize()
    detail, mae = _check_round("K6", got, want, ("grid1", "grid2"))
    k = a[0].k
    lanes = a[1].shape[0]
    account("K6", "two", _time_ms(lambda: refine.refine_round_2plane_cuda(
                *a), 5),
            _time_ms(lambda: refine.refine_round_2plane_plain(*a), 2),
            _nbytes(*a[1:10], k.tap_w, k.tap_i, k.wt_t, k.wt_i, k.wt_n,
                    k.dm_color, k.pn) + _nbytes(*got.values()),
            _ops_round(a[9].shape[1], 2, lanes, int(a[5].sum()), a[11]), mae,
            {"lanes": lanes, **detail})

    a = seen[("K7", "two")]
    got = refine.refine_round_2plane_cuda(*a)
    want = refine.refine_round_2plane_plain(*a)
    torch.cuda.synchronize()
    urel = max(float(((got[u] - want[u]).abs()
                      / want[u].abs().clamp(min=1e-30)).max())
               for u in ("undec1", "undec2"))
    assert urel <= 1e-6, f"K7 infill rel {urel}"
    k = a[0].k
    lanes, T = a[1].shape[0], a[9].shape[1]
    account("K7", "two", _time_ms(lambda: refine.refine_round_2plane_cuda(
                *a), 5),
            _time_ms(lambda: refine.refine_round_2plane_plain(*a), 2),
            _nbytes(a[1], a[2], a[3], k.tap_w, k.tap_i)
            + _nbytes(*got.values()), lanes * 16 * T,
            max(float((got[u] - want[u]).abs().max())
                for u in ("undec1", "undec2")),
            {"lanes": lanes, "infill_rel_max": urel})

    for form in ("first", "k72"):
        q, v = seen[("K9", form)]
        got = gather.quant_lookup_cuda(q, v)
        want = gather.quant_lookup_plain(q, v)
        torch.cuda.synchronize()
        assert bool((got == want).all()), f"K9 {form} differs"
        account("K9", form, _time_ms(lambda: gather.quant_lookup_cuda(q, v),
                                     20),
                _time_ms(lambda: gather.quant_lookup_plain(q, v), 20),
                _nbytes(q, v, got) + 2 * 17 * 256 * 4, 4.0 * v.numel(), 0.0,
                {"rows": v.shape[0], "values": v.shape[1],
                 "bit_exact": True})

    # --- 8. the HDR path ----------------------------------------------------
    img_h = testdata.synthetic_hdr_image(HDR_SIZE, HDR_SIZE, args.seed,
                                         independent_alpha=True)
    src_h = img_h.astype(np.float32)
    # Phase 7's encode at this configuration was the warm-up.
    _reset(*counters)
    t0 = time.perf_counter()
    blocks_h = api.compress_image(ctx_h, img_h)
    torch.cuda.synchronize()
    enc_h = time.perf_counter() - t0
    launches_h = _counts(*counters)
    hdr_kernels = ("msearch", "psearch", "refine_round", "refine_round2",
                   "refine_boot2", "quant_lookup")
    assert all(launches_h[k] > 0 for k in hdr_kernels), launches_h
    t0 = time.perf_counter()
    again = api.compress_image(ctx_h, img_h)
    torch.cuda.synchronize()
    enc2_h = time.perf_counter() - t0
    assert (again == blocks_h).all(), "two HDR encodes of one image differ"
    dec_h = api.decompress_image(ctx_h, blocks_h, HDR_SIZE, HDR_SIZE,
                                 out_type="f32")[0]
    assert dec_h.shape == img_h.shape and np.isfinite(dec_h).all()
    mp = metrics.mpsnr(dec_h, src_h)
    lr = metrics.log_rmse(dec_h, src_h)
    kinds_h, fmts_h = _hdr_kinds(decompress, ctx_h, blocks_h)
    for need in ("pc1_2plane", "pc2_1plane", "pc3_1plane"):
        assert kinds_h.get(need, 0) > 0, f"no {need} blocks: {kinds_h}"
    assert any(f in fmts_h for f in (7, 11, 14)), fmts_h
    texels_h = HDR_SIZE * HDR_SIZE
    print(f"{at()} HDR path: {HDR_SIZE}x{HDR_SIZE} float16 RGBA, "
          f"{blocks_h.shape[0]} blocks at 6x6 -medium -ch, encode "
          f"{enc_h:.3f} s = {texels_h / enc_h / 1e6:.4f} Mtexels/s (again: "
          f"{enc2_h:.3f} s = {texels_h / enc2_h / 1e6:.4f} Mtexels/s), "
          f"mPSNR {mp:.4f} dB, log-RMSE {lr:.5f}, blocks "
          f"{json.dumps(kinds_h)}, endpoint formats {json.dumps(fmts_h)}, "
          f"launches {json.dumps(launches_h)} | {smi}", flush=True)
    # Profiled on the central quarter (both halves of the alpha): the whole
    # texture's 800,000 device operations take minutes to tabulate.
    q = HDR_SIZE // 4
    img_p = np.ascontiguousarray(img_h[q:3 * q, q:3 * q])
    prof_h = _profile(lambda: api.compress_image(ctx_h, img_p))
    print(f"{at()} HDR profile ({2 * q}x{2 * q} centre): "
          f"{json.dumps(prof_h)} | {smi}", flush=True)

    # --- 9. HDR crop at -cH: kernels against plain versions -----------------
    ctx_hh = api.context_alloc(api.config_init(
        api.Profile.HDR, 6, 6, 1, api.Quality.MEDIUM, 0), device=dev)
    crop_h = np.ascontiguousarray(
        img_h[:CROP, HDR_SIZE // 2 - CROP // 2:HDR_SIZE // 2 + CROP // 2])
    b_k = api.compress_image(ctx_hh, crop_h)
    b_p = compress_mod.compress_image(ctx_hh, crop_h, use_kernels=False)
    ident = float((b_k == b_p).all(1).mean())
    d_k, d_p = (api.decompress_image(ctx_hh, b, CROP, CROP,
                                     out_type="f32")[0] for b in (b_k, b_p))
    kinds_c, fmts_c = _hdr_kinds(decompress, ctx_hh, b_k)
    assert ident >= 0.99, f"HDR crop identical blocks {ident}"
    assert 15 in fmts_c, fmts_c
    src_c = crop_h.astype(np.float32)
    print(f"{at()} HDR crop: {CROP}x{CROP} at -cH (half of it with independent "
          f"alpha) kernels vs plain versions: {ident:.4f} identical blocks, "
          f"mPSNR {metrics.mpsnr(d_k, src_c):.4f} vs "
          f"{metrics.mpsnr(d_p, src_c):.4f} dB, blocks {json.dumps(kinds_c)}, "
          f"endpoint formats {json.dumps(fmts_c)}", flush=True)

    meta = {"K1": ("msearch", "astcenc_torch/csrc/msearch.cu",
                   "astcenc_tpu/ops/msearch_pallas.py:281"),
            "K2": ("refine", "astcenc_torch/csrc/refine.cu",
                   "astcenc_tpu/ops/refine_pallas.py:348"),
            "K3": ("refine2", "astcenc_torch/csrc/refine2.cu",
                   "astcenc_tpu/ops/refine_pallas.py:689"),
            "K4": ("psearch", "astcenc_torch/csrc/psearch.cu",
                   "astcenc_tpu/ops/psearch_pallas.py:37"),
            "K5": ("refine_round", "astcenc_torch/csrc/refine_round.cu",
                   "astcenc_tpu/ops/refine_pallas.py:184"),
            "K6": ("refine_round2", "astcenc_torch/csrc/refine_round2.cu",
                   "astcenc_tpu/ops/refine_pallas.py:1090"),
            "K7": ("refine_boot2", "astcenc_torch/csrc/refine_round2.cu",
                   "astcenc_tpu/ops/refine_pallas.py:1244"),
            "K9": ("quant_lookup", "astcenc_torch/csrc/quant_lookup.cu",
                   "astcenc_tpu/ops/gather_pallas.py:170")}
    kernels = []
    for kern, (name, src, rep) in meta.items():
        s = stats[kern]
        bms, by = _bound(s["bytes"], s["ops"])
        # K1-K4 count on the LDR main path, K5-K9 on the HDR path.
        n = (launches if kern in ("K1", "K2", "K3", "K4") else launches_h)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": n[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": bms,
                        "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
