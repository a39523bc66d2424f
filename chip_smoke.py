"""Smoke run of the astcenc_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each or more; any failure raises, so the script exits
non-zero and never prints the last line:

1. device: refuse to run without CUDA; print the card's name and power
   limit as nvidia-smi reports them;
2. build: compile kernels K1 (mode search), K2 (1-plane refinement), K3
   (2-plane refinement), K4 (partition line errors), K5 (one 1-plane HDR
   round), K6 and K7 (one 2-plane HDR round, its bootstrap), K8 (per-row
   table gather), K9 (the colour pack, one launch per pack call, in place
   of the TPU's colour quantizer lookup), the texel-sum kernel (the
   glue's texel sums in the CPU's order; no TPU kernel) and the colour
   decode kernel (one launch per colour endpoint decode; no TPU kernel)
   from astcenc_torch/csrc with nvcc for sm_90a, one nvcc per source,
   started together;
3. kernels: capture the real inputs of every kernel form from a 512x512
   main-path encode (K1 with 1 and 2 planes and 2 and 3 partitions, K2 at
   1-3 partitions, K3, K4 at 2 and 3 partitions, the texel-sum kernel in
   each of its three orders) and hold each kernel against its plain
   PyTorch version on the card (the tolerances of tests/test_pallas.py;
   K4: 99.9% of the line errors within 1e-4 and 99% of the selected seeds
   equal; the texel sums bit for bit), timing both with CUDA events;
   then the inputs of every colour endpoint decode of a 512x512 -ch
   encode (the HDR rounds' calls), each decoded by the colour decode
   kernel and by the plain decode on the card, bit for bit, the largest
   timed both ways;
3b. kernel forms: capture the inputs of each weighted form (per-block
   channel weights, USE_ALPHA_WEIGHT: K2 at 1-3 partitions, K3, K4, K5,
   K6, K7) and RGBM form (K2, K3) from 256x256 encodes at 6x6 -medium -a
   (an image with transparent holes: blocks whose scale is 0), RGBM (an
   RGBM texture with texels whose M is 0) and -ch -a, and hold each
   against its plain version: every output bit for bit (K4: phase 3's
   bounds), a unit scale the static form's outputs bit for bit, the RGBM
   rejections (a decoded M of 0) the plain version's and some at least;
   timed as in phase 3;
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
   rounds at 1-3 partitions, K6, K7; K9 on the first 1-plane pack at 1
   partition, the first matched-format pack at 2 or more partitions and
   the first 2-plane pack), add K9 on the seeded pack batch with its
   corner cases (testdata.pack_batch) at profiles 0 and 3, and hold each
   against its plain version (K5, K6 and K9 bit-exact; K7 within 1e-6),
   with the plain pack's quantizer lookups per call;
8. HDR path: a 2048x2048 synthetic float16 HDR texture (right half with an
   alpha of its own) through api.compress_image at 6x6 -medium -ch (phase
   7's encode was the warm-up); a second encode must be identical and is
   timed too; decoded to float32: encode rate, mPSNR, log-RMSE, block
   counts by kind and by endpoint format, launch counts; then a profiled
   encode of its central 1024x1024 quarter (device ops, idle share);
9. HDR crop: a 256x256 crop of it at -cH through the kernels and through
   the plain versions, >= 99% of blocks identical, HDR alpha present;
10. K8: capture the first realign lookup of a 512x512 main-path encode
    with ASTC_DISABLE_KERNELS=refine, and make a seeded float32 (16384,
    300) table holding NaN payloads, +-Inf, -0.0 and denormals with 200
    indices per row, some out of range, with int32 and with int64 indices;
    hold K8 against its plain version bit for bit and time both and
    torch.gather, with the host time of each step of K8's wrapper;
11. LDR refine-off path: the main-path texture with
    ASTC_DISABLE_KERNELS=refine (the plain refinement, its realign lookups
    on K8 and its packs on K9): encode rate, PSNR, share of blocks
    identical to phase 5's fused encode (>= 90%, PSNR within 0.05 dB),
    launches (K2 and K3 none, K8 some); then a profiled refine-off encode
    of its central 1024x1024 quarter;
12. the same with msearch,refine on the central 1024x1024 quarter,
    against the fused encode of that quarter (K1 none);
13. HDR refine-off path: phase 8's profiled 1024x1024 centre at -ch with
    refine off, against the fused blocks of that profiled encode (mPSNR
    within 0.05 dB, >= 90% identical; K5-K7 none, K8 some); then the same
    encode profiled.

14. JAX's blocks: the images of tests/test_torch_main.py (a 96x96 RGBA8
    and a 48x48 one with an independent alpha, 6x6 -medium) and of
    tests/test_torch_hdr_image.py (48x48 float16 at -ch), encoded on the
    card and on the CPU, against the JAX package's blocks committed as
    NumPy fixtures (tests/data/torch_ldr, tests/data/torch_hdr): at least
    90% of the card's blocks identical and PSNR (mPSNR) within 0.05 dB,
    per image, the CPU port's agreement printed beside; then every
    fixture of tests/data/torch_footprints (each legal 2D footprint at
    -fastest, 4x4/6x6/8x8/12x12 at -fast to -exhaustive, 4x4 -thorough
    -ch, 12x12 -medium -cH and 6x6 -medium with alpha-scale RDO; the
    image remade by testdata.footprint_image from the fixture's kind,
    seed and shape) encoded on the card, with the same gates, the share
    printed per configuration (the CPU port's beside it where the card's
    is below 1); then every fixture of tests/data/torch_features (-a,
    RGBM, the 36 non-finite cases, every 3D footprint; the input remade
    by testdata.feature_image), each on the card and on the CPU: the same
    gates against JAX's blocks and card = CPU 100%;
15. card against CPU (ROADMAP §C3): the glue's summing sites (the
    encoding-choice errors, the ideal fit, k-means at 2 and 3 partitions,
    the 2-plane correlation, the block mean) on the first 4096 blocks of
    the main-path texture, bit for bit on the card and the CPU; and a
    256x256 LDR and a 256x256 -ch image encoded on the card and by the
    CPU port, block by block (share printed, at least 99.9% identical).
16. footprints at full size: 4x4 -medium (HIGH preset row), 8x8 -thorough
    and 12x12 -exhaustive (LOW row: T up to 144, 8 candidates, 4 rounds)
    on the main-path 2048x2048 texture, and 4x4 -thorough -ch on the
    1024x1024 centre of phase 8's HDR texture, each after a warm-up encode
    of a 256x256 crop at its configuration: encode seconds, Mtexels/s,
    PSNR or mPSNR, block counts by (partitions, planes), launches by
    kernel (counts set to 0 just before the encode and read just after),
    the peak of torch.cuda.max_memory_allocated over the encode, and the
    crop (whole blocks at the bottom centre, in the encode's last chunk)
    through the kernels against the plain versions and against the full
    encode's blocks there (>= 99% of blocks identical, each); then a
    profiled 4x4 -medium encode (device busy, idle share, time by kernel).
17. the new inputs at full size: 6x6 -medium -a on the main-path texture,
    6x6 -medium RGBM on a 2048x2048 RGBM texture (testdata.rgbm_image),
    6x6 -medium -ch -a on the 1024x1024 centre of phase 8's HDR texture,
    6x6x6 -medium on a 192^3 RGBA8 volume and 4x4x4 -medium -ch on a
    128^3 float16 volume (testdata.synthetic_volume; 32,768 blocks each),
    each as phase 16's (a warm-up crop of whole blocks at the origin,
    256x256 or 30-32^3, held to the plain versions and to the full
    encode), with the launches of each kernel form.
18. CLI and devices: the main-path texture written as an uncompressed
    .ktx through the port's own KTX writer, then ``cli.main`` in this
    process: ``-cl ... 6x6 -medium -repeats 3`` (launches counted around
    it; its .astc blocks, read back by the port's .astc reader, are phase
    5's ``api.compress_image`` blocks bit for bit), ``-dl`` to .ktx (phase
    5's ``api.decompress_image`` output bit for bit) and ``-tl`` to .exr
    (its printed PSNR phase 5's); phase 8's 1024x1024 HDR centre written
    as .exr, ``-ch ... -repeats 3`` (phase 8's fused blocks of the centre),
    ``-dh`` (the API's decode) and ``-th``; the printed coding times,
    rates and quality lines as one JSON line; ``-dtrace`` on a 256x256
    crop at 6x6 -medium (one block node per block, a pass node of each
    block's own partition count, the blocks the untraced ones; the trace's
    size and host seconds); ``python -m astcenc_torch`` in a subprocess on
    a 64x64 .ktx (exit code 0); and ``parallel.sharding`` over
    [cuda:0, cuda:0] on phase 3's 512x512 image (the single-device blocks
    and decode bit for bit). No -dimage: the card has no Pillow for PNGs.

The fused main paths (phases 5 and 8) must launch K8 no time, as on the
TPU. The lines before the last are the kernel table as JSON (K1-K4
launches counted on the LDR main path, K5-K7 and K9 on the HDR path, K8
on the LDR refine-off path; "redesigned" marks the kernels whose first
port was redesigned for the card: K1-K6, K8, K9), before it the line of
the kernels that replace no TPU kernel ("port_kernels", the same keys:
the texel-sum kernel, launches counted on the LDR main path; the colour
decode kernel, launches counted on the HDR path, none on the LDR main
path) and the nvidia-smi line.
The kernels line also lists each weighted and RGBM form ("refine_asr",
"refine_rgbm", ..., with "form"), timed in phase 3b and its launches
counted on its phase 17 configuration's encode;
the last line is
{"ok": true, "device": {...}}.

Each kernel's ``bound_ms`` is the larger of its bytes (each input tensor
read once, each output written once) over 3.35 TB/s and its float
operations over 67 TFLOP/s (H100 SXM, float32 without tensor cores). The
operation counts are models of the kernels' loops, per texel and weight,
written out in the ``_ops_*`` functions; where the work depends on the
data (lanes that stop refining), they count what the captured inputs need.
K9's operations are a lower bound of the pack's scalar work, per row and
requested format (``_ops_pack``: the first mode tried fits and every
retain-top-bits search stops at its first step). ``library_ms`` is the time
of one PyTorch call computing a kernel's function on the same inputs, where
one exists: ``torch.gather`` for K8 (the clamp and the int64 conversion of
its indices made before the timed call); null for the others, K9 included
(no single PyTorch call computes a colour pack).

A kernel's ``ms`` and ``library_ms`` are device time per call over 10
calls (20 for the texel sums), by CUDA events around calls queued behind
a sleep kernel (``_device_ms``): the kernels, copies and fills one call
launches, the host's time between them left out. ``event_ms`` is the
kernel wrapper's time per call over back-to-back calls by CUDA events,
which holds the wrapper's host time where that exceeds the kernel's.
``plain_ms`` is the plain version's time per call by CUDA events, its
host time included.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import roofline

SIZE = 2048      # side of the main-path texture
CAPTURE = 512    # side of the images whose kernel inputs are captured
CROP = 256       # side of the crops compared with the plain versions
HDR_SIZE = 2048  # side of the HDR path's texture
PEAK = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


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


def _device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of fn over reps calls: CUDA events
    around the calls, queued behind a sleep kernel so that the host has
    queued them all before the device reaches the first. The events then
    see the device's time alone (the kernels, copies and fills one call
    launches, and the device's gaps between them), not the host's time
    between launches. If the device reached the first event before the
    host had queued the last call, the sleep is made longer and the calls
    are queued again."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 25                     # ~20 ms at the H100's clock
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError(f"the host could not queue {reps} calls ahead of "
                       f"the device")


def _host_us(fn, n: int = 2000) -> float:
    """Host microseconds per call of fn over n calls (the device may run
    behind; it is synchronized after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


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
                         {k: _clone(v) for k, v in kw.items()})

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


@contextlib.contextmanager
def _disabled(families: str):
    """ASTC_DISABLE_KERNELS=families inside the block (the kernel switch,
    ``_build.kernel_scope``, reads it once per compress_image call)."""
    old = os.environ.get("ASTC_DISABLE_KERNELS")
    os.environ["ASTC_DISABLE_KERNELS"] = families
    try:
        yield
    finally:
        if old is None:
            del os.environ["ASTC_DISABLE_KERNELS"]
        else:
            os.environ["ASTC_DISABLE_KERNELS"] = old


def _plainly(fn):
    """``fn`` run with every router inside it on its plain version
    (``_build.plain()``)."""
    from astcenc_torch.ops import _build

    def run(*a, **kw):
        with _build.plain():
            return fn(*a, **kw)
    return run


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _bound(nbytes: int, ops: float):
    """``roofline.bound_ms`` at the H100's published peaks, and which of
    bytes and operations bounds it."""
    by_bytes = nbytes * PEAK["f32_ops_s"] >= ops * PEAK["hbm_bytes_s"]
    return (roofline.bound_ms(nbytes, ops, PEAK),
            "bytes" if by_bytes else "operations")


# --- operation models ----------------------------------------------------
# K1: ``roofline.ops_k1``.
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
                     ("K8_ms", "row_gather"),
                     ("K9_ms", "color_pack_kernel")):
        out[tag] = sum(r[0] for r in rows if pat in r[1])
    out["top"] = [[k[:60], round(ms, 3), n] for ms, k, n in rows[:10]]
    return out


#: The launch counters' kernels (``launch.<kernel>``) by the keys printed;
#: their forms (``launch.<kernel>.<form>``) print as "<label> <form>".
_KERNELS = ("msearch", "refine", "refine2", "psearch", "refine_round",
            "refine_round2", "refine_boot2", "row_gather", "color_pack",
            "texel_sum", "color_unpack")
_LABELS = {"refine": "K2", "refine2": "K3", "psearch": "K4",
           "refine_round": "K5", "refine_round2": "K6",
           "refine_boot2": "K7"}


def _reset():
    """Start counting launches (the program's tracing on, its counts
    cleared)."""
    from astcenc_torch import obs
    obs.collect()
    obs.enable()


def _counts():
    """The launches of each kernel since ``_reset``, and of each weighted
    or RGBM form; the program's tracing off again."""
    from astcenc_torch import obs
    c = obs.collect().counters
    obs.disable()
    out = {k: c.get("launch." + k, 0) for k in _KERNELS}
    for key, n in c.items():
        parts = key.split(".")
        if parts[0] == "launch" and len(parts) == 3:
            out[f"{_LABELS.get(parts[1], parts[1])} {parts[2]}"] = n
    return out


def _capture_hdr(refine, cph):
    """Wrap the HDR kernels' dispatchers to record the inputs of the first
    call of each form: K5 bootstrap and K5 rounds by partition count, K6,
    K7, and K9 (the pack): the first 1-plane pack at 1 partition, the
    first matched-format pack (at cqm) of 2 or more partitions, the first
    2-plane pack. Returns (seen, restore)."""
    seen = {}
    orig = {"r1": refine.refine_round_1plane, "r2": refine.refine_round_2plane,
            "pp": refine.pack_partitions, "pk": cph.pack_color_endpoints}
    inside = []                # [pc, pack calls so far] in pack_partitions

    def keep(key, args):
        if key not in seen:
            seen[key] = [_clone(a) for a in args]

    def r1(pt, *args, **kw):
        keep(("K5", "boot" if args[9] == 0 else f"pc{pt.pc}"), (pt,) + args)
        return orig["r1"](pt, *args, **kw)

    def r2(pt, *args, **kw):
        keep(("K7" if args[10] == 0 else "K6", "two"), (pt,) + args)
        return orig["r2"](pt, *args, **kw)

    def pp(pack, cq, cqm, pc):
        inside.append([pc, 0])
        try:
            return orig["pp"](pack, cq, cqm, pc)
        finally:
            inside.pop()

    def pk(profile, *args, **kw):
        if not inside:
            keep(("K9", "two"), (profile,) + args)
        else:
            pc, calls = inside[-1]
            if pc == 1 and calls == 0:
                keep(("K9", "pc1"), (profile,) + args)
            elif pc >= 2 and calls == 1:
                keep(("K9", "cqm"), (profile,) + args)
            inside[-1][1] += 1
        return orig["pk"](profile, *args, **kw)

    refine.refine_round_1plane = r1
    refine.refine_round_2plane = r2
    refine.pack_partitions = pp
    cph.pack_color_endpoints = pk

    def restore():
        refine.refine_round_1plane = orig["r1"]
        refine.refine_round_2plane = orig["r2"]
        refine.pack_partitions = orig["pp"]
        cph.pack_color_endpoints = orig["pk"]
    return seen, restore


# K9, per row, a lower bound of the pack's scalar work for the requested
# format: the first mode tried fits and every retain-top-bits search stops
# at its first step. LDR RGB/RGBA: four trials of quantize, unpack and
# error (90 each); other LDR formats 40; HDR RGB (with either alpha) 110
# (+20 for the HDR alpha); HDR RGB scale 60; HDR luminance 40.
def _ops_pack(profile, req_fmt):
    r = req_fmt.long()
    hdr = profile >= 2
    ops = torch.full_like(r, 40)
    ops[(r == 8) | (r == 12)] = 360
    if hdr:
        ops[(r == 11) | (r == 14)] = 110
        ops[r == 15] = 130
        ops[r == 7] = 60
    return float(ops.sum())


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
    relative where the grids agree; and every output bit for bit (their
    sums run in the plain version's order)."""
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
    diff = sum(int((got[k].view(torch.int32) != w.view(torch.int32)).sum())
               if w.dtype == torch.float32 else int((got[k] != w).sum())
               for k, w in want.items())
    assert diff == 0, f"{tag}: {diff} output values differ"
    return {"identical_grids": frac, "err_rel_max": worst,
            "infill_rel_max": urel, "values_differing": diff}, mae


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


def _capture_sums(ts):
    """Record, per order, the inputs of the largest texel sum (by N T P C)
    that the wrapped router sees (the glue never writes them afterwards, so
    they are kept as they were passed, broadcast views included). Returns
    (seen, restore)."""
    seen = {}
    orig = ts.texel_sum

    def wrap(a, b, order="seq"):
        size = a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        old = seen.get(order)
        if old is None or size > old[0].shape[0] * old[0].shape[1] * \
                old[0].shape[2] * old[1].shape[2]:
            seen[order] = (a, b)      # views kept: broadcasts stay
        return orig(a, b, order)

    ts.texel_sum = wrap

    def restore():
        ts.texel_sum = orig
    return seen, restore


def _capture_unpack(cuq):
    """Record the inputs (profile, fmt, values) of every colour decode
    that the wrapped router sees, cloned. Returns (seen, restore)."""
    seen = []
    orig = cuq.unpack_color_endpoints

    def wrap(profile, fmt, values, *args, **kw):
        seen.append((profile, fmt.clone(), values.clone()))
        return orig(profile, fmt, values, *args, **kw)

    cuq.unpack_color_endpoints = wrap

    def restore():
        cuq.unpack_color_endpoints = orig
    return seen, restore


def _unique_bytes(t) -> int:
    """Bytes a kernel must read of a possibly broadcast view: the elements
    its strides reach."""
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()) if n)
    return min(span, t.numel()) * t.element_size()


def _c3_sites(api, compress_mod, partition_search, img, dev):
    """Phase 15: per output of the glue's summing sites, how many values the
    card computes otherwise than the CPU, on the first 4096 blocks of the
    main-path texture with their (CPU) k-means 2-partitioning as the
    mask."""
    from astcenc_torch.ops import formats, ideal
    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    blk = compress_mod.image_to_blocks(api.context_alloc(cfg, device="cpu"),
                                       img)[:4096]
    cw = (1.0, 1.0, 1.0, 1.0)
    onehot = torch.nn.functional.one_hot(partition_search.kmeans(
        torch.from_numpy(blk), cw, blk.shape[1], 2), 2).float()

    def run(d):
        tex = torch.from_numpy(blk).to(d)
        pmask = onehot.to(d)
        st = compress_mod.make_block_state(tex, 1)
        out = {"block_mean": st["data_mean"],
               "correlation": compress_mod._lowest_correlation(tex, cw),
               "kmeans2": partition_search.kmeans(tex, cw, tex.shape[1],
                                                  2).float(),
               "kmeans3": partition_search.kmeans(tex, cw, tex.shape[1],
                                                  3).float()}
        for cm in ((1, 1, 1, 1), (1, 1, 1, 0)):
            fit = ideal.ideal_colors_and_weights(
                tex, pmask, pmask.sum(1), st["data_min"], st["data_max"], cw,
                cm, omitted_component=None if cm[3] else 3)
            for k in ("weights", "weight_error_scale", "ep0", "ep1"):
                out[f"ideal{sum(cm)}_{k}"] = fit[k]
        lum = st["is_luminance"]
        fit = ideal.ideal_colors_and_weights(
            tex, pmask, pmask.sum(1), st["data_min"], st["data_max"], cw,
            (1, 1, 1, 1))
        eci = formats.encoding_choice_errors(tex, pmask, fit["ep0"],
                                             fit["ep1"], cw, lum, 65535.0)
        for k, v in eci.items():
            out[f"eci_{k}"] = v.float()
        return {k: v.cpu() for k, v in out.items()}

    got, want = run(dev), run("cpu")
    return {k: int((got[k].view(torch.int32) != w.view(torch.int32)).sum())
            for k, w in want.items()}


_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                     "data")


def _jax_fixtures(api, testdata, metrics, dev):
    """Phase 14: per fixture image, the card's and the CPU port's share of
    blocks identical to JAX's, and the decoded quality of the card's blocks
    and of JAX's (decoded by the port)."""
    ldr = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    hdr = api.config_init(api.Profile.HDR_RGB_LDR_A, 6, 6, 1,
                          api.Quality.MEDIUM, 0)
    rows = []
    for name, cfg, path in (
            ("rgba96", ldr, "torch_ldr/ref_medium_rgba96.npz"),
            ("alpha48", ldr, "torch_ldr/ref_medium_alpha48.npz"),
            ("hdr_ch48", hdr, "torch_hdr/ref_ch_48x48.npz")):
        fx = np.load(os.path.join(_DATA, path))
        h, w = (int(v) for v in fx["shape"])
        is_hdr = cfg is hdr
        if is_hdr:
            img = testdata.synthetic_hdr_image(h, w, int(fx["seed"]),
                                               independent_alpha=True)
        else:
            img = testdata.synthetic_image(
                h, w, int(fx["seed"]),
                independent_alpha=bool(fx["independent_alpha"]))
        ctx = api.context_alloc(cfg, device=dev)
        got = api.compress_image(ctx, img)
        cpu = api.compress_image(api.context_alloc(cfg, device="cpu"), img)
        want = fx["blocks"]
        ident = float((got == want).all(1).mean())
        ident_cpu = float((cpu == want).all(1).mean())
        if is_hdr:
            src = img.astype(np.float32)
            qg, qw = (metrics.mpsnr(api.decompress_image(
                ctx, b, w, h, out_type="f32")[0], src) for b in (got, want))
        else:
            qg, qw = (_psnr(api.decompress_image(ctx, b, w, h)[0], img)
                      for b in (got, want))
        assert ident >= 0.9 and abs(qg - qw) <= 0.05, (name, ident, qg, qw)
        rows.append({"image": name, "card_identical": ident,
                     "cpu_identical": ident_cpu,
                     ("mpsnr_db" if is_hdr else "psnr_db"): qg,
                     "jax_db": qw})
    return rows


def _footprint_fixtures(api, testdata, metrics, decompress, dev):
    """Phase 14, footprints: per fixture of tests/data/torch_footprints,
    the card's share of blocks identical to JAX's and the decoded quality
    of the card's blocks and of JAX's (decoded by the port)."""
    folder = os.path.join(_DATA, "torch_footprints")
    rows = []
    for fname in sorted(os.listdir(folder)):
        fx = np.load(os.path.join(folder, fname))
        profile = int(fx["profile"])
        bx, by = (int(v) for v in fx["block"])
        cfg = api.config_init(api.Profile(profile), bx, by, 1,
                              float(fx["quality"]), 0)
        cfg.a_scale_radius = int(fx["a_scale_radius"])
        h, w = (int(v) for v in fx["shape"])
        img = testdata.footprint_image(str(fx["kind"]), h, w,
                                       int(fx["seed"]))
        ctx = api.context_alloc(cfg, device=dev)
        got = api.compress_image(ctx, img)
        want = fx["blocks"]
        assert got.shape == want.shape, (fname, got.shape, want.shape)
        ident = float((got == want).all(1).mean())
        hdr = profile >= int(api.Profile.HDR_RGB_LDR_A)
        if hdr:
            src = img.astype(np.float32)
            qg, qw = (metrics.mpsnr(api.decompress_image(
                ctx, b, w, h, out_type="f32")[0], src) for b in (got, want))
        else:
            qg, qw = (_psnr(api.decompress_image(ctx, b, w, h)[0], img)
                      for b in (got, want))
        row = {"config": str(fx["name"]), "blocks": int(want.shape[0]),
               "card_identical": ident,
               ("mpsnr_db" if hdr else "psnr_db"): qg, "jax_db": qw,
               "kinds": _block_kinds(decompress, ctx, got)}
        # The 4-partition fixture (ROADMAP C6) is held to the CPU port too.
        pc4 = str(fx["name"]).endswith("_pc4")
        if ident < 1.0 or pc4:
            cpu = api.compress_image(api.context_alloc(cfg, device="cpu"),
                                     img)
            row["cpu_identical"] = float((cpu == want).all(1).mean())
            row["card_vs_cpu"] = float((cpu == got).all(1).mean())
        assert ident >= 0.9 and abs(qg - qw) <= 0.05, row
        if pc4:
            assert row["card_vs_cpu"] == 1.0, row
            assert row["kinds"].get("pc4_1plane", 0) > 0, row
        rows.append(row)
    assert len(rows) >= 33, f"{len(rows)} footprint fixtures"
    return rows


def _feature_fixtures(api, testdata, metrics, decompress, dev):
    """Phase 14, features: per fixture of tests/data/torch_features (-a,
    RGBM, non-finite input, 3D), the card's share of blocks identical to
    JAX's and to the CPU port's, and the decoded quality of the card's
    blocks and of JAX's (decoded by the port)."""
    folder = os.path.join(_DATA, "torch_features")
    rows = []
    for fname in sorted(os.listdir(folder)):
        fx = np.load(os.path.join(folder, fname))
        profile = int(fx["profile"])
        cfg = api.config_init(api.Profile(profile), *(int(v) for v in
                                                      fx["block"]),
                              float(fx["quality"]), int(fx["flags"]))
        kind = str(fx["kind"])
        img = testdata.feature_image(kind, fx["shape"], int(fx["seed"]))
        d, h, w = img.shape[:3] if img.ndim == 4 else (1,) + img.shape[:2]
        ctx = api.context_alloc(cfg, device=dev)
        got = api.compress_image(ctx, img)
        cpu = api.compress_image(api.context_alloc(cfg, device="cpu"), img)
        want = fx["blocks"]
        assert got.shape == want.shape, (fname, got.shape, want.shape)
        ident = float((got == want).all(1).mean())
        card_cpu = float((got == cpu).all(1).mean())
        hdr = profile >= int(api.Profile.HDR_RGB_LDR_A)
        src = img if img.ndim == 4 else img[None]
        if kind == "nonfinite":
            src = np.nan_to_num(src, nan=0.5, posinf=0.5, neginf=0.5)
        out = "f32" if hdr or kind == "nonfinite" else "u8"
        dg, dw = (api.decompress_image(ctx, b, w, h, d, out_type=out)
                  for b in (got, want))
        assert np.isfinite(dg).all(), fname
        if hdr:
            qg, qw = (metrics.mpsnr(x, src.astype(np.float32))
                      for x in (dg, dw))
        elif kind == "nonfinite":
            qg, qw = (float(10.0 * np.log10(1.0 / np.mean(
                (x.astype(np.float64) - src) ** 2))) for x in (dg, dw))
        else:
            qg, qw = (_psnr(x, src) for x in (dg, dw))
        row = {"config": str(fx["name"]), "blocks": int(want.shape[0]),
               "card_identical": ident, "card_vs_cpu": card_cpu,
               ("mpsnr_db" if hdr else "psnr_db"): qg, "jax_db": qw,
               "kinds": _block_kinds(decompress, ctx, got)}
        assert ident >= 0.9 and abs(qg - qw) <= 0.05, row
        assert card_cpu == 1.0, row
        rows.append(row)
    assert len(rows) >= 24, f"{len(rows)} feature fixtures"
    return rows


# The weighted (USE_ALPHA_WEIGHT) and RGBM forms of the refinement kernels
# and of K4: (kernel, form) -> (JSON name, base kernel).
FORMS = {("K2", "asr"): "refine_asr", ("K3", "asr"): "refine2_asr",
         ("K4", "asr"): "psearch_asr", ("K5", "asr"): "refine_round_asr",
         ("K6", "asr"): "refine_round2_asr", ("K7", "asr"): "refine_boot2_asr",
         ("K2", "rgbm"): "refine_rgbm", ("K3", "rgbm"): "refine2_rgbm"}


def _capture_forms(api, refine, psearch, ctx, img):
    """The inputs (positional, the cw_scale and rgbm keywords) of the first
    call of each kernel form in an encode of img through the kernels."""
    seen = {}
    wrapped = [
        # The HDR profiles' trials go on to the rounds driver (K5-K7).
        (refine, "trial1_refine", lambda a: None if a[16] >= 2 else (
            "K2", "always" if a[0].kind == "always" else f"pc{a[0].pc}")),
        (refine, "trial2_refine",
         lambda a: None if a[17] >= 2 else ("K3", "two")),
        (refine, "refine_round_1plane", lambda a: (
            "K5", "boot" if a[10] == 0 else f"pc{a[0].pc}")),
        (refine, "refine_round_2plane", lambda a: (
            "K6" if a[11] > 0 else "K7", "two")),
        (psearch, "line_errors", lambda a: ("K4", f"P{a[5]}"))]
    orig = {name: getattr(mod, name) for mod, name, _ in wrapped}

    def wrap(name, key):
        def fn(*a, **kw):
            k = key(a)
            if k is not None and k not in seen:
                seen[k] = ([_clone(x) for x in a],
                           {n: _clone(v) for n, v in kw.items()
                            if n in ("cw_scale", "rgbm")})
            return orig[name](*a, **kw)
        return fn

    for mod, name, key in wrapped:
        setattr(mod, name, wrap(name, key))
    try:
        api.compress_image(ctx, img)
    finally:
        for mod, name, _ in wrapped:
            setattr(mod, name, orig[name])
    return seen


def _form_phase(api, testdata, refine, psearch, dev, seed, at):
    """Phase 3b: each weighted and RGBM form on the inputs a 256x256 encode
    through the kernels hands it (6x6 -medium -a on an image with
    transparent holes, RGBM on an RGBM texture with texels whose M is 0,
    -ch -a on the HDR image), against its plain version: every output bit
    for bit (K4: phase 3's bounds), a unit cw_scale exactly the static
    form's outputs, and the RGBM rejections (a decoded M of 0) the plain
    version's, some at least. Returns per form name the timings, bytes,
    operations and the largest absolute error."""
    runs = (("asr", api.Profile.LDR, api.Flags.USE_ALPHA_WEIGHT,
             testdata.footprint_image("ldr_holes", CROP, CROP, seed + 7)),
            ("rgbm", api.Profile.LDR, api.Flags.MAP_RGBM,
             testdata.rgbm_image(CROP, CROP, seed + 8)),
            ("asr", api.Profile.HDR_RGB_LDR_A, api.Flags.USE_ALPHA_WEIGHT,
             testdata.synthetic_hdr_image(CROP, CROP, seed + 9,
                                          independent_alpha=True)))
    fns = {"K2": (refine.trial1_refine_cuda, refine.trial1_refine_plain),
           "K3": (refine.trial2_refine_cuda, refine.trial2_refine_plain),
           "K5": (refine.refine_round_1plane_cuda,
                  refine.refine_round_1plane_plain),
           "K6": (refine.refine_round_2plane_cuda,
                  refine.refine_round_2plane_plain),
           "K7": (refine.refine_round_2plane_cuda,
                  refine.refine_round_2plane_plain)}
    fns = {k: (c, _plainly(p)) for k, (c, p) in fns.items()}
    stats = {}
    rejected = 0
    for form, profile, flags, img in runs:
        ctx = api.context_alloc(api.config_init(profile, 6, 6, 1,
                                                api.Quality.MEDIUM, flags),
                                device=dev)
        seen = _capture_forms(api, refine, psearch, ctx, img)
        for (kern, part), (a, kw) in sorted(seen.items()):
            if (kern, form) not in FORMS:
                continue
            name = FORMS[(kern, form)]
            if form == "asr":
                assert kw.get("cw_scale") is not None, (kern, part)
            k = a[0].k if kern != "K4" else None
            if kern == "K4":
                cuda_fn = psearch.line_errors_cuda
                plain_fn = psearch.line_errors_plain
                uk, sk = got = cuda_fn(*a, **kw)
                ux, sx = want = plain_fn(*a, **kw)
                within = float(torch.minimum(
                    (uk - ux).abs() <= 1e-4 * ux.abs(),
                    (sk - sx).abs() <= 1e-4 * sx.abs()).float().mean())
                assert within >= 0.999, (name, part, within)
                mae = float(torch.maximum((uk - ux).abs().max(),
                                          (sk - sx).abs().max()))
                unit = cuda_fn(*a, cw_scale=torch.ones_like(kw["cw_scale"]))
                static = cuda_fn(*a)
                same_unit = all(bool((u.view(torch.int32)
                                      == v.view(torch.int32)).all())
                                for u, v in zip(unit, static))
                detail = {"blocks": a[0].shape[0],
                          "candidates": a[2].shape[1],
                          "within_1e-4": within}
                nbytes = (_nbytes(a[0], a[1], a[2], uk, sk, kw["cw_scale"])
                          + a[2].numel() * a[3].shape[1]
                          * a[3].element_size())
                ops = _ops_k4(a)
            else:
                cuda_fn, plain_fn = fns[kern]
                got, want = cuda_fn(*a, **kw), plain_fn(*a, **kw)
                torch.cuda.synchronize()
                diff = sum(int((_bits(got[x]) != _bits(v)).sum())
                           for x, v in want.items())
                assert diff == 0, f"{name} {part}: {diff} values differ"
                mae = 0.0
                blocks = {"K2": lambda: a[8].shape[0],
                          "K3": lambda: a[11].shape[0],
                          "K5": lambda: a[7].shape[0]}.get(
                              kern, lambda: a[1].shape[0] // a[10])()
                ones = torch.ones(blocks, dtype=torch.float32, device=dev)
                static = cuda_fn(*a, rgbm=kw["rgbm"])
                unit = cuda_fn(*a, cw_scale=ones, rgbm=kw["rgbm"])
                same_unit = all(bool((_bits(unit[x]) == _bits(v)).all())
                                for x, v in static.items())
                detail = {"lanes": a[1].shape[0], "values_differing": diff}
                if form == "rgbm":
                    alive = a[4 if kern == "K2" else 5]
                    rej = [int(((r["err_pre"] >= 1e30) & alive).sum())
                           for r in (got, want)]
                    assert rej[0] == rej[1], (name, part, rej)
                    rejected += rej[0]
                    detail["m_zero_rejected_lanes"] = rej[0]
                T = {"K2": 8, "K3": 9, "K5": 7}.get(kern, 9)
                T = a[T].shape[1]
                nbytes = (_nbytes(*[x for x in a[1:] if torch.is_tensor(x)],
                                  k.tap_w, k.tap_i, k.wt_t, k.wt_i, k.wt_n,
                                  k.dm_color, k.pn,
                                  kw.get("cw_scale"))
                          + _nbytes(*got.values()))
                lanes = a[1].shape[0]
                if kern in ("K2", "K3"):
                    ops = _ops_refine(T, a[0].pc, 2 if kern == "K3" else 1,
                                      want["err_pre"], want["err_post"])
                elif kern == "K7":
                    ops = lanes * 16 * T
                else:
                    planes = 2 if kern == "K6" else 1
                    ops = _ops_round(T, planes, lanes,
                                     int(a[4 if kern == "K5" else 5].sum()),
                                     a[10 if kern == "K5" else 11])
            assert same_unit, f"{name} {part}: unit scale differs from static"
            # The static form on the same inputs: no scale, or no RGBM.
            off = ({"rgbm": kw["rgbm"]} if form == "asr" and kern != "K4"
                   else {} if form == "asr"
                   else {"cw_scale": kw.get("cw_scale")})
            static_ms = _device_ms(lambda: cuda_fn(*a, **off), 10)
            ms = _device_ms(lambda: cuda_fn(*a, **kw), 10)
            event_ms = _time_ms(lambda: cuda_fn(*a, **kw), 10)
            plain_ms = _time_ms(lambda: plain_fn(*a, **kw), 2)
            s = stats.setdefault(name, {"ms": 0.0, "event_ms": 0.0,
                                        "plain_ms": 0.0, "static_ms": 0.0,
                                        "bytes": 0, "ops": 0.0,
                                        "max_abs_err": 0.0})
            for x, v in (("ms", ms), ("event_ms", event_ms),
                         ("plain_ms", plain_ms), ("static_ms", static_ms),
                         ("bytes", nbytes), ("ops", ops)):
                s[x] += v
            s["max_abs_err"] = max(s["max_abs_err"], mae)
            bms, by = _bound(nbytes, ops)
            print(f"{at()} kernel forms: {name} {part}: "
                  f"{json.dumps(detail)}, unit scale = static form: "
                  f"{same_unit}; kernel {ms:.4f} ms device ({event_ms:.4f} "
                  f"ms a call by events; the static form {static_ms:.4f} ms "
                  f"device on these inputs), plain {plain_ms:.3f} ms, bound "
                  f"{bms:.4f} ms ({by})", flush=True)
    assert rejected > 0, "no RGBM rejection fired"
    missing = set(FORMS.values()) - set(stats)
    assert not missing, f"forms not captured: {sorted(missing)}"
    return stats


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# Phase 16: (tag, profile, footprint, quality, image): "main" is the
# main-path texture, "hdr" the 1024x1024 centre of phase 8's HDR texture.
FULL_SIZE = (("4x4 -medium", "LDR", 4, "MEDIUM", "main"),
             ("8x8 -thorough", "LDR", 8, "THOROUGH", "main"),
             ("12x12 -exhaustive", "LDR", 12, "EXHAUSTIVE", "main"),
             ("4x4 -thorough -ch", "HDR_RGB_LDR_A", 4, "THOROUGH", "hdr"))


def _full_footprints(api, compress_mod, decompress, metrics, img, img_h,
                     dev, smi, at):
    """Phase 16: the FULL_SIZE configurations through api.compress_image;
    returns the 4x4 -medium context for the profile."""
    ctxs = {}
    for tag, prof, fp, quality, which in FULL_SIZE:
        cfg = api.config_init(getattr(api.Profile, prof), fp, fp, 1,
                              getattr(api.Quality, quality), 0)
        ctx = api.context_alloc(cfg, device=dev)
        ctxs[tag] = ctx
        hdr = which == "hdr"
        if hdr:
            q = img_h.shape[0] // 4
            image = np.ascontiguousarray(img_h[q:3 * q, q:3 * q])
        else:
            image = img
        H, W = image.shape[:2]
        # A crop of whole blocks at the bottom centre, in the last chunk of
        # the encode: its blocks must be the full encode's there.
        side = CROP - CROP % fp
        y0 = (H - side) // fp * fp
        x0 = (W // 2 - side // 2) // fp * fp
        crop = np.ascontiguousarray(image[y0:y0 + side, x0:x0 + side])
        b_k = api.compress_image(ctx, crop)                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        _reset()
        t0 = time.perf_counter()
        blocks = api.compress_image(ctx, image)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated(dev)
        need = (("msearch", "psearch", "refine_round", "refine_round2",
                 "refine_boot2", "color_pack") if hdr
                else ("msearch", "refine", "refine2", "psearch"))
        assert all(launches[k] > 0 for k in need), (tag, launches)
        assert launches["row_gather"] == 0, (tag, launches)
        nx = -(-W // fp)
        n = -(-H // fp) * nx
        assert blocks.shape == (n, 16), (tag, blocks.shape)
        rows = (np.arange(y0 // fp, (y0 + side) // fp)[:, None] * nx
                + np.arange(x0 // fp, (x0 + side) // fp)[None, :]).ravel()
        in_full = float((blocks[rows] == b_k).all(1).mean())
        assert in_full >= 0.99, (tag, "crop vs full encode", in_full)
        out = "f32" if hdr else "u8"
        dec = api.decompress_image(ctx, blocks, W, H, out_type=out)[0]
        assert dec.shape == image.shape and np.isfinite(dec).all(), tag
        if hdr:
            quality_db = metrics.mpsnr(dec, image.astype(np.float32))
        else:
            quality_db = _psnr(dec, image)
        assert quality_db > 20.0, (tag, quality_db)
        kinds = _block_kinds(decompress, ctx, blocks)
        b_p = _plainly(compress_mod.compress_image)(ctx, crop)
        ident = float((b_k == b_p).all(1).mean())
        assert ident >= 0.99, (tag, "crop identical blocks", ident)
        print(f"{at()} full size {tag}: {W}x{H} {'float16' if hdr else 'RGBA8'}"
              f", {n} blocks, encode {enc_s:.3f} s = "
              f"{W * H / enc_s / 1e6:.4f} Mtexels/s, "
              f"{'mPSNR' if hdr else 'PSNR'} {quality_db:.4f} dB, blocks "
              f"{json.dumps(kinds)}, launches {json.dumps(launches)}, "
              f"max_memory_allocated {peak / 2**30:.3f} GiB ({base / 2**30:.3f}"
              f" GiB before), {side}x{side} crop at ({x0}, {y0}) kernels vs "
              f"plain versions {ident:.4f} identical, vs the full encode's "
              f"blocks there {in_full:.4f} | {smi}", flush=True)
    return ctxs["4x4 -medium"]


# Phase 17: (tag, profile, footprint, quality, flag, input): "main" is the
# main-path texture, "rgbm" an RGBM texture of its size, "hdr" the 1024x1024
# centre of phase 8's HDR texture, "volume" a VOLUME^3 RGBA8 volume,
# "volume_hdr" a VOLUME_HDR^3 float16 one.
FULL_FEATURES = (
    ("6x6 -medium -a", "LDR", (6, 6, 1), "MEDIUM", "USE_ALPHA_WEIGHT",
     "main", ("K2 asr", "K3 asr", "K4 asr")),
    ("6x6 -medium RGBM", "LDR", (6, 6, 1), "MEDIUM", "MAP_RGBM", "rgbm",
     ("K2 rgbm", "K3 rgbm")),
    ("6x6 -medium -ch -a", "HDR_RGB_LDR_A", (6, 6, 1), "MEDIUM",
     "USE_ALPHA_WEIGHT", "hdr", ("K5 asr", "K6 asr", "K7 asr")),
    ("6x6x6 -medium", "LDR", (6, 6, 6), "MEDIUM", None, "volume",
     ("msearch", "refine", "psearch")),
    ("4x4x4 -medium -ch", "HDR_RGB_LDR_A", (4, 4, 4), "MEDIUM", None,
     "volume_hdr", ("msearch", "refine_round", "psearch")))
VOLUME = 192      # side of the 6x6x6 volume: 32768 blocks
VOLUME_HDR = 128  # side of the 4x4x4 -ch volume: 32768 blocks
VOLUME_CROP = 32  # side of the 3D warm-up crops


def _full_features(api, compress_mod, decompress, metrics, testdata,
                   img, img_h, dev, seed, smi, at):
    """Phase 17: the FULL_FEATURES configurations through
    api.compress_image, each after a warm-up encode of a crop of whole
    blocks at the origin (256x256, or 32^3 rounded down to whole blocks),
    which is then held to the plain versions and to the full encode's
    blocks there. Returns the launches of each weighted and RGBM form on
    its configuration's encode."""
    q = img_h.shape[0] // 4
    inputs = {
        "main": lambda: img,
        "rgbm": lambda: testdata.rgbm_image(SIZE, SIZE, seed + 10),
        "hdr": lambda: np.ascontiguousarray(img_h[q:3 * q, q:3 * q]),
        "volume": lambda: testdata.synthetic_volume(VOLUME, VOLUME, VOLUME,
                                                    seed + 11),
        "volume_hdr": lambda: testdata.synthetic_volume(
            VOLUME_HDR, VOLUME_HDR, VOLUME_HDR, seed + 12, hdr=True)}
    form_launches = {}
    for tag, prof, fp, quality, flag, which, need in FULL_FEATURES:
        cfg = api.config_init(getattr(api.Profile, prof), *fp,
                              getattr(api.Quality, quality),
                              getattr(api.Flags, flag) if flag else 0)
        ctx = api.context_alloc(cfg, device=dev)
        t0 = time.perf_counter()
        image = inputs[which]()
        make_s = time.perf_counter() - t0
        vol = image.ndim == 4
        bx, by, bz = fp
        side = (VOLUME_CROP if vol else CROP) // bx * bx
        crop = np.ascontiguousarray(image[:side, :side, :side] if vol
                                    else image[:side, :side])
        b_k = api.compress_image(ctx, crop)                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        _reset()
        t0 = time.perf_counter()
        blocks = api.compress_image(ctx, image)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated(dev)
        assert all(launches.get(k, 0) > 0 for k in need), (tag, launches)
        assert launches["row_gather"] == 0, (tag, launches)
        for k in need:
            if " " in k:
                form_launches[k] = launches[k]
        D, H, W = image.shape[:3] if vol else (1,) + image.shape[:2]
        nx, ny, nz = -(-W // bx), -(-H // by), -(-D // bz)
        n = nx * ny * nz
        assert blocks.shape == (n, 16), (tag, blocks.shape)
        c = side // bx
        rows = ((np.arange(c if vol else 1)[:, None, None] * ny
                 + np.arange(c)[None, :, None]) * nx
                + np.arange(c)[None, None, :]).ravel()
        in_full = float((blocks[rows] == b_k).all(1).mean())
        assert in_full >= 0.99, (tag, "crop vs full encode", in_full)
        hdr = prof != "LDR"
        dec = api.decompress_image(ctx, blocks, W, H, D,
                                   out_type="f32" if hdr else "u8")
        src = image if vol else image[None]
        assert dec.shape == src.shape and np.isfinite(dec).all(), tag
        quality_db = (metrics.mpsnr(dec, src.astype(np.float32)) if hdr
                      else _psnr(dec, src))
        assert quality_db > 20.0, (tag, quality_db)
        kinds = _block_kinds(decompress, ctx, blocks)
        b_p = _plainly(compress_mod.compress_image)(ctx, crop)
        ident = float((b_k == b_p).all(1).mean())
        assert ident >= 0.99, (tag, "crop identical blocks", ident)
        texels = D * H * W
        shape = "x".join(str(v) for v in ((D, H, W) if vol else (W, H)))
        print(f"{at()} full size {tag}: {shape} "
              f"{'float16' if hdr else 'RGBA8'} (made in {make_s:.1f} s), "
              f"{n} blocks, encode {enc_s:.3f} s = "
              f"{texels / enc_s / 1e6:.4f} Mtexels/s, "
              f"{'mPSNR' if hdr else 'PSNR'} {quality_db:.4f} dB, blocks "
              f"{json.dumps(kinds)}, launches {json.dumps(launches)}, "
              f"max_memory_allocated {peak / 2**30:.3f} GiB ({base / 2**30:.3f}"
              f" GiB before), {side}^{3 if vol else 2} crop kernels vs plain "
              f"versions {ident:.4f} identical, vs the full encode's blocks "
              f"there {in_full:.4f} | {smi}", flush=True)
    return form_launches


def _cli(cli, argv):
    """``cli.main(argv)`` on the card with its standard output captured:
    (exit code, output)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue()


def _printed(out: str) -> dict:
    """The numbers of the CLI's metric lines ("Coding time", "PSNR
    (LDR-RGBA)", ...), by label."""
    got = {}
    for line in out.splitlines():
        if ":" in line:
            label, rest = line.split(":", 1)
            word = rest.split()
            if word:
                try:
                    got[label.strip()] = float(word[0])
                except ValueError:
                    pass
    return got


def _cli_phase(api, compress_mod, decompress, img, blocks, psnr,
               img_hc, blocks_hc, img_c, ctx, dev, smi, at):
    """Phase 18: the CLI on the main path and the HDR centre, -dtrace, the
    entry point and the sharded encode (see the module docstring)."""
    from astcenc_torch import cli
    from astcenc_torch.codec.trace import parse_trace
    from astcenc_torch.io import astc_file, exr, ktx
    from astcenc_torch.parallel import sharding
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "cli")
    os.makedirs(work, exist_ok=True)

    def path(name):
        return os.path.join(work, name)

    t_phase = time.perf_counter()
    printed = {}
    # LDR: -cl with -repeats 3, -dl, -tl.
    ktx.write_ktx_uncompressed(path("in.ktx"), img[None])
    _reset()
    rc, out = _cli(cli, ["-cl", path("in.ktx"), path("out.astc"), "6x6",
                         "-medium", "-repeats", "3"])
    launches = _counts()
    assert rc == 0, out
    assert all(launches[k] > 0 for k in ("msearch", "refine", "refine2",
                                         "psearch")), launches
    bd, dims, got = astc_file.read_astc(path("out.astc"))
    assert (bd, dims) == ((6, 6, 1), (SIZE, SIZE, 1)), (bd, dims)
    assert np.array_equal(got, blocks), "CLI blocks differ from the API's"
    printed["-cl"] = _printed(out)
    rc, out = _cli(cli, ["-dl", path("out.astc"), path("dec.ktx")])
    assert rc == 0, out
    kind, _, _, dec, _ = ktx.read_ktx(path("dec.ktx"))
    want = api.decompress_image(ctx, blocks, SIZE, SIZE)
    assert kind == "raw" and np.array_equal(dec, want), "-dl output differs"
    rc, out = _cli(cli, ["-tl", path("in.ktx"), path("rt.exr"), "6x6",
                         "-medium"])
    assert rc == 0, out
    printed["-tl"] = _printed(out)
    cli_psnr = printed["-tl"]["PSNR (LDR-RGBA)"]
    assert abs(cli_psnr - psnr) < 1e-4, (cli_psnr, psnr)
    # HDR: phase 8's centre as .exr; -ch with -repeats 3, -dh, -th.
    exr.write_exr(path("in_h.exr"), img_hc, ncomp=4)
    _reset()
    rc, out = _cli(cli, ["-ch", path("in_h.exr"), path("out_h.astc"), "6x6",
                         "-medium", "-repeats", "3"])
    launches_h = _counts()
    assert rc == 0, out
    assert all(launches_h[k] > 0 for k in ("msearch", "psearch",
                                           "refine_round", "refine_round2",
                                           "color_pack")), launches_h
    _, dims_h, got_h = astc_file.read_astc(path("out_h.astc"))
    assert np.array_equal(got_h, blocks_hc), "-ch blocks differ from the API's"
    printed["-ch"] = _printed(out)
    rc, out = _cli(cli, ["-dh", path("out_h.astc"), path("dec_h.exr")])
    assert rc == 0, out
    ctx_h = api.context_alloc(api.config_init(
        api.Profile.HDR_RGB_LDR_A, 6, 6, 1, api.Quality.MEDIUM, 0),
        device=dev)
    h, w = img_hc.shape[:2]
    want_h = api.decompress_image(ctx_h, blocks_hc, w, h, out_type="f32")[0]
    dec_h, _ = exr.read_exr(path("dec_h.exr"))
    assert np.array_equal(dec_h, want_h.astype(np.float16).astype(
        np.float32)), "-dh output differs"
    rc, out = _cli(cli, ["-th", path("in_h.exr"), path("rt_h.exr"), "6x6",
                         "-medium"])
    assert rc == 0, out
    printed["-th"] = _printed(out)
    row = {"ldr": {"-cl -repeats 3": printed["-cl"], "launches": launches,
                   "-tl": printed["-tl"]},
           "hdr": {"-ch -repeats 3": printed["-ch"], "launches": launches_h,
                   "-th": printed["-th"]}}
    print(f"{at()} CLI: {json.dumps(row)} | {smi}", flush=True)
    # -dtrace on a 256x256 crop.
    crop = np.ascontiguousarray(img[:CROP, SIZE // 2 - CROP // 2:
                                    SIZE // 2 + CROP // 2])
    ktx.write_ktx_uncompressed(path("crop.ktx"), crop[None])
    t0 = time.perf_counter()
    rc, out = _cli(cli, ["-cl", path("crop.ktx"), path("crop.astc"), "6x6",
                         "-medium", "-dtrace", path("trace.json"),
                         "-silent"])
    trace_s = time.perf_counter() - t0
    assert rc == 0, out
    _, _, traced = astc_file.read_astc(path("crop.astc"))
    assert np.array_equal(traced, api.compress_image(ctx, crop)), \
        "traced blocks differ from the untraced ones"
    nodes = [c for c in parse_trace(path("trace.json"))[2]
             if c[0] == "block"]
    assert len(nodes) == traced.shape[0], (len(nodes), traced.shape)
    const, pc, _ = (t.cpu().numpy() for t in decompress.block_types(
        ctx.torch_decode_tables(), torch.from_numpy(traced.copy()).to(dev)))
    for i in np.flatnonzero((pc > 1) & ~const).tolist():
        assert any(p[0] == "pass" and p[1].get("partition_count") == pc[i]
                   for p in nodes[i][2]), f"block {i}: no pc {pc[i]} pass"
    t0 = time.perf_counter()
    api.compress_image(ctx, crop)
    untraced_s = time.perf_counter() - t0
    # The entry point in a process of its own.
    small = np.ascontiguousarray(img[:64, :64])
    ktx.write_ktx_uncompressed(path("small.ktx"), small[None])
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "astcenc_torch", "-cl",
                          path("small.ktx"), path("small.astc"), "6x6",
                          "-medium", "-silent"], cwd=root,
                         capture_output=True, text=True, timeout=600)
    main_s = time.perf_counter() - t0
    assert res.returncode == 0, res.stderr[-2000:]
    _, _, small_blocks = astc_file.read_astc(path("small.astc"))
    assert np.array_equal(small_blocks, api.compress_image(ctx, small))
    # The sharded encode and decode over the card listed twice.
    tex = compress_mod.image_to_blocks(ctx, img_c)
    single = api.compress_image(ctx, img_c)
    sharded = sharding.compress_blocks_sharded(ctx, tex, [dev, dev])
    assert np.array_equal(sharded, single), "sharded blocks differ"
    dec_s = sharding.decompress_blocks_sharded(ctx, single, [dev, dev])
    assert np.array_equal(dec_s, api.decompress_blocks(ctx, single)
                          .cpu().numpy()), "sharded decode differs"
    print(f"{at()} CLI -dtrace {CROP}x{CROP} 6x6 -medium: "
          f"{len(nodes)} block nodes, "
          f"{os.path.getsize(path('trace.json'))} bytes, {trace_s:.3f} s "
          f"traced against {untraced_s:.3f} s untraced; python -m "
          f"astcenc_torch on 64x64: exit 0 in {main_s:.1f} s; sharded "
          f"over [cuda:0, cuda:0]: {sharded.shape[0]} blocks equal; phase "
          f"{time.perf_counter() - t_phase:.1f} s | {smi}", flush=True)


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
    from astcenc_torch.ops import color_pack as cp
    from astcenc_torch.ops import color_pack_hdr as cph
    from astcenc_torch.ops import color_unquant as cuq
    from astcenc_torch.ops import texel_sum as ts
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
          f"K5 refine_round.cu, K6 and K7 refine_round2.cu, K8 row_gather.cu, "
          f"K9 color_pack.cu, texel_sum.cu, color_unpack.cu {how}",
          flush=True)

    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    ctx = api.context_alloc(cfg, device=dev)

    # --- 3. kernels vs plain at captured shapes ----------------------------
    img_c = testdata.synthetic_image(CAPTURE, CAPTURE, args.seed + 1,
                                     independent_alpha=True)
    seen, restore = _capture((msearch, refine, psearch))
    sums_seen, restore_ts = _capture_sums(ts)
    try:
        api.compress_image(ctx, img_c)
    finally:
        restore()
        restore_ts()
    want_forms = {("K1", "pc1"), ("K1", "two"), ("K1", "pc2"), ("K1", "pc3"),
                  ("K2", "pc1"), ("K2", "pc2"), ("K2", "pc3"), ("K3", "two"),
                  ("K4", "P2"), ("K4", "P3")}
    assert set(sums_seen) == set(ts._ORDERS), sorted(sums_seen)
    missing = want_forms - set(seen)
    assert not missing, f"forms not captured: {sorted(missing)}"
    stats = {k: {"ms": 0.0, "event_ms": 0.0, "plain_ms": 0.0, "bytes": 0,
                 "ops": 0.0, "max_abs_err": 0.0, "library_ms": None}
             for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9")}

    def account(kern, form, fn, plain_ms, nbytes, ops, mae, detail,
                library_fn=None):
        """Times fn, the kernel's wrapper on this form's inputs, and the
        library call library_fn: device time per call (``_device_ms``),
        and the wrapper's time per call by CUDA events (host included)."""
        ms, event_ms = _device_ms(fn, 10), _time_ms(fn, 10)
        s = stats[kern]
        s["ms"] += ms
        s["event_ms"] += event_ms
        s["plain_ms"] += plain_ms
        s["bytes"] += nbytes
        s["ops"] += ops
        s["max_abs_err"] = max(s["max_abs_err"], mae)
        lib = ""
        if library_fn is not None:
            library_ms = _device_ms(library_fn, 10)
            s["library_ms"] = (s["library_ms"] or 0.0) + library_ms
            lib = f", library {library_ms:.4f} ms device"
        bms, by = _bound(nbytes, ops)
        print(f"kernels: {kern} {form}: {json.dumps(detail)}; kernel "
              f"{ms:.4f} ms device ({event_ms:.4f} ms a call by events), "
              f"plain {plain_ms:.3f} ms{lib}, bound {bms:.4f} ms ({by})",
              flush=True)

    for form in ("pc1", "two", "pc2", "pc3"):
        a, kw = seen[("K1", form)]
        pt = a[0]
        got = msearch.mode_search_cuda(*a, **kw)
        want = msearch.mode_search_plain(*a, **kw)
        torch.cuda.synchronize()
        detail, mae = _check_msearch(got, want)
        k = pt.k
        nbytes = (_nbytes(*a[1:7], *kw.values(), k.taps, k.wlist, k.wt_n,
                          k.wcount, k.maxprec, k.modes, k.unq, k.sin_t,
                          k.cos_t, k.levels_used)
                  + _nbytes(*got.values()))
        detail = {"blocks": a[1].shape[0], "candidates": a[7],
                  "modes": int(k.modes.shape[0]), **detail}
        account("K1", form, lambda: msearch.mode_search_cuda(*a, **kw),
                _time_ms(lambda: msearch.mode_search_plain(*a, **kw), 2),
                nbytes, roofline.ops_k1(pt, *a[1].shape, a[4], a[7],
                                        kw.get("wei2") is not None),
                mae, detail)

    k2_plain = _plainly(refine.trial1_refine_plain)
    for form in ("pc1", "pc2", "pc3"):
        a, _ = seen[("K2", form)]
        pt, texels = a[0], a[8]
        N, C = texels.shape[0], a[12]
        got = refine.trial1_refine_cuda(*a)
        want = k2_plain(*a)
        torch.cuda.synchronize()
        detail, mae = _check_refine(
            f"K2 {form}", _records(got, {"w": (a[1], "wpost")}, N, C),
            _records(want, {"w": (a[1], "wpost")}, N, C))
        k = pt.k
        nbytes = (_nbytes(*a[1:12], k.tap_w, k.tap_i, k.wt_t, k.wt_i, k.wt_n,
                          k.dm_color, k.pn, k.lohi)
                  + _nbytes(*got.values()))
        detail = {"lanes": N * C, "rounds": a[13], **detail}
        account("K2", form, lambda: refine.trial1_refine_cuda(*a),
                _time_ms(lambda: k2_plain(*a), 2),
                nbytes, _ops_refine(texels.shape[1], pt.pc, 1,
                                    want["err_pre"], want["err_post"]),
                mae, detail)

    a, _ = seen[("K3", "two")]
    pt = a[0]
    N, C = a[11].shape[0], a[13]
    got = refine.trial2_refine_cuda(*a)
    k3_plain = _plainly(refine.trial2_refine_plain)
    want = k3_plain(*a)
    torch.cuda.synchronize()
    grids = {"w1": (a[1], "w1post"), "w2": (a[2], "w2post")}
    detail, mae = _check_refine("K3", _records(got, grids, N, C),
                                _records(want, grids, N, C))
    k = pt.k
    nbytes = (_nbytes(*a[1:13], k.tap_w, k.tap_i, k.wt_t, k.wt_i, k.wt_n,
                      k.dm_color, k.pn, k.lohi) + _nbytes(*got.values()))
    account("K3", "two", lambda: refine.trial2_refine_cuda(*a),
            _time_ms(lambda: k3_plain(*a), 2), nbytes,
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
        account("K4", form, lambda: psearch.line_errors_cuda(*a),
                _time_ms(lambda: psearch.line_errors_plain(*a), 2), nbytes,
                _ops_k4(a), mae,
                {"blocks": a[0].shape[0], "candidates": a[2].shape[1],
                 "within_1e-4": within, "err_rel_max": rel,
                 "seeds_equal": seeds,
                 "valid_equal": valid})

    # The texel-sum kernel in each order, on the largest call of the capture
    # encode, bit for bit against its plain version on the card; the
    # library time is the PyTorch call the order reproduces on the CPU.
    ts_stats = {"ms": 0.0, "event_ms": 0.0, "plain_ms": 0.0, "bytes": 0,
                "ops": 0.0, "library_ms": 0.0}
    def library(a, b):
        return torch.einsum("ntp,ntc->npc", a, b)

    for order, (x, y) in sorted(sums_seen.items()):
        got = ts.texel_sum_cuda(x, y, order)
        want = ts.texel_sum_plain(x, y, order)
        torch.cuda.synchronize()
        diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        assert diff == 0, f"texel_sum {order}: {diff} values differ"
        N, T, P = x.shape
        Cn = y.shape[2]
        nbytes = (_unique_bytes(x) + _unique_bytes(y)
                  + got.numel() * got.element_size())
        ms = _device_ms(lambda: ts.texel_sum_cuda(x, y, order), 20)
        event_ms = _time_ms(lambda: ts.texel_sum_cuda(x, y, order), 20)
        plain_ms = _time_ms(lambda: ts.texel_sum_plain(x, y, order), 5)
        lib_ms = _device_ms(lambda: library(x, y), 20)
        ops = 2.0 * N * P * Cn * T
        for k, v in (("ms", ms), ("event_ms", event_ms),
                     ("plain_ms", plain_ms), ("bytes", nbytes), ("ops", ops),
                     ("library_ms", lib_ms)):
            ts_stats[k] += v
        bms, by = _bound(nbytes, ops)
        print(f"kernels: texel_sum {order}: (N, T, P, C) = "
              f"{(N, T, P, Cn)}, 0 values differ; kernel {ms:.4f} ms device "
              f"({event_ms:.4f} ms a call by events), plain {plain_ms:.3f} "
              f"ms, library {lib_ms:.4f} ms device, bound {bms:.5f} ms "
              f"({by})", flush=True)

    # The colour decode kernel on every decode of a 512x512 -ch encode
    # (the HDR rounds' calls), bit for bit against the plain decode on the
    # card; the largest call timed.
    ctx_u = api.context_alloc(api.config_init(
        api.Profile.HDR_RGB_LDR_A, 6, 6, 1, api.Quality.MEDIUM, 0),
        device=dev)
    unpack_seen, restore_u = _capture_unpack(cuq)
    try:
        api.compress_image(ctx_u, testdata.synthetic_hdr_image(
            CAPTURE, CAPTURE, args.seed + 1, independent_alpha=True))
    finally:
        restore_u()
    assert unpack_seen, "no colour decode captured"
    for prof_u, f, v in unpack_seen:
        got = cuq.unpack_color_endpoints(prof_u, f, v)
        want = cuq.unpack_color_endpoints_plain(prof_u, f, v)
        diff = sum(int((g != w).sum()) for g, w in zip(got, want))
        assert diff == 0, f"color_unpack: {diff} values differ"
    prof_u, f, v = max(unpack_seen, key=lambda c: c[1].numel())
    pairs = f.numel()
    fmts_u = {int(k): int(n) for k, n in zip(*torch.unique(
        f, return_counts=True))}
    # Per pair: the format and 8 values read, 2x4 endpoints and 2 flags
    # written.
    nbytes_u = pairs * (4 + 32 + 32 + 2)
    unpack_stats = {
        "calls": len(unpack_seen), "pairs_largest": pairs,
        "ms": _device_ms(lambda: cuq.unpack_color_endpoints(prof_u, f, v),
                         20),
        "event_ms": _time_ms(
            lambda: cuq.unpack_color_endpoints(prof_u, f, v), 20),
        "plain_ms": _time_ms(
            lambda: cuq.unpack_color_endpoints_plain(prof_u, f, v), 5),
        "bytes": nbytes_u}
    bms, by = _bound(nbytes_u, 0.0)
    print(f"kernels: color_unpack: {len(unpack_seen)} decodes of a "
          f"{CAPTURE}x{CAPTURE} -ch encode, 0 values differ; the largest, "
          f"{pairs} pairs at profile {prof_u} ({json.dumps(fmts_u)} by "
          f"format): kernel {unpack_stats['ms']:.4f} ms device "
          f"({unpack_stats['event_ms']:.4f} ms a call by events), plain "
          f"{unpack_stats['plain_ms']:.3f} ms by events, bound "
          f"{bms:.5f} ms ({by})", flush=True)

    # --- 3b. the weighted and RGBM kernel forms vs plain ---------------------
    form_stats = _form_phase(api, testdata, refine, psearch, dev, args.seed,
                             at)

    # --- 4. stage 1 (the earlier slice's configuration) --------------------
    cfg1 = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    cfg1.tune_partition_count_limit = 1
    cfg1.tune_2plane_early_out_limit_correlation = 0.0
    ctx1 = api.context_alloc(cfg1, device=dev)
    img1 = testdata.synthetic_image(CAPTURE, CAPTURE, args.seed + 2)
    _reset()
    t0 = time.perf_counter()
    b1 = api.compress_image(ctx1, img1)
    torch.cuda.synchronize()
    s1 = time.perf_counter() - t0
    n1 = _counts()
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
    _reset()
    t0 = time.perf_counter()
    blocks = api.compress_image(ctx, img)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    launches = _counts()
    ldr_kernels = ("msearch", "refine", "refine2", "psearch")
    assert all(launches[k] > 0 for k in ldr_kernels), launches
    assert launches["row_gather"] == 0, launches
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
    b_p = _plainly(compress_mod.compress_image)(ctx, crop)
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
    seen, restore = _capture_hdr(refine, cph)
    try:
        api.compress_image(ctx_h, testdata.synthetic_hdr_image(
            CAPTURE, CAPTURE, args.seed + 1, independent_alpha=True))
    finally:
        restore()
    want_forms = {("K5", "boot"), ("K5", "pc1"), ("K5", "pc2"), ("K5", "pc3"),
                  ("K6", "two"), ("K7", "two"), ("K9", "pc1"), ("K9", "cqm"),
                  ("K9", "two")}
    missing = want_forms - set(seen)
    assert not missing, f"HDR forms not captured: {sorted(missing)}"

    k5_plain = _plainly(refine.refine_round_1plane_plain)
    k6_plain = _plainly(refine.refine_round_2plane_plain)
    for form in ("boot", "pc1", "pc2", "pc3"):
        a = seen[("K5", form)]
        pt, ncolors = a[0], a[10]
        got = refine.refine_round_1plane_cuda(*a)
        want = k5_plain(*a)
        torch.cuda.synchronize()
        detail, mae = _check_round(f"K5 {form}", got, want, ("grid",))
        k = pt.k
        nbytes = (_nbytes(*a[1:9], k.tap_w, k.tap_i, k.wt_t, k.wt_i, k.wt_n,
                          k.dm_color, k.pn) + _nbytes(*got.values()))
        lanes = a[1].shape[0]
        account("K5", form, lambda: refine.refine_round_1plane_cuda(*a),
                _time_ms(lambda: k5_plain(*a), 2),
                nbytes, _ops_round(a[7].shape[1], 1, lanes,
                                   int(a[4].sum()), ncolors), mae,
                {"lanes": lanes, **detail})

    a = seen[("K6", "two")]
    got = refine.refine_round_2plane_cuda(*a)
    want = k6_plain(*a)
    torch.cuda.synchronize()
    detail, mae = _check_round("K6", got, want, ("grid1", "grid2"))
    k = a[0].k
    lanes = a[1].shape[0]
    account("K6", "two", lambda: refine.refine_round_2plane_cuda(*a),
            _time_ms(lambda: k6_plain(*a), 2),
            _nbytes(*a[1:10], k.tap_w, k.tap_i, k.wt_t, k.wt_i, k.wt_n,
                    k.dm_color, k.pn) + _nbytes(*got.values()),
            _ops_round(a[9].shape[1], 2, lanes, int(a[5].sum()), a[11]), mae,
            {"lanes": lanes, **detail})

    a = seen[("K7", "two")]
    got = refine.refine_round_2plane_cuda(*a)
    want = k6_plain(*a)
    torch.cuda.synchronize()
    urel = max(float(((got[u] - want[u]).abs()
                      / want[u].abs().clamp(min=1e-30)).max())
               for u in ("undec1", "undec2"))
    assert urel <= 1e-6, f"K7 infill rel {urel}"
    k = a[0].k
    lanes, T = a[1].shape[0], a[9].shape[1]
    account("K7", "two", lambda: refine.refine_round_2plane_cuda(*a),
            _time_ms(lambda: k6_plain(*a), 2),
            _nbytes(a[1], a[2], a[3], k.tap_w, k.tap_i)
            + _nbytes(*got.values()), lanes * 16 * T,
            max(float((got[u] - want[u]).abs().max())
                for u in ("undec1", "undec2")),
            {"lanes": lanes, "infill_rel_max": urel})

    for prof_c in (0, 3):
        seen[("K9", f"corners_p{prof_c}")] = [prof_c] + [
            torch.from_numpy(x).to(dev)
            for x in testdata.pack_batch(args.seed + 4, 40000, corners=True)]
    lookups = [0]
    orig_ql = gather.quant_lookup_plain

    def counted_ql(*a, **kw):
        lookups[0] += 1
        return orig_ql(*a, **kw)

    for form in ("pc1", "cqm", "two", "corners_p0", "corners_p3"):
        prof_k, *a = seen[("K9", form)]
        a = cp.pack_args(*a)
        got = cp.pack_cuda(prof_k, *a)
        gather.quant_lookup_plain = counted_ql
        lookups[0] = 0
        try:
            want = cph.pack_color_endpoints_plain(prof_k, *a)
        finally:
            gather.quant_lookup_plain = orig_ql
        torch.cuda.synchronize()
        same = bool((got[0] == want[0]).all() and (got[1] == want[1]).all())
        assert same, f"K9 {form} differs from the plain pack"
        rows_k = a[0].shape[0]
        nbytes = (_nbytes(*a[:3], a[4], a[5], *got) + 2 * 17 * 256 * 4
                  + (_nbytes(a[3]) if prof_k >= 2 else 0))
        account("K9", form, lambda: cp.pack_cuda(prof_k, *a),
                _time_ms(lambda: cph.pack_color_endpoints_plain(prof_k, *a),
                         2),
                nbytes, _ops_pack(prof_k, a[4]), 0.0,
                {"rows": rows_k, "profile": prof_k, "bit_exact": True,
                 "plain_lookups_per_call": lookups[0],
                 "formats": {int(k): int(v) for k, v in zip(*torch.unique(
                     a[4], return_counts=True))}})

    # --- 8. the HDR path ----------------------------------------------------
    img_h = testdata.synthetic_hdr_image(HDR_SIZE, HDR_SIZE, args.seed,
                                         independent_alpha=True)
    src_h = img_h.astype(np.float32)
    # Phase 7's encode at this configuration was the warm-up.
    _reset()
    t0 = time.perf_counter()
    blocks_h = api.compress_image(ctx_h, img_h)
    torch.cuda.synchronize()
    enc_h = time.perf_counter() - t0
    launches_h = _counts()
    hdr_kernels = ("msearch", "psearch", "refine_round", "refine_round2",
                   "refine_boot2", "color_pack")
    assert all(launches_h[k] > 0 for k in hdr_kernels), launches_h
    assert launches_h["row_gather"] == 0, launches_h
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
    # Profiled on the central quarter (both halves of the alpha), whose
    # fused blocks phase 13 compares with. (The whole texture's profile,
    # PR 3-6, took 80-90 s of this script's time, mostly the profiler's own
    # processing.)
    q = HDR_SIZE // 4
    img_p = np.ascontiguousarray(img_h[q:3 * q, q:3 * q])
    held = []                  # the fused blocks of the centre, for phase 13
    prof_h = _profile(lambda: held.append(api.compress_image(ctx_h, img_p)))
    print(f"{at()} HDR profile ({2 * q}x{2 * q} centre): "
          f"{json.dumps(prof_h)} | {smi}", flush=True)

    # --- 9. HDR crop at -cH: kernels against plain versions -----------------
    ctx_hh = api.context_alloc(api.config_init(
        api.Profile.HDR, 6, 6, 1, api.Quality.MEDIUM, 0), device=dev)
    crop_h = np.ascontiguousarray(
        img_h[:CROP, HDR_SIZE // 2 - CROP // 2:HDR_SIZE // 2 + CROP // 2])
    b_k = api.compress_image(ctx_hh, crop_h)
    b_p = _plainly(compress_mod.compress_image)(ctx_hh, crop_h)
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

    # --- 10. K8 vs plain: a realign lookup and a table of float32 specials -
    first = []
    orig_rl = gather.row_lookup

    def rl(rows, idx, *a, **kw):
        if not first:
            first.append((rows.clone(), idx.clone()))
        return orig_rl(rows, idx, *a, **kw)

    gather.row_lookup = rl
    try:
        with _disabled("refine"):
            api.compress_image(ctx, img_c)
    finally:
        gather.row_lookup = orig_rl
    assert first, "no realign lookup captured"
    rng = np.random.RandomState(args.seed + 3)
    tab = (rng.standard_normal((16384, 300)) * 1e3).astype(np.float32)
    flat = tab.reshape(-1).view(np.uint32)
    flat[rng.choice(flat.size, 8000, replace=False)] = np.tile(np.array(
        [0x7FC00000, 0xFFC12345, 0x7F800001, 0x7FBFFFFF, 0x7F800000,
         0xFF800000, 0x80000000, 0x00000001, 0x807FFFFF, 0x00400000],
        np.uint32), 800)
    ridx = rng.randint(-20, 320, (16384, 200)).astype(np.int32)
    tab_d, ridx_d = torch.from_numpy(tab).to(dev), torch.from_numpy(ridx).to(dev)
    forms = {"realign": first[0], "f32": (tab_d, ridx_d),
             "f32_i64": (tab_d, ridx_d.long())}
    for form, (rows, idx) in forms.items():
        got = gather.row_lookup_cuda(rows, idx)
        want = gather.row_lookup_plain(rows, idx)
        B, K = idx.shape[0], idx.shape[-1]
        V = rows.shape[1]
        C = rows.shape[2] if rows.dim() == 3 else 1
        ie = idx.clamp(0, V - 1).long()
        if C > 1:
            ie = ie[..., None].expand(-1, -1, C)
        torch.cuda.synchronize()
        same = bool((got.view(torch.int32) == want.view(torch.int32)).all())
        assert same, f"K8 {form} differs"
        lib = torch.gather(rows, 1, ie)
        assert bool((lib.view(torch.int32) == want.view(torch.int32)).all())
        account("K8", form, lambda: gather.row_lookup_cuda(rows, idx),
                _time_ms(lambda: gather.row_lookup_plain(rows, idx), 20),
                _nbytes(rows, idx, got), 2.0 * B * K, 0.0,
                {"rows": B, "entries": V, "indices": K, "words": C,
                 "dtype": str(rows.dtype), "bit_exact": True},
                library_fn=lambda: torch.gather(rows, 1, ie))

    # Host time of each step of K8's wrapper, on the realign form: the
    # allocation (as the wrapper makes it, and as torch.empty would), the
    # stream handle (raw, and through a torch.cuda.Stream), the ctypes call
    # without a launch (no rows) and with it.
    rows, idx = first[0]
    V, C = rows.shape[1], rows.shape[2]
    shape = idx.shape + (C,)
    out = rows.new_empty(shape)
    ie = idx.clamp(0, V - 1).long()[..., None].expand(-1, -1, C)
    fn, sh = gather._row_fn, _build.stream(dev.index)

    def call(B):
        return fn(rows.data_ptr(), idx.data_ptr(), False, B, V, idx.shape[1],
                  C, out.data_ptr(), sh)

    steps = {
        "row_lookup": lambda: gather.row_lookup(rows, idx),
        "row_lookup_cuda": lambda: gather.row_lookup_cuda(rows, idx),
        "torch.gather": lambda: torch.gather(rows, 1, ie),
        "rows.new_empty": lambda: rows.new_empty(shape),
        "torch.empty": lambda: torch.empty(shape, dtype=rows.dtype,
                                           device=dev),
        "_build.stream (raw handle)": lambda: _build.stream(dev.index),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes call, no launch": lambda: call(0),
        "ctypes call and launch": lambda: call(idx.shape[0])}
    print(f"{at()} K8 host us per call: "
          f"{json.dumps({k: round(_host_us(f), 3) for k, f in steps.items()})}",
          flush=True)

    # --- 11. the LDR refine-off path ------------------------------------
    _reset()
    t0 = time.perf_counter()
    with _disabled("refine"):
        blocks_r = api.compress_image(ctx, img)
    torch.cuda.synchronize()
    enc_r = time.perf_counter() - t0
    launches_r = _counts()
    assert launches_r["refine"] == 0 and launches_r["refine2"] == 0, \
        launches_r
    for k in ("msearch", "psearch", "row_gather", "color_pack"):
        assert launches_r[k] > 0, launches_r
    dec_r = api.decompress_image(ctx, blocks_r, SIZE, SIZE)[0]
    assert dec_r.shape == img.shape and np.isfinite(dec_r).all()
    psnr_r = _psnr(dec_r, img)
    ident_r = float((blocks_r == blocks).all(1).mean())
    assert ident_r >= 0.9 and abs(psnr_r - psnr) <= 0.05, (ident_r, psnr_r)
    print(f"{at()} LDR refine-off path (ASTC_DISABLE_KERNELS=refine): "
          f"{SIZE}x{SIZE}, encode {enc_r:.3f} s = "
          f"{SIZE * SIZE / enc_r / 1e6:.4f} Mtexels/s, PSNR {psnr_r:.4f} dB "
          f"(fused {psnr:.4f}), {ident_r:.6f} of blocks identical to the "
          f"fused encode, launches {json.dumps(launches_r)} | {smi}",
          flush=True)
    q = SIZE // 4
    img_q = np.ascontiguousarray(img[q:3 * q, q:3 * q])
    with _disabled("refine"):
        prof_r = _profile(lambda: api.compress_image(ctx, img_q))
    print(f"{at()} LDR refine-off profile ({2 * q}x{2 * q} centre): "
          f"{json.dumps(prof_r)} | {smi}", flush=True)

    # --- 12. msearch,refine off on the central quarter -------------------
    fused_q = api.compress_image(ctx, img_q)
    _reset()
    t0 = time.perf_counter()
    with _disabled("msearch,refine"):
        blocks_q = api.compress_image(ctx, img_q)
    torch.cuda.synchronize()
    enc_q = time.perf_counter() - t0
    launches_q = _counts()
    assert all(launches_q[k] == 0 for k in ("msearch", "refine", "refine2")), \
        launches_q
    assert launches_q["row_gather"] > 0, launches_q
    dq = [api.decompress_image(ctx, b, 2 * q, 2 * q)[0]
          for b in (blocks_q, fused_q)]
    psnr_q, psnr_qf = _psnr(dq[0], img_q), _psnr(dq[1], img_q)
    ident_q = float((blocks_q == fused_q).all(1).mean())
    assert ident_q >= 0.9 and abs(psnr_q - psnr_qf) <= 0.05, (ident_q, psnr_q)
    print(f"{at()} LDR msearch,refine-off path: {2 * q}x{2 * q} centre, "
          f"encode {enc_q:.3f} s = {4 * q * q / enc_q / 1e6:.4f} Mtexels/s, "
          f"PSNR {psnr_q:.4f} dB (fused {psnr_qf:.4f}), {ident_q:.6f} of "
          f"blocks identical to the fused encode, launches "
          f"{json.dumps(launches_q)} | {smi}", flush=True)

    # --- 13. the HDR refine-off path on phase 8's profiled centre --------
    q = HDR_SIZE // 4
    _reset()
    t0 = time.perf_counter()
    with _disabled("refine"):
        blocks_hr = api.compress_image(ctx_h, img_p)
    torch.cuda.synchronize()
    enc_hr = time.perf_counter() - t0
    launches_hr = _counts()
    assert all(launches_hr[k] == 0 for k in
               ("refine_round", "refine_round2", "refine_boot2")), launches_hr
    assert launches_hr["row_gather"] > 0, launches_hr
    src_p = img_p.astype(np.float32)
    dh = [api.decompress_image(ctx_h, b, 2 * q, 2 * q, out_type="f32")[0]
          for b in (blocks_hr, held[0])]
    assert np.isfinite(dh[0]).all()
    mp_r, mp_f = metrics.mpsnr(dh[0], src_p), metrics.mpsnr(dh[1], src_p)
    ident_h = float((blocks_hr == held[0]).all(1).mean())
    assert ident_h >= 0.9 and abs(mp_r - mp_f) <= 0.05, (ident_h, mp_r)
    print(f"{at()} HDR refine-off path: {2 * q}x{2 * q} centre at -ch, encode "
          f"{enc_hr:.3f} s = {4 * q * q / enc_hr / 1e6:.4f} Mtexels/s, mPSNR "
          f"{mp_r:.4f} dB (fused {mp_f:.4f}), {ident_h:.6f} of blocks "
          f"identical to the fused encode, launches "
          f"{json.dumps(launches_hr)} | {smi}", flush=True)
    with _disabled("refine"):
        prof_hr = _profile(lambda: api.compress_image(ctx_h, img_p))
    print(f"{at()} HDR refine-off profile ({2 * q}x{2 * q} centre): "
          f"{json.dumps(prof_hr)} | {smi}", flush=True)

    # --- 14. the card's blocks against JAX's -------------------------------
    for row in _jax_fixtures(api, testdata, metrics, dev):
        print(f"{at()} JAX blocks: {json.dumps(row)} | {smi}", flush=True)
    rows = _footprint_fixtures(api, testdata, metrics, decompress, dev)
    for row in rows:
        print(f"{at()} JAX blocks, footprints: {json.dumps(row)}",
              flush=True)
    print(f"{at()} JAX blocks, footprints: {len(rows)} configurations, "
          f"card identical {min(r['card_identical'] for r in rows):.4f} at "
          f"least | {smi}", flush=True)
    rows = _feature_fixtures(api, testdata, metrics, decompress, dev)
    for row in rows:
        print(f"{at()} JAX blocks, features: {json.dumps(row)}", flush=True)
    print(f"{at()} JAX blocks, features: {len(rows)} configurations, card "
          f"identical {min(r['card_identical'] for r in rows):.4f} at least, "
          f"card vs CPU {min(r['card_vs_cpu'] for r in rows):.4f} at least "
          f"| {smi}", flush=True)

    # --- 15. card against CPU: the summing sites and two 256x256 encodes -----
    sites = _c3_sites(api, compress_mod, partition_search, img, dev)
    print(f"{at()} C3 sites, card vs CPU (values that differ): "
          f"{json.dumps(sites)}", flush=True)
    assert not any(sites.values()), sites
    for tag, c3_img, c3_cfg in (
            ("LDR", testdata.synthetic_image(CROP, CROP, args.seed + 5,
                                             independent_alpha=True), cfg),
            ("-ch", testdata.synthetic_hdr_image(
                CROP, CROP, args.seed + 5, independent_alpha=True), cfg_h)):
        got = api.compress_image(api.context_alloc(c3_cfg, device=dev),
                                 c3_img)
        want = api.compress_image(api.context_alloc(c3_cfg, device="cpu"),
                                  c3_img)
        same = (got == want).all(1)
        print(f"{at()} C3 {tag} {CROP}x{CROP}: {float(same.mean()):.6f} of "
              f"{same.size} blocks identical card vs CPU; differing blocks "
              f"{np.flatnonzero(~same).tolist()}", flush=True)
        assert same.mean() >= 0.999, (tag, float(same.mean()))

    # --- 16. footprints at full size --------------------------------------
    ctx4 = _full_footprints(api, compress_mod, decompress, metrics, img,
                            img_h, dev, smi, at)
    prof4 = _profile(lambda: api.compress_image(ctx4, img))
    print(f"{at()} profile 4x4 -medium ({SIZE}x{SIZE}): {json.dumps(prof4)}"
          f" | {smi}", flush=True)

    # --- 17. the new inputs at full size ----------------------------------
    form_launches = _full_features(api, compress_mod, decompress, metrics,
                                   testdata, img, img_h, dev,
                                   args.seed, smi, at)

    # --- 18. CLI and devices ---------------------------------------------
    _cli_phase(api, compress_mod, decompress, img, blocks, psnr,
               img_p, held[0], img_c, ctx, dev, smi, at)

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
            "K8": ("row_gather", "astcenc_torch/csrc/row_gather.cu",
                   "astcenc_tpu/ops/gather_pallas.py:120"),
            "K9": ("color_pack", "astcenc_torch/csrc/color_pack.cu",
                   "astcenc_tpu/ops/gather_pallas.py:170")}
    redesigned = ("K1", "K2", "K3", "K4", "K5", "K6", "K8", "K9")
    kernels = []
    for kern, (name, src, rep) in meta.items():
        s = stats[kern]
        bms, by = _bound(s["bytes"], s["ops"])
        # K1-K4 count on the LDR main path, K5-K7 and K9 on the HDR path,
        # K8 on the LDR refine-off path.
        n = (launches if kern in ("K1", "K2", "K3", "K4")
             else launches_r if kern == "K8" else launches_h)
        assert n[name] > 0, f"{kern} was not launched on its path"
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": n[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "event_ms": s["event_ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": bms,
                        "bound_by": by, "library_ms": s["library_ms"],
                        "redesigned": kern in redesigned})
    # The weighted and RGBM forms: launches on their phase 17
    # configuration's encode.
    for (kern, form), fname in FORMS.items():
        name, src, rep = meta[kern]
        s = form_stats[fname]
        bms, by = _bound(s["bytes"], s["ops"])
        n = form_launches[f"{kern} {form}"]
        assert n > 0, f"{fname} was not launched on its path"
        kernels.append({"name": fname, "form": form, "route": "cuda",
                        "source": src, "replaces": rep, "launches": n,
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "event_ms": s["event_ms"],
                        "static_ms": s["static_ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": bms,
                        "bound_by": by, "library_ms": None,
                        "redesigned": False})
    assert launches["texel_sum"] > 0, "texel_sum was not launched"
    bms, by = _bound(ts_stats["bytes"], ts_stats["ops"])
    ts_line = {
        "name": "texel_sum", "route": "cuda",
        "source": "astcenc_torch/csrc/texel_sum.cu", "replaces": None,
        "launches": launches["texel_sum"], "max_abs_err": 0.0,
        "ms": ts_stats["ms"], "event_ms": ts_stats["event_ms"],
        "plain_ms": ts_stats["plain_ms"],
        "bound_ms": bms, "bound_by": by,
        "library_ms": ts_stats["library_ms"]}
    # The colour decode: launches on the HDR path (phase 8), none on the
    # LDR main path.
    assert launches_h["color_unpack"] > 0, "color_unpack was not launched"
    assert launches["color_unpack"] == 0, launches
    bms, by = _bound(unpack_stats["bytes"], 0.0)
    cu_line = {
        "name": "color_unpack", "route": "cuda",
        "source": "astcenc_torch/csrc/color_unpack.cu", "replaces": None,
        "launches": launches_h["color_unpack"], "max_abs_err": 0.0,
        "ms": unpack_stats["ms"], "event_ms": unpack_stats["event_ms"],
        "plain_ms": unpack_stats["plain_ms"], "bound_ms": bms, "bound_by": by, "library_ms": None}
    print(json.dumps({"port_kernels": [ts_line, cu_line]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
