"""CPU tests of the benchmark's correctness check: the frozen reference
decoder against the port's and against decodes made by the JAX package
(committed files), its metrics against astcenc's, and the check itself
on whole runs at a small size: a sound run is correct; the control and
every planted fault are not. The card-only test runs one short cell.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import faults, harness, readings  # noqa: E402
from benchmark.reference import check  # noqa: E402
from benchmark.reference.astc import decode, tables  # noqa: E402

LDR = "ldr_6x6_medium.rgba1k.c1"
HDR = "hdr_6x6_medium.env1k.c1"

#: Texture sizes for the control and the faults: large enough that each
#: block is smooth against the texture's luminance field, as at the
#: cells' 1024x1024, so that a block moved a third of the texture away
#: (``altered``) and HDR clamped to 1 (the HDR control) read as they do
#: there.
CHECK_SIZE = {LDR: (96, 96), HDR: (144, 144)}


def _small(name, size=(48, 42), set_size=2):
    cell = harness.find_cell(harness.load_benchmark(ROOT), name, ROOT)
    return dataclasses.replace(cell, traffic=dict(
        cell.traffic, sizes=[list(size)], set_size=set_size))


@pytest.fixture(scope="module")
def port_api():
    from astcenc_torch import api
    return api


def _port_blocks(api, profile, img):
    cfg = api.config_init(profile, 6, 6, 1, api.Quality.MEDIUM, 0)
    ctx = api.context_alloc(cfg, device="cpu")
    return ctx, api.compress_image(ctx, img)


@pytest.mark.parametrize("kind", ["ldr", "hdr"])
def test_reference_decoder_equals_the_ports(port_api, kind):
    """The frozen decoder decodes the port's blocks, and a few special
    ones, to the port decoder's texels bit for bit."""
    api = port_api
    from benchmark import texgen
    if kind == "ldr":
        img = texgen.synthetic_image(30, 36, seed=4, independent_alpha=True)
        profile = api.Profile.LDR
    else:
        img = texgen.synthetic_hdr_image(30, 36, seed=4)
        profile = api.Profile.HDR_RGB_LDR_A
    ctx, blocks = _port_blocks(api, profile, img)
    special = np.zeros((3, 16), np.uint8)
    special[0, :2] = (0xFC, 0xFD)        # void extent, UNORM16
    special[0, 8:] = 0x80
    special[1, :2] = (0xFC, 0xFF)        # void extent, FP16
    special[1, 8:] = (0x00, 0x3C) * 4
    special[1, 2:8] = 0xFF
    special[0, 2:8] = 0xFF
    blocks = np.concatenate([blocks, special])   # [2]: reserved, all zero
    t = tables.to_device(tables.build(6, 6), "cpu")
    for u8 in (False, True):
        want = api.decompress_blocks(ctx, blocks, u8)
        got = decode.decompress_symbolic_batch(
            t, torch.from_numpy(blocks), int(profile), u8)
        assert torch.equal(want.view(torch.int32), got.view(torch.int32))


#: Blocks that the JAX package encoded (fixtures of ``tests/data``: 6x6
#: ``-medium`` LDR and ``-ch``, 6x6 ``-thorough`` and ``-exhaustive``, a
#: 4-partition 4x4 set, 8x8 ``-thorough``, 4x4 ``-thorough -ch``, 12x12
#: ``-medium -cH``; each with a void extent of each kind and a reserved
#: block added) and the JAX package's own decode of them
#: (``astcenc_tpu.api.decompress_blocks`` on the CPU; ``.u8`` the 8-bit
#: decode, ``.f32`` the float one; ``.meta`` the block's x, y and the
#: profile). The JAX package was held against astcenc itself, so these
#: witness that the frozen decoder shares no fault with the port it was
#: copied from.
JAX_DECODES = os.path.join(HERE, "testdata", "jax_decodes.npz")


def _jax_cases():
    with np.load(JAX_DECODES) as z:
        return sorted(k.rsplit(".", 1)[0] + ":" + k.rsplit(".", 1)[1]
                      for k in z.files if k.endswith((".u8", ".f32")))


@pytest.mark.parametrize("case", _jax_cases())
def test_reference_decoder_equals_jaxs(case):
    """The frozen decoder decodes JAX-made blocks to the JAX package's
    texels bit for bit."""
    name, kind = case.split(":")
    with np.load(JAX_DECODES) as z:
        bx, by, profile = (int(v) for v in z[name + ".meta"])
        blocks, want = z[name + ".blocks"], z[name + "." + kind]
    t = tables.to_device(tables.build(bx, by), "cpu")
    got = decode.decompress_symbolic_batch(
        t, torch.from_numpy(blocks), profile, kind == "u8").numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_reference_decodes_jaxs_cli_file():
    """The JAX package's CLI encoded a PNG to a 4x4 ``.astc`` file and
    decoded it to a PNG (``tests/data/torch_cli/roundtrip``); the
    reference decodes the file's blocks to the same 8-bit texels."""
    from astcenc_torch.io import image_io
    folder = os.path.join(ROOT, "tests", "data", "torch_cli", "roundtrip")
    with open(os.path.join(folder, "out.astc"), "rb") as fh:
        raw = fh.read()
    assert raw[:4] == bytes((0x13, 0xAB, 0xA1, 0x5C))
    bx, by, bz = raw[4], raw[5], raw[6]
    w, h = (int.from_bytes(raw[7 + 3 * i:10 + 3 * i], "little")
            for i in range(2))
    assert bz == 1
    blocks = np.frombuffer(raw[16:], np.uint8).reshape(-1, 16).copy()
    want = image_io.load_image(os.path.join(folder, "out.png"))[0]
    ref = check.Reference({"profile": "LDR", "block": [bx, by, 1]}, "cpu")
    img, illegal = ref.decode(blocks, h, w)
    assert illegal == 0
    got = np.rint(img.numpy() * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["ldr", "hdr"])
def test_reference_metrics_equal_astcencs(kind):
    """PSNR and mPSNR from the reference's per-block sums equal the port's
    compute_error_metrics (astcenc's CLI metrics)."""
    from astcenc_torch.utils import metrics
    rng = np.random.default_rng(9)
    if kind == "ldr":
        a = rng.integers(0, 256, (30, 40, 4), dtype=np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0,
                    255).astype(np.uint8)
        config = {"profile": "LDR", "block": [6, 6, 1]}
    else:
        a = (2.0 ** rng.uniform(-6, 9, (30, 40, 4))).astype(np.float16)
        a[..., 3] = 1.0
        b = (a.astype(np.float32)
             * rng.uniform(0.9, 1.1, a.shape)).astype(np.float16)
        config = {"profile": "HDR_RGB_LDR_A", "block": [6, 6, 1]}
    ref = check.Reference(config, "cpu")
    img = ref.source(b)
    got = ref.errors(ref.source(a), img)
    want = metrics.compute_error_metrics(a, b, 4, hdr=kind == "hdr")
    key = "mpsnr" if kind == "hdr" else "psnr"
    assert got[key] == pytest.approx(want[key], rel=1e-12)
    assert got["block_err_ratio"] >= got["texture_err_ratio"] > 0


@pytest.mark.parametrize("name", [LDR, HDR])
def test_sound_run_is_correct(name):
    r = harness.run_cell(_small(name), 2**31 + 101, 0.2, False,
                         device="cpu", min_encodes=2, log=lambda m: None)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", [LDR, HDR])
def test_control_is_not_correct(name):
    """The program under the other profile (the configuration's control)
    fails the check on every seed."""
    cell = _small(name, CHECK_SIZE[name])
    rows = readings.readings(cell, [3, 2**31 + 3], 0.1, control=True,
                             device="cpu")
    for row in rows:
        assert not row["correct"], row


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", [LDR, HDR])
def test_planted_fault_is_not_correct(name, fault):
    """A run with the timed path broken underneath (``faults.py``) reads
    correct false."""
    cell = _small(name, CHECK_SIZE[name])
    rows = readings.readings(cell, [2**31 + 7], 0.1, fault=fault,
                             device="cpu")
    assert not rows[0]["correct"], rows[0]


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """One short run of the LDR cell on the card: the result line's keys,
    correct, and the device it names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", LDR, "--seed",
         str(2**31 + 5), "--seconds", "12", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"encode_mtexels_s", "psnr_db", "mse_ppm",
                                   "setup_s"}
