"""The rest of astcenc_torch's public API on the CPU, against the JAX
package: get_error_string, get_block_info, compress_cancel and
compress_reset, and the alpha-scale RDO mask ``_alpha_zero_blocks``.

get_error_string and get_block_info give what the JAX package's functions
give, dict for dict and string for string; ``_alpha_zero_blocks`` gives
JAX's mask bit for bit, a 2048x2048 plane included, where the summed-area
table's rounding decides blocks. compress_cancel and compress_reset are held
to the JAX package's documented behaviour (``astcenc_tpu/api.py:205-222``,
``codec/compress.py:1086-1095``), since a JAX encode compiles for minutes.
"""

import os

import numpy as np
import pytest
import torch

from astcenc_tpu import api as japi
from astcenc_tpu.codec import compress as jc
from astcenc_torch import api as tapi
from astcenc_torch import testdata
from astcenc_torch.codec import compress as tc

torch.set_num_threads(2)

FOOTPRINTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "torch_footprints")


# -- get_error_string -------------------------------------------------------

def _raised(api):
    with pytest.raises(api.ConfigError) as e:
        api.config_init(api.Profile.LDR, 7, 7, 1, api.Quality.MEDIUM, 0)
    return e.value


def test_get_error_string_matches_jax():
    for code in list(range(-3, len(tapi.Error) + 3)) + [255, 1 << 20]:
        assert tapi.get_error_string(code) == japi.get_error_string(code)
    for e in tapi.Error:
        got = tapi.get_error_string(e)
        assert got is not None and got == japi.get_error_string(
            japi.Error(int(e)))
    assert tapi.get_error_string(len(tapi.Error)) is None
    te, je = _raised(tapi), _raised(japi)
    assert int(te.code) == int(je.code) == int(tapi.Error.ERR_BAD_BLOCK_SIZE)
    assert tapi.get_error_string(te) == japi.get_error_string(je) \
        == "ASTCENC_ERR_BAD_BLOCK_SIZE"


# -- get_block_info ---------------------------------------------------------

def _same(a, b, where="info"):
    """a == b with the same types throughout (ints stay ints, floats stay
    floats, None stays None)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _contexts(profile, bx, by):
    def cfg(api):
        return api.config_init(api.Profile(profile), bx, by, 1,
                               api.Quality.MEDIUM, 0)
    return (tapi.context_alloc(cfg(tapi), device="cpu"),
            japi.context_alloc(cfg(japi)))


def _void_extent(hdr, rgba):
    """A constant-colour block: UNORM16 or FP16 ``rgba``."""
    b = np.zeros(16, np.uint8)
    mode = 0x1FC | (0x200 if hdr else 0)
    b[0], b[1] = mode & 0xFF, mode >> 8
    b[2:8] = 0xFF                                  # no extent coordinates
    for i, v in enumerate(rgba):
        b[8 + 2 * i], b[9 + 2 * i] = v & 0xFF, v >> 8
    return b


@pytest.mark.parametrize("name", ["4x4_thorough", "12x12_exhaustive",
                                  "4x4_thorough_ch", "12x12_medium_cH",
                                  "6x6_medium_r2"])
def test_get_block_info_matches_jax(name):
    fx = np.load(os.path.join(FOOTPRINTS, f"{name}.npz"))
    bx, by = (int(v) for v in fx["block"])
    tctx, jctx = _contexts(int(fx["profile"]), bx, by)
    seen = set()
    for blk in fx["blocks"]:
        got = tapi.get_block_info(tctx, blk)
        _same(got, japi.get_block_info(jctx, blk))
        seen.add((got["partition_count"], got["block_is_dual_plane"],
                  got["block_is_hdr"], got["block_is_constant"]))
    print(f"{name}: {len(fx['blocks'])} blocks, (partitions, two planes, "
          f"HDR, constant) seen: {sorted(seen)}")
    if name.endswith(("_ch", "_cH")):
        assert any(s[2] for s in seen)
    if name.endswith("_r2"):
        assert any(s[3] for s in seen)


@pytest.mark.parametrize("profile,fp", [(1, 4), (2, 8), (3, 12)])
def test_get_block_info_random_blocks_match_jax(profile, fp):
    """Seeded random blocks, most with a legal block mode of the footprint
    in bits 0-10: every partition count, one and two planes, endpoint
    formats of every class, and blocks whose colour bits run short."""
    tctx, jctx = _contexts(profile, fp, fp)
    rng = np.random.default_rng(profile * 100 + fp)
    blocks = rng.integers(0, 256, (96, 16), dtype=np.uint8)
    legal = np.nonzero(tctx.bsd.block_mode_packed_index != 0xFFFF)[0]
    mode = rng.choice(legal, 80)
    blocks[:80, 0] = mode & 0xFF
    blocks[:80, 1] = (blocks[:80, 1] & 0xF8) | (mode >> 8)
    seen = set()
    for blk in blocks:
        got = tapi.get_block_info(tctx, blk)
        _same(got, japi.get_block_info(jctx, blk))
        seen.add((got["partition_count"], got["block_is_dual_plane"],
                  "color_endpoints" in got))
    assert {(pc, True) for pc in (1, 2, 3, 4)} <= {
        (pc, e) for pc, _, e in seen}, sorted(seen)
    assert any(dual for _, dual, e in seen if e), sorted(seen)


def test_get_block_info_special_blocks_match_jax():
    """A UNORM16 and an FP16 constant block, a block of a reserved block
    mode and an all-zero block, in an LDR and an HDR context."""
    for profile in (tapi.Profile.LDR, tapi.Profile.HDR):
        tctx, jctx = _contexts(int(profile), 6, 6)
        reserved = int(np.nonzero(
            tctx.bsd.block_mode_packed_index == 0xFFFF)[0][1])
        bad = np.zeros(16, np.uint8)
        bad[0], bad[1] = reserved & 0xFF, reserved >> 8
        blocks = [_void_extent(False, (65535, 1234, 0, 40000)),
                  _void_extent(True, (0x3C00, 0x7BFF, 0x0001, 0x3800)),
                  bad, np.zeros(16, np.uint8)]
        for blk in blocks:
            _same(tapi.get_block_info(tctx, blk),
                  japi.get_block_info(jctx, blk))
        info = tapi.get_block_info(tctx, blocks[1])
        assert info["block_is_constant"] and info["block_is_hdr"]
        assert tapi.get_block_info(tctx, bad)["block_is_error"]


# -- compress_cancel and compress_reset -------------------------------------

def test_compress_cancel_then_whole(monkeypatch):
    """compress_cancel from the progress callback after the first chunk:
    the blocks of the later chunks are zero bytes and the result has the
    whole shape; the next compress_image on the context runs whole, since
    it clears the flag. compress_reset does nothing."""
    img = testdata.synthetic_image(16, 16, 5, independent_alpha=True)
    ctx = tapi.context_alloc(tapi.config_init(
        tapi.Profile.LDR, 4, 4, 1, tapi.Quality.FASTEST, 0), device="cpu")
    whole = tapi.compress_image(ctx, img)
    monkeypatch.setattr(tc, "CHUNK", 6)
    calls = []

    def cancel(pct):
        calls.append(pct)
        tapi.compress_cancel(ctx)

    got = tapi.compress_image(ctx, img, progress_callback=cancel)
    assert calls == [100.0 * 6 / 16]
    assert got.shape == whole.shape == (16, 16)
    np.testing.assert_array_equal(got[:6], whole[:6])
    assert not got[6:].any() and whole[6:].any(1).all()
    assert ctx.cancel_requested
    assert tapi.compress_reset(ctx) is None
    assert ctx.cancel_requested
    calls.clear()
    again = tapi.compress_image(ctx, img, progress_callback=calls.append)
    np.testing.assert_array_equal(again, whole)
    assert len(calls) == 3 and calls[-1] == 100.0
    assert not ctx.cancel_requested


# -- alpha-scale RDO ---------------------------------------------------------

def _mask_pair(alpha, bx, by, r):
    H, W = alpha.shape
    nx, ny = -(-W // bx), -(-H // by)
    return (tc._alpha_zero_blocks(alpha, bx, by, r, nx, ny),
            np.asarray(jc._alpha_zero_blocks(alpha, bx, by, r, nx, ny)))


def _holes(rng, H, W, n):
    """A seeded UNORM16 alpha plane with ``n`` transparent rectangles."""
    a = rng.uniform(0.0, 65535.0, (H, W)).astype(np.float32)
    for _ in range(n):
        y, x = rng.integers(0, H), rng.integers(0, W)
        a[y:y + rng.integers(4, H // 2 + 5), x:x + rng.integers(4, W // 2 + 5)] = 0
    return a


@pytest.mark.parametrize("r", [1, 2, 5])
@pytest.mark.parametrize("bx,by,H,W", [(6, 6, 61, 43), (4, 4, 33, 70),
                                       (12, 10, 50, 131), (5, 4, 16, 16)])
def test_alpha_zero_blocks_matches_jax(r, bx, by, H, W):
    rng = np.random.default_rng(H * W + r)
    got, want = _mask_pair(_holes(rng, H, W, 4), bx, by, r)
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def test_alpha_zero_blocks_near_threshold_matches_jax():
    """Isolated texels whose window average lies within a few float32 steps
    of the threshold 0.9 / (255 * xf * yf), on either side."""
    for r in (1, 2, 5):
        bx = by = 6
        k = 2 * r + 1
        xf = bx + 2 * (r - 1)
        thr = 0.9 / (255.0 * xf * xf) * k * k * 65535.0
        H = W = 24 * (2 * r + 2)
        a = np.zeros((H, W), np.float32)
        ys, xs = np.mgrid[r + 1:H - r - 1:2 * r + 2, r + 1:W - r - 1:2 * r + 2]
        steps = np.arange(ys.size) % 17 - 8
        a[ys.ravel(), xs.ravel()] = np.nextafter(
            np.float32(thr), np.float32(np.inf)) + steps * np.spacing(
                np.float32(thr))
        got, want = _mask_pair(a, bx, by, r)
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < want.size


def test_alpha_zero_blocks_2048_matches_jax():
    """A 2048x2048 plane, where the table's sums reach ~4e6 and their
    rounding decides the blocks inside the holes: an exact (float64) table
    masks other blocks than JAX's float32 one."""
    rng = np.random.default_rng(2048)
    a = _holes(rng, 2048, 2048, 60)
    got, want = _mask_pair(a, 6, 6, 2)
    np.testing.assert_array_equal(got, want)
    exact = _exact_mask(a, 6, 6, 2)
    print(f"2048x2048: {int(want.sum())} of {want.size} blocks masked; the "
          f"float64 table differs on {int((exact != want).sum())}")
    assert want.sum() > 0 and (exact != want).any()


def _exact_mask(alpha, bx, by, r):
    a = alpha.astype(np.float64) / 65535.0
    ap = np.pad(a, ((r, r + 1), (r, r + 1)), mode="edge")
    sat = np.pad(ap.cumsum(0).cumsum(1), ((1, 0), (1, 0)))
    H, W = a.shape
    k = 2 * r + 1
    win = (sat[k:k + H, k:k + W] - sat[k:k + H, :W] - sat[:H, k:k + W]
           + sat[:H, :W])
    has = win / (k * k) > 0.9 / (255.0 * (bx + 2 * r - 2) * (by + 2 * r - 2))
    ny, nx = -(-H // by), -(-W // bx)
    hp = np.pad(has, ((0, ny * by - H), (0, nx * bx - W)))
    return ~hp.reshape(ny, by, nx, bx).any(axis=(1, 3)).reshape(-1)


def test_alpha_scale_refuses_nothing_but_3d():
    """a_scale_radius encodes in 2D (the footprint fixture R holds it to
    JAX's blocks); 3D blocks, which the port once refused, encode too, and
    there the mask is 2D-only (JAX compress.py:1057): the blocks are those
    of the encode without it, though a slab of the volume is transparent."""
    vol = testdata.synthetic_volume(4, 8, 8, 1)
    vol[:, :, :4, 3] = 0
    blocks = []
    for radius in (2, 0):
        cfg = tapi.config_init(tapi.Profile.LDR, 4, 4, 4,
                               tapi.Quality.FASTEST, 0)
        cfg.a_scale_radius = radius
        blocks.append(tapi.compress_image(
            tapi.context_alloc(cfg, device="cpu"), vol))
    assert blocks[0].shape == (4, 16)
    assert np.array_equal(blocks[0], blocks[1])