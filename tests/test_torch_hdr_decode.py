"""astcenc_torch decoder and physical pack in the HDR profiles, bit for bit
against the JAX package: random and valid-mode blocks (every endpoint
format, HDR ones decoding through LNS), FP16 and UNORM16 void-extent
blocks, the FP16 constant block packed through ``codec/physical.py``, and
the port's encode of constant HDR images."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astcenc_tpu import api as japi
from astcenc_tpu.codec import compress as jc
from astcenc_tpu.codec import decompress as jdec
from astcenc_tpu.codec import trial as jtrial
from astcenc_tpu.ops import softfloat as jsf
from astcenc_torch import api as tapi
from astcenc_torch.codec import physical as tphys

torch.set_num_threads(1)

PROFILES = [japi.Profile.HDR_RGB_LDR_A, japi.Profile.HDR]


def _ctxs(profile, dims=(6, 6, 1)):
    jctx = japi.context_alloc(japi.config_init(profile, *dims,
                                               japi.Quality.MEDIUM, 0))
    tctx = tapi.context_alloc(tapi.config_init(
        tapi.Profile(int(profile)), *dims, tapi.Quality.MEDIUM, 0),
        device="cpu")
    return jctx, tctx


def _blocks(bsd, seed, n=512):
    """Random blocks; half get a valid block mode of any partition count,
    so their endpoint formats (every one of the 16) decode; some are
    void-extent blocks, FP16 and UNORM16, valid and malformed."""
    rng = np.random.RandomState(seed)
    blk = rng.randint(0, 256, (n, 16)).astype(np.uint8)
    modes = bsd.bm_mode_index[:bsd.block_mode_count_all]
    for i in range(n // 2):
        m = int(rng.choice(modes))
        word = int(blk[i, 0]) | (int(blk[i, 1]) << 8)
        word = (word & ~0x7FF) | m
        blk[i, 0] = word & 0xFF
        blk[i, 1] = word >> 8
    v = n // 2
    blk[v:v + 16, 0] = 0xFC
    blk[v:v + 8, 1] = 0xFF                    # FP16
    blk[v + 8:v + 16, 1] = 0xFD               # UNORM16
    blk[v:v + 12, 2:8] = 0xFF                 # all-ones coordinates
    blk[v + 15, 1] = 0xF1                     # reserved bits clear: error
    return blk


@pytest.mark.parametrize("profile", PROFILES)
def test_decode_hdr_bit_exact(profile):
    jctx, tctx = _ctxs(profile)
    blocks = _blocks(jctx.bsd, int(profile))
    for unorm8 in (False, True):
        want = np.asarray(jdec.decompress_symbolic_batch(
            jctx._dtables_key, blocks, int(profile), unorm8))
        got = tapi.decompress_blocks(tctx, blocks, unorm8).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    # Real decodes among them, HDR (above 1.0) ones included.
    fin = np.isfinite(want).all(axis=(1, 2))
    assert fin[:256].sum() >= 32 and (want[fin] > 1.0).any()
    for out_type in ("f16", "f32"):          # 32 x 16 blocks: all of them
        np.testing.assert_array_equal(
            tapi.decompress_image(tctx, blocks, 192, 96, out_type=out_type),
            japi.decompress_image(jctx, blocks, 192, 96, out_type=out_type))


@pytest.mark.parametrize("profile", PROFILES)
def test_fp16_constant_block_packs_bit_exact(profile):
    jctx, tctx = _ctxs(profile)
    rng = np.random.RandomState(7)
    N = 64
    s = {k: np.array(v) for k, v in jtrial.empty_scb(N, 36).items()}
    s["const_f16"] = np.arange(N) < 48
    s["const_u16"] = ~s["const_f16"]
    # fp16 patterns of finite values, zeros, infinities and NaNs
    col = rng.randint(0, 0x7C00, (N, 4)).astype(np.int32)
    col[:4] = [0, 0x7C00, 0x7E00, 0x8000]
    s["constant_color"] = col
    want = np.asarray(jc._pack_jit(jctx._dtables_key,
                                   {k: jnp.asarray(v) for k, v in s.items()}))
    got = tphys.symbolic_to_physical_batch(
        tctx.torch_decode_tables(),
        {k: torch.from_numpy(v) for k, v in s.items()}).numpy()
    np.testing.assert_array_equal(got, want)
    dec = tapi.decompress_blocks(tctx, got).numpy()
    np.testing.assert_array_equal(
        dec.view(np.uint32),
        np.asarray(jdec.decompress_symbolic_batch(
            jctx._dtables_key, got, int(profile), False)).view(np.uint32))


@pytest.mark.parametrize("profile", PROFILES)
def test_constant_hdr_image_encodes_fp16(profile):
    """Constant blocks of an HDR image become FP16 void-extent blocks whose
    colour is the LNS -> fp16 conversion of the texel (UNORM16 -> fp16 for
    the alpha of profile 2), as the JAX package computes it."""
    _, tctx = _ctxs(profile)
    vals = np.array([[0.0, 1.0, 2.5, 0.25], [1e-3, 300.0, 7.0, 1.0],
                     [65504.0, 0.5, 1e-6, 0.0], [3.0, 3.0, 3.0, 0.75]],
                    np.float16)
    img = np.repeat(np.repeat(vals.reshape(2, 2, 4), 6, 0), 6, 1)
    got = tapi.compress_image(tctx, img)
    assert ((got[:, 0] == 0xFC) & (got[:, 1] == 0xFF)).all()   # FP16 blocks
    dec = tapi.decompress_image(tctx, got, 12, 12, out_type="f32")[0]
    f = jnp.asarray(vals.astype(np.float32))
    lns = jsf.float16_to_float(jsf.lns_to_sf16(
        jsf.float_to_lns(f).astype(jnp.int32)))
    unorm = jsf.float16_to_float(jsf.float_to_float16(
        jnp.asarray(np.fmin(np.fmax(vals.astype(np.float32) * 65535.0, 0.0),
                            65535.0)) / 65535.0))
    want = np.array(lns)
    if int(profile) == 2:
        want[:, 3] = np.asarray(unorm)[:, 3]
    np.testing.assert_array_equal(dec[::6, ::6].reshape(4, 4), want)
