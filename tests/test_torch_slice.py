"""The astcenc_torch slice end to end: a seeded 48x48 image encoded at
6x6 LDR -medium with partition count limit 1 and 2-plane correlation limit
0 through the port's compress_image, against the JAX package's stage-1
passes and finalize pack; decoded PSNR within 0.05 dB, >= 90% identical
blocks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astcenc_tpu import api as japi
from astcenc_tpu.codec import compress as jc
from astcenc_torch import api as tapi
from astcenc_torch import testdata
from astcenc_torch.codec import compress as tc

torch.set_num_threads(1)

SIZE = 48


def _cfg(api):
    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    cfg.tune_partition_count_limit = 1
    cfg.tune_2plane_early_out_limit_correlation = 0.0
    return cfg


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


def test_slice_matches_jax():
    img = testdata.synthetic_image(SIZE, SIZE, 5)
    tctx = tapi.context_alloc(_cfg(tapi), device="cpu")
    got = tapi.compress_image(tctx, img)

    jctx = japi.context_alloc(_cfg(japi))
    ek = japi._enc_key(jctx.bsd)
    cfgs = jc._CfgStatic(jctx.config)
    blocks = tc.image_to_blocks(tctx, img)
    scb, aux = jc._c_stage1_jit(jctx._dtables_key, ek, cfgs,
                                jnp.asarray(blocks))
    # Every block is finished or skipped by the 2-plane gate, so the JAX
    # stages after stage 1 would change nothing.
    assert np.asarray(aux["skip2p"] | scb["finished"]).all()
    want = np.asarray(jc._c_finalize_jit(jctx._dtables_key, ek, cfgs, scb,
                                         aux))
    assert got.shape == want.shape == (64, 16)
    ident = (got == want).all(1).mean()
    assert ident >= 0.9, ident
    dj = japi.decompress_image(jctx, want, SIZE, SIZE)[0]
    dt = tapi.decompress_image(tctx, got, SIZE, SIZE)[0]
    assert abs(_psnr(dt, img) - _psnr(dj, img)) <= 0.05


def test_unported_stages_refused():
    """The port refuses exactly what the JAX package refuses: MAP_RGBM with
    an M scale below 1 raises ConfigError in both when the context is
    made. The four inputs the port once refused, 3D blocks (HDR and LDR),
    per-block alpha weighting and RGBM, now encode to blocks that decode
    to finite texels."""
    for api in (tapi, japi):
        cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM,
                              api.Flags.MAP_RGBM)
        cfg.rgbm_m_scale = 0.5
        with pytest.raises(api.ConfigError):
            api.context_alloc(cfg, **({"device": "cpu"} if api is tapi
                                      else {}))
    img = testdata.synthetic_image(12, 12, 1)
    vol = testdata.synthetic_volume(4, 8, 8, 1)
    for profile, dims, flags, src in (
            (tapi.Profile.HDR, (4, 4, 4), 0, vol.astype(np.float16)),
            (tapi.Profile.LDR, (4, 4, 4), 0, vol),
            (tapi.Profile.LDR, (6, 6, 1), tapi.Flags.USE_ALPHA_WEIGHT, img),
            (tapi.Profile.LDR, (6, 6, 1), tapi.Flags.MAP_RGBM, img)):
        tctx = tapi.context_alloc(tapi.config_init(
            profile, *dims, tapi.Quality.FASTEST, flags), device="cpu")
        blocks = tapi.compress_image(tctx, src)
        assert blocks.shape == (4, 16)
        d = src.shape[0] if src.ndim == 4 else 1
        out = tapi.decompress_image(tctx, blocks, src.shape[-2],
                                    src.shape[-3], d, out_type="f32")
        assert np.isfinite(out).all()