"""The HDR path of astcenc_torch end to end on the CPU: a 48x48
``synthetic_hdr_image`` (seed 0, independent alpha) at 6x6 -medium -ch
(profile HDR_RGB_LDR_A, MID preset, nothing overridden) through the port's
api.compress_image, against the JAX package's blocks for the same image.

A JAX HDR -medium encode compiles for several minutes on a CPU, so JAX's
blocks come from a committed fixture, ``tests/data/torch_hdr/
ref_ch_48x48.npz`` (the seed, the shape and the blocks). The tier-1 test
requires at least 90% of the port's blocks identical to the fixture's and
the port's decode within 0.05 dB mPSNR of the fixture's blocks decoded by
the port's decoder. The ``slow`` test rebuilds the fixture with the JAX
package and asserts that it is unchanged:

    JAX_PLATFORMS=cpu python -m pytest --runslow \
        tests/test_torch_hdr_image.py -k rebuild
"""

import os

import numpy as np
import pytest
import torch

from astcenc_torch import api as tapi
from astcenc_torch import testdata
from astcenc_torch.codec import decompress as tdec
from astcenc_torch.utils import metrics

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_hdr", "ref_ch_48x48.npz")
SEED, SIDE = 0, 48


def config(api):
    return api.config_init(api.Profile.HDR_RGB_LDR_A, 6, 6, 1,
                           api.Quality.MEDIUM, 0)


def image():
    return testdata.synthetic_hdr_image(SIDE, SIDE, SEED,
                                        independent_alpha=True)


def jax_blocks():
    """JAX's encode of the fixture image (several minutes on a CPU)."""
    from astcenc_tpu import api as japi
    jctx = japi.context_alloc(config(japi))
    return japi.compress_image(jctx, image())


def test_hdr_image_matches_jax_fixture():
    ref = np.load(FIXTURE)
    assert int(ref["seed"]) == SEED and tuple(ref["shape"]) == (SIDE, SIDE)
    img = image()
    ctx = tapi.context_alloc(config(tapi), device="cpu")
    got = tapi.compress_image(ctx, img)
    want = ref["blocks"]
    assert got.shape == want.shape == ((SIDE // 6) ** 2, 16)
    ident = float((got == want).all(1).mean())
    dg = tapi.decompress_image(ctx, got, SIDE, SIDE, out_type="f32")[0]
    dw = tapi.decompress_image(ctx, want, SIDE, SIDE, out_type="f32")[0]
    src = img.astype(np.float32)
    mg, mw = metrics.mpsnr(dg, src), metrics.mpsnr(dw, src)
    const, pc, planes = tdec.block_types(ctx.torch_decode_tables(),
                                         torch.from_numpy(got))
    print(f"48x48 -ch: {ident:.4f} of blocks identical to JAX; mPSNR "
          f"{mg:.5f} dB, JAX {mw:.5f} dB; blocks: 2-plane "
          f"{int((planes == 2).sum())}, pc2 {int((pc == 2).sum())}, pc3 "
          f"{int((pc == 3).sum())}")
    assert np.isfinite(dg).all()
    assert ident >= 0.9, ident
    assert abs(mg - mw) <= 0.05, (mg, mw)


@pytest.mark.slow
def test_rebuild_fixture_unchanged():
    ref = np.load(FIXTURE)
    np.testing.assert_array_equal(jax_blocks(), ref["blocks"])
