"""astcenc_torch decoder: bit-exact against the JAX decoder on random,
valid-mode, error and void-extent blocks, LDR and sRGB, 2D and 3D."""

import numpy as np
import pytest
import torch

from astcenc_tpu import api as japi
from astcenc_tpu.codec import decompress as jdec
from astcenc_torch import api as tapi

torch.set_num_threads(1)


def _blocks(bsd, seed):
    """Random blocks; a third get a valid 1-partition block mode, and a few
    are void-extent (valid and malformed) blocks."""
    rng = np.random.RandomState(seed)
    n = 96
    blk = rng.randint(0, 256, (n, 16)).astype(np.uint8)
    modes = bsd.bm_mode_index[:bsd.block_mode_count_all]
    for i in range(32):
        m = int(rng.choice(modes))
        word = int(blk[i, 0]) | (int(blk[i, 1]) << 8)
        word = (word & ~0x1FFF) | m           # mode bits 0..10, pc bits 11..12 = 0
        blk[i, 0] = word & 0xFF
        blk[i, 1] = word >> 8
    # Void extent: u16 and f16 constant blocks, with and without all-ones
    # coordinates, and one with reserved bits clear (an error block).
    blk[32:40, 0] = 0xFC
    blk[32:36, 1] = 0xFD
    blk[36:40, 1] = 0xFF
    blk[32:34, 2:8] = 0xFF
    blk[36, 2:8] = 0xFF
    blk[39, 1] = 0xF1
    return blk


@pytest.mark.parametrize("profile", [japi.Profile.LDR, japi.Profile.LDR_SRGB])
@pytest.mark.parametrize("dims", [(6, 6, 1), (4, 4, 1), (3, 3, 3)])
def test_decode_bit_exact(profile, dims):
    jcfg = japi.config_init(profile, *dims, japi.Quality.MEDIUM, 0)
    tcfg = tapi.config_init(tapi.Profile(int(profile)), *dims,
                            tapi.Quality.MEDIUM, 0)
    jctx = japi.context_alloc(jcfg)
    tctx = tapi.context_alloc(tcfg, device="cpu")
    blocks = _blocks(jctx.bsd, sum(dims) + int(profile))
    for unorm8 in ((False, True) if dims[2] == 1 else (False,)):
        want = np.asarray(jdec.decompress_symbolic_batch(
            jctx._dtables_key, blocks, int(profile), unorm8))
        got = tapi.decompress_blocks(tctx, blocks, unorm8).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    # The valid-mode blocks must include real decodes, not only errors.
    assert np.isfinite(want[:32]).all(axis=(1, 2)).sum() >= 8


def test_decode_image_matches():
    jcfg = japi.config_init(japi.Profile.LDR, 6, 6, 1, japi.Quality.MEDIUM, 0)
    tcfg = tapi.config_init(tapi.Profile.LDR, 6, 6, 1, tapi.Quality.MEDIUM, 0)
    jctx = japi.context_alloc(jcfg)
    tctx = tapi.context_alloc(tcfg, device="cpu")
    blocks = _blocks(jctx.bsd, 3)[:64]
    for swz in ((0, 1, 2, 3), (2, 1, 0, 3), (0, 3, 6, 5), (4, 5, 1, 0)):
        for out_type in ("u8", "f16", "f32"):
            want = japi.decompress_image(jctx, blocks, 45, 46,
                                         out_type=out_type, swizzle=swz)
            got = tapi.decompress_image(tctx, blocks, 45, 46,
                                        out_type=out_type, swizzle=swz)
            assert got.dtype == want.dtype
            # Values, NaNs in the same places (NaN payloads may differ).
            np.testing.assert_array_equal(got, want)
