"""astcenc_torch physical block pack: bit-exact against the JAX pack on
symbolic blocks from a JAX stage-1 encode, and a round trip through the
port's decoder."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astcenc_tpu import api as japi
from astcenc_tpu.codec import compress as jc
from astcenc_tpu.codec import decompress as jdec
from astcenc_torch import api as tapi
from astcenc_torch.codec import physical as tphys

torch.set_num_threads(1)


def _configs(api):
    cfg = api.config_init(api.Profile.LDR, 4, 4, 1, api.Quality.FASTEST, 0)
    cfg.tune_partition_count_limit = 1
    cfg.tune_2plane_early_out_limit_correlation = 0.0
    return cfg


@pytest.fixture(scope="module")
def stage1():
    """Symbolic blocks from the JAX stage-1 passes, prepared for packing
    as the JAX _finalize_pack prepares them."""
    jctx = japi.context_alloc(_configs(japi))
    ek = japi._enc_key(jctx.bsd)
    cfgs = jc._CfgStatic(jctx.config)
    rng = np.random.RandomState(5)
    N, T = 64, 16
    tex = np.floor(rng.rand(N, T, 4) * 255.0).astype(np.float32) * 257.0
    tex[:8] = tex[:8, :1]                        # constant blocks
    tex[8:24, :, 3] = 65535.0                    # opaque blocks
    tex[24:32, :, 1:3] = tex[24:32, :, :1]       # gray blocks
    scb, aux = jc._c_stage1_jit(jctx._dtables_key, ek, cfgs, jnp.asarray(tex))
    s = dict(scb)
    is_const = aux["is_const"]
    err = s["block_type_error"]
    s["const_u16"] = is_const | (err & ~is_const)
    s["const_f16"] = jnp.zeros((N,), bool)
    s["constant_color"] = aux["const_color"]
    s["block_mode"] = jnp.where(err, int(ek.tables.m1_mode_index[0]),
                                s["block_mode"])
    s["quant_mode"] = jnp.where(err, 4, s["quant_mode"])
    s["partition_count"] = jnp.where(err, 1, s["partition_count"])
    want = np.asarray(jc._pack_jit(jctx._dtables_key, s))
    return jctx, {k: np.array(v) for k, v in s.items()}, want


def test_pack_bit_exact(stage1):
    jctx, scb, want = stage1
    tctx = tapi.context_alloc(_configs(tapi), device="cpu")
    got = tphys.symbolic_to_physical_batch(
        tctx.torch_decode_tables(),
        {k: torch.from_numpy(v) for k, v in scb.items()}).numpy()
    np.testing.assert_array_equal(got, want)
    # The batch holds real encodings as well as constant blocks.
    assert (~scb["block_type_error"]).sum() >= 32


def test_pack_roundtrip_decode(stage1):
    jctx, scb, want = stage1
    tctx = tapi.context_alloc(_configs(tapi), device="cpu")
    scb = dict(scb)
    scb.pop("const_u16")                         # pack without overrides
    got = tphys.symbolic_to_physical_batch(
        tctx.torch_decode_tables(),
        {k: torch.from_numpy(v) for k, v in scb.items()})
    dec_t = tapi.decompress_blocks(tctx, got).numpy()
    dec_j = np.asarray(jdec.decompress_symbolic_batch(
        jctx._dtables_key, got.numpy(), 1, False))
    np.testing.assert_array_equal(dec_t.view(np.uint32),
                                  dec_j.view(np.uint32))
    ok = ~scb["block_type_error"]
    assert np.isfinite(dec_t[ok]).all()


def test_pack_full_path_bit_exact():
    """Symbolic blocks of JAX's full 6x6 -medium encode (2-plane blocks,
    2 and 3 partitions, matched formats): test_torch_main's committed
    fixture, which a tier-1 test there holds to the live JAX encode."""
    from test_torch_main import config, load_scb_fixture
    s, packed = load_scb_fixture()
    real = ~s["const_u16"]
    assert (s["plane2_component"][real] >= 0).any()
    assert (s["partition_count"][real] == 2).any()
    assert (s["partition_count"][real] == 3).any()
    assert s["color_formats_matched"][real].any()
    tctx = tapi.context_alloc(config(tapi), device="cpu")
    got = tphys.symbolic_to_physical_batch(
        tctx.torch_decode_tables(),
        {k: torch.from_numpy(v) for k, v in s.items()}).numpy()
    np.testing.assert_array_equal(got, packed)
