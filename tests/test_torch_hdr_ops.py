"""HDR ops of astcenc_torch against the JAX package on the CPU, bit for bit:
the softfloat conversions, the HDR endpoint unpack, the HDR colour pack and
the plain version of kernel K9 (the colour quantizer lookup). The colour
error tables agree within 1e-6 and the HDR refits within 1e-5 of each
vector's largest component. Inputs are seeded with numpy and handed to
both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from astcenc_tpu.ops import color_pack as jcp
from astcenc_tpu.ops import color_pack_hdr as jcph
from astcenc_tpu.ops import color_unquant as jcuq
from astcenc_tpu.ops import formats as jfmt
from astcenc_tpu.ops import recompute as jrec
from astcenc_tpu.ops import softfloat as jsf
from astcenc_torch.ops import color_pack_hdr as tcph
from astcenc_torch.ops import color_unquant as tcuq
from astcenc_torch.ops import formats as tfmt
from astcenc_torch.ops import gather as tgather
from astcenc_torch.ops import recompute as trec
from astcenc_torch.ops import softfloat as tsf

torch.set_num_threads(1)
CW = (1.0, 1.0, 1.0, 1.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32_sweep():
    """Every class of float32: NaN, +-Inf, zeros, denormals, negatives, the
    LNS breakpoints and a dense random sweep over the exponent range."""
    rng = np.random.default_rng(0)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                        1e-45, 1e-40, 2.0 ** -26, 2.0 ** -25, 2.0 ** -14,
                        6.1e-5, 65504.0, 65519.0, 65520.0, 65536.0, 1e9,
                        -1.0, -1e-40, 0.5, 1.0, 1.5, 2.0], np.float32)
    rand = (rng.standard_normal(20000).astype(np.float32)
            * np.exp2(rng.uniform(-30, 20, 20000)).astype(np.float32))
    bits = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    return np.concatenate([special, rand, bits])


def test_softfloat_matches_jax():
    x = _f32_sweep()
    want = np.asarray(jsf.float_to_lns(jnp.asarray(x)))
    got = tsf.float_to_lns(_t(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))

    want = np.asarray(jsf.float_to_float16(jnp.asarray(x)))
    got = tsf.float_to_float16(_t(x)).numpy()
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    # NaN keeps a NaN pattern (exponent all ones, mantissa non-zero).
    assert ((got[nan] & 0x7C00) == 0x7C00).all() and (got[nan] & 0x3FF).all()

    p = np.arange(65536, dtype=np.int32)
    np.testing.assert_array_equal(
        tsf.lns_to_sf16(_t(p)).numpy(), np.asarray(jsf.lns_to_sf16(p)))
    np.testing.assert_array_equal(
        tsf.float16_to_float(_t(p)).numpy().view(np.uint32),
        np.asarray(jsf.float16_to_float(p)).view(np.uint32))


@pytest.mark.parametrize("profile", [2, 3])
def test_unpack_hdr_matches_jax(profile):
    rng = np.random.default_rng(profile)
    fmt = rng.integers(0, 16, 8192).astype(np.int32)
    vals = rng.integers(0, 256, (8192, 8)).astype(np.int32)
    want = jcuq.unpack_color_endpoints(profile, jnp.asarray(fmt),
                                       jnp.asarray(vals))
    got = tcuq.unpack_color_endpoints(profile, _t(fmt), _t(vals))
    assert [g.dtype for g in got] == [torch.int32] * 2 + [torch.bool] * 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _endpoints(rng, n):
    """Seeded HDR endpoint pairs in the LNS-code domain: mostly ordered
    pairs at every brightness, some wide, some equal, some out of range."""
    base = rng.uniform(0.0, 65535.0, (n, 1)).astype(np.float32)
    spread = np.exp2(rng.uniform(0, 16, (n, 1))).astype(np.float32)
    ep0 = base + rng.normal(0, 1, (n, 4)).astype(np.float32) * spread * 0.05
    ep1 = ep0 + np.abs(rng.normal(0, 1, (n, 4))).astype(np.float32) * spread
    ep1[: n // 16] = ep0[: n // 16]
    ep0[n // 16: n // 8] -= 3000.0
    rgbs = np.concatenate([ep1[:, :3], rng.uniform(0, 1, (n, 1))], 1)
    rgbo = np.concatenate([ep0[:, :3], np.abs(ep1[:, 3:] - ep0[:, 3:])], 1)
    return (ep0.astype(np.float32), ep1.astype(np.float32),
            rgbs.astype(np.float32), rgbo.astype(np.float32))


@pytest.mark.parametrize("profile", [2, 3])
def test_pack_hdr_matches_jax(profile):
    rng = np.random.default_rng(10 + profile)
    n = 4096
    ep0, ep1, rgbs, rgbo = _endpoints(rng, n)
    req = rng.choice(np.array([0, 2, 3, 4, 6, 7, 8, 10, 11, 12, 14, 15],
                              np.int32), n)
    ql = rng.integers(4, 21, n).astype(np.int32)
    fn = jax.jit(jcph.pack_color_endpoints, static_argnums=0)
    wf, wv = fn(profile, *map(jnp.asarray, (ep0, ep1, rgbs, rgbo, req, ql)))
    gf, gv = tcph.pack_color_endpoints(profile, *map(_t, (ep0, ep1, rgbs,
                                                          rgbo, req, ql)))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # Every HDR format the packer can emit came out.
    assert set(tcuq.HDR_FORMATS) <= set(gf.numpy().tolist())


def test_quant_lookup_plain_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.integers(-2, 19, 512).astype(np.int32)       # clamped to 0..16
    v = rng.integers(-20, 280, (512, 72)).astype(np.int32)
    qq = jcp.QuantQ(jnp.asarray(np.clip(q, 0, 16)))
    lh = np.asarray(qq.lookup(jnp.asarray(v)))
    got = tgather.quant_lookup(_t(q), _t(v)).numpy()
    np.testing.assert_array_equal(got & 0xFF, lh[..., 0].astype(np.int32))
    np.testing.assert_array_equal(got >> 8, lh[..., 1].astype(np.int32))


def _rel_close(got, want, tol=1e-6):
    """Within tol of each vector's largest component (last axis)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    scale = np.maximum(np.nanmax(np.abs(want), -1, keepdims=True), 1.0)
    err = np.abs(got - want) / scale
    assert np.nanmax(err) <= tol, np.nanmax(err)


@pytest.mark.parametrize("encode_hdr_alpha", [False, True])
def test_color_error_tables_hdr(encode_hdr_alpha):
    rng = np.random.default_rng(7)
    N, P = 256, 2
    ep0, ep1, _, _ = _endpoints(rng, N * P)
    ep0, ep1 = ep0.reshape(N, P, 4), ep1.reshape(N, P, 4)
    counts = rng.integers(1, 36, (N, P)).astype(np.int32)
    eci = {k: rng.uniform(0, 1e6, (N, P)).astype(np.float32)
           for k in ("rgb_scale_error", "rgb_luma_error", "luminance_error",
                     "alpha_drop_error")}
    wb, wf = jfmt.color_error_tables_hdr(
        {k: jnp.asarray(v) for k, v in eci.items()}, jnp.asarray(ep0),
        jnp.asarray(ep1), jnp.asarray(counts), CW, encode_hdr_alpha)
    gb, gf = tfmt.color_error_tables_hdr(
        {k: _t(v) for k, v in eci.items()}, _t(ep0), _t(ep1), _t(counts), CW,
        encode_hdr_alpha)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    _rel_close(gb.numpy(), wb)


def test_hdr_refits_match_jax():
    """The 1- and 2-plane refits with the RGBO vector. The texel sums run
    in the kernels' order (``recompute.lane_sum``), the JAX package's in
    XLA's, so the endpoints differ in their last bits, which the RGBO
    vector's 4x4 solve amplifies: held within 1e-5 of each vector's
    largest component (measured: 3.2e-6 for RGBO, 1.7e-6 for the rest)."""
    tol = 1e-5
    rng = np.random.default_rng(8)
    N, T, P = 128, 36, 2
    tex = rng.uniform(0, 65535, (N, T, 4)).astype(np.float32)
    pot = rng.integers(0, P, (N, T))
    pmask = (pot[..., None] == np.arange(P)).astype(np.float32)
    counts = pmask.sum(1).astype(np.int32)
    u = (rng.integers(0, 65, (N, T)) / 64.0).astype(np.float32)
    u2 = (rng.integers(0, 65, (N, T)) / 64.0).astype(np.float32)
    e0 = rng.uniform(0, 30000, (N, P, 4)).astype(np.float32)
    e1 = e0 + rng.uniform(0, 30000, (N, P, 4)).astype(np.float32)
    want = jrec.recompute_ideal_colors_1plane(
        *map(jnp.asarray, (tex, pmask, counts, u)), CW, jnp.asarray(e0),
        jnp.asarray(e1), is_hdr=True)
    got = trec.recompute_ideal_colors_1plane(
        *map(_t, (tex, pmask, counts, u)), CW, _t(e0), _t(e1), is_hdr=True)
    for k in ("ep0", "ep1", "rgbs", "rgbo"):
        _rel_close(got[k].numpy(), want[k], tol)
    p2c = rng.integers(0, 4, N).astype(np.int32)
    mean = tex.mean(1)
    want = jrec.recompute_ideal_colors_2planes(
        *map(jnp.asarray, (tex, u, u2, p2c)), CW, jnp.asarray(mean),
        jnp.asarray(e0[:, 0]), jnp.asarray(e1[:, 0]), is_hdr=True)
    got = trec.recompute_ideal_colors_2planes(
        *map(_t, (tex, u, u2, p2c)), CW, _t(mean), _t(e0[:, 0]),
        _t(e1[:, 0]), is_hdr=True)
    for k in ("ep0", "ep1", "rgbs", "rgbo"):
        _rel_close(got[k].numpy(), want[k], tol)
