"""astcenc_torch mode search (kernel K1's plain version) against the JAX
msearch_pallas.mode_search in interpret mode (4x4 -fastest) and against
the JAX XLA formulation (6x6 -medium, the slice's 56 modes), at the
tests/test_pallas.py agreement bounds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from astcenc_tpu import api as japi
from astcenc_tpu.codec import trial as jtrial
from astcenc_tpu.ops import angular as jang
from astcenc_tpu.ops import formats as jfmts
from astcenc_tpu.ops import ideal as jideal
from astcenc_tpu.ops import msearch_pallas as jms
from astcenc_torch import api as tapi
from astcenc_torch.ops import msearch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interp(monkeypatch):
    monkeypatch.setenv("ASTC_PALLAS_INTERPRET", "1")


def _inputs(rng, N, T):
    """tests/test_pallas.py::_msearch_inputs, pc = 1."""
    wei = rng.rand(N, T).astype(np.float32)
    wes = rng.rand(N, T).astype(np.float32) * 1e8
    mcut = rng.rand(N).astype(np.float32) * 2.0
    maxwq = rng.randint(5, 12, (N,)).astype(np.int32)
    comb_err = rng.rand(N, 21, 4).astype(np.float32) * 1e9
    comb_fmt = rng.randint(0, 16, (N, 21, 4, 1)).astype(np.int32)
    return wei, wes, mcut, maxwq, comb_err, comb_fmt


def _check_agreement(got, want):
    """tests/test_pallas.py::_check_agreement."""
    same = got["mode"] == want["mode"]
    assert same.mean() > 0.96, f"candidate agreement {same.mean()}"
    rel = np.abs(got["err"][same] - want["err"][same]) / np.maximum(
        np.abs(want["err"][same]), 1.0)
    assert np.median(rel) < 1e-5 and np.percentile(rel, 95) < 1e-3
    for k in ("dm", "wq", "valid"):
        np.testing.assert_array_equal(got[k][same], want[k][same], err_msg=k)
    for k in ("cq", "cqm", "fmt"):
        assert (got[k][same] == want[k][same]).mean() > 0.99, k
    assert (got["uq"][same] == want["uq"][same]).mean() > 0.995


def _port_tables(bx, quality):
    cfg = tapi.config_init(tapi.Profile.LDR, bx, bx, 1, quality, 0)
    return tapi.context_alloc(cfg, device="cpu").pass_tables("full")


def _port_search(pt, inp, C):
    wei, wes, mcut, maxwq, comb_err, comb_fmt = (
        torch.from_numpy(np.ascontiguousarray(a)) for a in inp)
    out = msearch.mode_search_plain(pt, wei, wes, mcut, maxwq, comb_err,
                                    comb_fmt[..., 0].contiguous(), C)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["fmt"] = out["fmt"][..., 0]                    # (N, C, pc=1)
    # Pass tables number decimations within the pass; map back to the BSD's.
    out["dm"] = pt.dms_used_np[out["dm"]]
    return out


def test_plain_matches_jax_kernel():
    # 4x4 -fastest: the interpreted Pallas kernel unrolls every mode, and
    # the 56 modes of 6x6 -medium take minutes to interpret on a CPU.
    jcfg = japi.config_init(japi.Profile.LDR, 4, 4, 1, japi.Quality.FASTEST,
                            0)
    jctx = japi.context_alloc(jcfg)
    et = jtrial.build_encoder_tables(jctx.bsd)
    T = et.dec_f32.shape[1]
    N, C = 64, 3
    inp = _inputs(np.random.RandomState(4), N, T)
    mmeta = jms.make_mode_meta(
        et.m1_quant, et.m1_dm, et.m1_weight_bits, et.m1_mode_index,
        jtrial._FREE_BITS_1PLANE[1], et.weight_quant_unquant,
        et.quant_mode_table, 0, 1, jang.TUNE_MAX_ANGULAR_QUANT)
    tabs = jms.MsTables(et.dec_int, et.dec_f32, et.dec_wcount,
                        et.dm_maxprec1)
    want = jms.mode_search(tabs, *(jnp.asarray(a) for a in inp), mmeta, C, 1)
    want = {k: np.asarray(v) for k, v in want.items()}
    want["fmt"] = want["fmt"][..., 0]                  # (N, C, pc=1)
    got = _port_search(_port_tables(4, tapi.Quality.FASTEST), inp, C)
    _check_agreement(got, want)
    # The port's copy of make_mode_meta is the JAX one.
    assert msearch.make_mode_meta(
        et.m1_quant, et.m1_dm, et.m1_weight_bits, et.m1_mode_index,
        jtrial._FREE_BITS_1PLANE[1], et.weight_quant_unquant,
        et.quant_mode_table, 0, 1, 7) == mmeta


def _jax_xla_search(et, inp, C):
    """The JAX mode search as trial1_records computes it when the Pallas
    kernels are off (astcenc_tpu/codec/trial.py:327-353 pass slicing and
    the XLA branch :460-555), full 1-plane pass, pc = 1. Slots without a
    valid mode are zeroed, as the port writes them."""
    N = inp[0].shape[0]
    quant_m = et.m1_quant
    dms_used = np.unique(et.m1_dm)
    remap = np.zeros(et.dec_int.shape[0], np.int32)
    remap[dms_used] = np.arange(len(dms_used), dtype=np.int32)
    dm_m = remap[et.m1_dm]
    wcount = et.dec_wcount[dms_used]
    W = int(min(et.dec_int.shape[2], ((int(wcount.max()) + 7) // 8) * 8))
    dec_int = et.dec_int[dms_used][:, :, :W]
    dec_sq = et.dec_sq[dms_used][:, :, :W]
    dec_f32 = et.dec_f32[dms_used][:, :, :W]
    wvalid = np.arange(W)[None, :] < wcount[:, None]
    ang_ok = quant_m <= jang.TUNE_MAX_ANGULAR_QUANT
    ql = np.where(ang_ok, quant_m, 0)
    bitcount = jtrial._FREE_BITS_1PLANE[1] - et.m1_weight_bits

    @jax.jit
    def search(wei, wes, mcut, maxwq, comb_err, comb_fmt):
        dec_ideal = jideal.ideal_weights_for_decimation(
            wei, wes, jnp.asarray(dec_int), jnp.asarray(dec_sq),
            jnp.asarray(dec_f32))
        max_precision = jnp.minimum(
            jnp.minimum(jnp.asarray(et.dm_maxprec1[dms_used])[None, :],
                        jang.TUNE_MAX_ANGULAR_QUANT), maxwq[:, None])
        low_v, high_v = jang.angular_endpoints_for_quant_levels(
            dec_ideal, jnp.asarray(wvalid), max_precision)
        low_m = jnp.where(jnp.asarray(ang_ok), low_v[:, dm_m, ql], 0.0)
        high_m = jnp.where(jnp.asarray(ang_ok), high_v[:, dm_m, ql], 1.0)
        high_m = jnp.where(high_m > 1.02 * mcut[:, None], 1.0, high_m)
        uqf, uq = jideal.quantize_weights_for_modes(
            dec_ideal[:, dm_m], low_m, high_m,
            jnp.asarray(et.weight_quant_unquant),
            jnp.asarray(jtrial._QUANT_LEVELS_M1), jnp.asarray(quant_m))
        qwt_err = jideal.weight_set_error(uqf, wei, wes,
                                          jnp.asarray(dec_f32[dm_m]))
        mode_ok = (jnp.asarray(bitcount > 0)[None, :]
                   & (jnp.asarray(quant_m)[None, :] <= maxwq[:, None]))
        qwt_err = jnp.where(mode_ok, qwt_err, jnp.float32(1e38))
        bb = jfmts.best_for_bitcount(comb_err, comb_fmt[..., 0],
                                     et.quant_mode_table, bitcount, 1, 0)
        total = jnp.where(qwt_err >= 1e37,
                          jnp.float32(jtrial.ERROR_CALC_DEFAULT),
                          bb["error"] + qwt_err)
        cand, valid = jfmts.select_candidates(total, C)
        return cand, valid, total, uq, bb

    cand, valid, total, uq, bb = jax.tree_util.tree_map(
        np.asarray, search(*(jnp.asarray(a) for a in inp)))
    cc = np.clip(cand, 0, quant_m.shape[0] - 1)
    ni = np.arange(N)[:, None]
    out = {"mode": et.m1_mode_index[cc], "dm": dms_used[dm_m[cc]],
           "wq": quant_m[cc], "cq": np.clip(bb["quant"][ni, cc], 4, 20),
           "cqm": np.clip(bb["quant_mod"][ni, cc], 0, 20),
           "fmt": bb["formats"][ni, cc, 0]}
    out = {k: np.where(valid, v, 0) for k, v in out.items()}
    out["uq"] = np.where(valid[..., None], uq[ni, cc], 0)
    out["valid"] = valid
    out["err"] = np.where(valid, total[ni, cc], jtrial.ERROR_CALC_DEFAULT)
    return out


def test_plain_matches_jax_xla_slice_modes():
    # 6x6 -medium: the slice's full pass (56 modes, several decimations,
    # angular levels up to 7) against the branch JAX takes without Pallas.
    jctx = japi.context_alloc(japi.config_init(
        japi.Profile.LDR, 6, 6, 1, japi.Quality.MEDIUM, 0))
    et = jtrial.build_encoder_tables(jctx.bsd)
    N, C = 64, 3
    inp = _inputs(np.random.RandomState(6), N, et.dec_f32.shape[1])
    pt = _port_tables(6, tapi.Quality.MEDIUM)
    assert pt.quant_m_np.shape[0] == 56 and pt.D > 1
    assert int(pt.quant_m_np.max()) > jang.TUNE_MAX_ANGULAR_QUANT
    _check_agreement(_port_search(pt, inp, C), _jax_xla_search(et, inp, C))
