"""astcenc_torch stage 2b (partition search and multi-partition trials)
against the JAX package's XLA path on the CPU: k-means, the coverage
mismatch, the line-error ranking (kernel K4's plain version) and the
candidate seeds it selects, the multi-partition format tables, and the 2-
and 3-partition trial records (kernels K1 and K2's plain versions inside
trial1_records) on JAX's own partition seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from astcenc_tpu import api as japi
from astcenc_tpu.codec import compress as jc
from astcenc_tpu.codec import partition_search as jps
from astcenc_tpu.ops import formats as jfmts
from astcenc_tpu.ops import ideal as jideal
from astcenc_torch import api as tapi
from astcenc_torch import testdata
from astcenc_torch.codec import compress as tc
from astcenc_torch.codec import partition_search as tps
from astcenc_torch.codec import trial as ttrial
from astcenc_torch.ops import formats as tfmts
from astcenc_torch.ops import psearch as tpsearch

torch.set_num_threads(1)

CW = (1.0, 1.0, 1.0, 1.0)


def _cfg(api):
    return api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)


@pytest.fixture(scope="module")
def ctxs():
    jctx = japi.context_alloc(_cfg(japi))
    return jctx, tapi.context_alloc(_cfg(tapi), device="cpu")


def _texels(n=32):
    """Blocks of a seeded synthetic image (edges, discs, an independent
    alpha on the right half), the first 4 replaced by uniform noise and the
    next 4 made opaque."""
    img = testdata.synthetic_image(24, 48, 6, independent_alpha=True)
    tex = tc.blockify(img[None].astype(np.float32) * (65535.0 / 255.0),
                      (6, 6, 1))[:n]
    rng = np.random.RandomState(9)
    tex[:4] = np.floor(rng.rand(4, 36, 4) * 255.0) * 257.0
    tex[4:8, :, 3] = 65535.0
    return np.ascontiguousarray(tex, dtype=np.float32)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_kmeans_and_mismatch_match_jax(ctxs, P):
    jctx, tctx = ctxs
    tex = _texels()
    want = np.asarray(jps._kmeans(jnp.asarray(tex), CW, 36, P))
    got = tps.kmeans(torch.from_numpy(tex), CW, 36, P).numpy()
    np.testing.assert_array_equal(got, want)

    # Coverage mismatch against every selected partitioning.
    kt = jctx.bsd.kmeans_texels.astype(np.int64)
    km_at = want[:, kt]
    akm = np.zeros((tex.shape[0], 4, 64), bool)
    akm[:, :, :len(kt)] = km_at[:, None, :] == np.arange(4)[None, :, None]
    cov = jctx.bsd.partitionings[P]["coverage"]
    mw = np.asarray(jps.partition_mismatch(jnp.asarray(akm), jnp.asarray(cov),
                                           P))
    tabs = tctx.partition_tables(P)
    words = torch.stack(
        [((torch.from_numpy(km_at) == p).to(torch.int64)
          << torch.arange(len(kt))).sum(-1) for p in range(4)], 1)
    mg = tps.partition_mismatch(words, tabs.coverage, P).numpy()
    np.testing.assert_array_equal(mg, mw)


def _jax_xla_line_errors(tex, uses_alpha, top, parts, P, wie):
    """JAX's line errors as find_best_partition_candidates computes them
    without Pallas (astcenc_tpu/codec/partition_search.py:210-262)."""
    N, S = top.shape
    T = tex.shape[1]
    pot_all = jnp.asarray(parts["partition_of_texel"].astype(np.int32))
    ptc_all = jnp.asarray(parts["partition_texel_count"].astype(np.int32))

    @jax.jit
    def run(texels, ua, top):
        pot = pot_all[top].reshape(N * S, T)
        counts_f = ptc_all[top].reshape(N * S, 4).astype(jnp.float32)
        tex_rep = jnp.broadcast_to(texels[:, None], (N, S, T, 4)).reshape(
            N * S, T, 4)
        cw_f = jnp.asarray(CW, jnp.float32)
        pmask = jideal.partition_onehot(pot)

        def line_errors(comp_mask):
            avg, dirv = jideal.avgs_and_dirs(tex_rep, pmask, comp_mask)
            cm = jnp.array(comp_mask, jnp.float32)
            uncor_b = jideal._normalize_safe(dirv, comp_mask)
            samec_b = jideal._normalize_safe(avg * cm, comp_mask)
            d = jnp.sum(avg * uncor_b * cm, -1, keepdims=True)
            uncor_amod = avg - uncor_b * d
            b_t = jnp.einsum("ntp,npc->ntc", pmask, uncor_b)
            am_t = jnp.einsum("ntp,npc->ntc", pmask, uncor_amod)
            param_u = jnp.sum(tex_rep * b_t * cm, -1)
            dist_u = am_t + param_u[..., None] * b_t - tex_rep
            err_u = jnp.sum(dist_u * dist_u * cw_f * cm, -1)
            bs_t = jnp.einsum("ntp,npc->ntc", pmask, samec_b)
            param_s = jnp.sum(tex_rep * bs_t * cm, -1)
            dist_s = param_s[..., None] * bs_t - tex_rep
            err_s = jnp.sum(dist_s * dist_s * cw_f * cm, -1)
            inpart = pmask.transpose(0, 2, 1) > 0
            lo = jnp.min(jnp.where(inpart, param_u[:, None, :], 1e10), 2)
            hi = jnp.max(jnp.where(inpart, param_u[:, None, :], -1e10), 2)
            lsq = jnp.maximum(hi - lo, 1e-7) ** 2
            ew = counts_f * wie
            u_extra = jnp.sum(jnp.sum((uncor_b * cm) ** 2, -1) * lsq * ew, -1)
            s_extra = jnp.sum(jnp.sum((samec_b * cm) ** 2, -1) * lsq * ew, -1)
            return err_u.sum(-1) + u_extra, err_s.sum(-1) + s_extra

        u4, s4 = line_errors((1, 1, 1, 1))
        u3, s3 = line_errors((1, 1, 1, 0))
        ua_rep = jnp.repeat(ua, S)
        return (jnp.where(ua_rep, u4, u3).reshape(N, S),
                jnp.where(ua_rep, s4, s3).reshape(N, S))

    return [np.asarray(x) for x in run(jnp.asarray(tex),
                                       jnp.asarray(uses_alpha),
                                       jnp.asarray(top))]


@pytest.mark.parametrize("P", [2, 3])
def test_partition_candidates_match_jax(ctxs, P):
    """Line errors within rtol 1e-4 and the selected seeds and validity on
    >= 99% of the (block, candidate) slots, at -medium's limits."""
    jctx, tctx = ctxs
    cfg = tctx.config
    limit = tc._req_index(cfg, P)
    ntr = min(tc._req_trials(cfg, P), limit)
    tex = _texels()
    st = tc.make_block_state(torch.from_numpy(tex), 1)
    tabs = tctx.partition_tables(P)
    got_s, got_v = tps.find_best_partition_candidates(st, tabs, 36, CW, P,
                                                      limit, ntr)
    cfgs = jc._CfgStatic(jctx.config)
    jst = jc.make_block_state(jnp.asarray(tex), cfgs.channel_weights, 1)
    want_s, want_v = jc._psearch_jit(japi._enc_key(jctx.bsd),
                                     cfgs.channel_weights, P, limit, ntr, jst)
    want_s, want_v = np.asarray(want_s), np.asarray(want_v)
    assert got_s.shape == want_s.shape
    assert (got_v.numpy() == want_v).mean() >= 0.99
    assert ((got_s.numpy() == want_s) | ~want_v).mean() >= 0.99

    # The line errors of the mismatch-ranked top candidates.
    km = tps.kmeans(torch.from_numpy(tex), CW, 36, P)
    km_at = km[:, tabs.kmeans_texels]
    words = torch.stack([((km_at == p).to(torch.int64)
                          << torch.arange(km_at.shape[1])).sum(-1)
                         for p in range(4)], 1)
    mism = tps.partition_mismatch(words, tabs.coverage, P)
    search = min(limit, tabs.count_selected)
    top = torch.argsort(mism, dim=-1, stable=True)[:, :search].to(torch.int32)
    ua = st["uses_alpha"].to(torch.int32)
    wie = tps._weight_imprecision(36)
    gu, gs = tpsearch.line_errors_plain(torch.from_numpy(tex), ua, top,
                                        tabs.pot, tabs.counts, P, wie, CW)
    wu, ws = _jax_xla_line_errors(tex, ua.numpy() != 0, top.numpy(),
                                  jctx.bsd.partitionings[P], P, wie)
    np.testing.assert_allclose(gu.numpy(), wu, rtol=1e-4)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-4)


@pytest.mark.parametrize("pc", [2, 3, 4])
def test_format_tables_match_jax(ctxs, pc):
    """combine_partitions and best_for_bitcount (mod_bits) for pc > 1."""
    jctx, tctx = ctxs
    rng = np.random.RandomState(pc)
    N = 16
    be = rng.randint(1, 40, (N, pc, 21, 4)).astype(np.float32) * 1e6
    be[:, :, :2] = 1e30
    fm = rng.randint(0, 13, (N, pc, 21, 4)).astype(np.int32)
    we, wf = jfmts.combine_partitions(jnp.asarray(be), jnp.asarray(fm), pc)
    ge, gf = tfmts.combine_partitions(torch.from_numpy(be),
                                      torch.from_numpy(fm), pc)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    pt = tctx.pass_tables("full", pc)
    want = jfmts.best_for_bitcount(we, wf, pt.quant_mode_table_np,
                                   pt.bitcount_np, pc, pt.mod_bits)
    got = tfmts.best_for_bitcount(ge, gf, pt.quant_mode_table_np,
                                  pt.bitcount_np, pc, pt.mod_bits)
    for k in ("error", "quant", "quant_mod", "formats"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("pc", [2, 3])
def test_trial1_records_partitions_match_jax(ctxs, pc):
    """The records of the first two candidates JAX's search picks, folded
    trial-major as stage 2b folds them."""
    jctx, tctx = ctxs
    cfgs = jc._CfgStatic(jctx.config)
    ek = japi._enc_key(jctx.bsd)
    tex = _texels(24)
    N, T = tex.shape[:2]
    jst = jc.make_block_state(jnp.asarray(tex), cfgs.channel_weights, 1)
    seeds, valid = jc._psearch_jit(ek, cfgs.channel_weights, pc,
                                   tc._req_index(tctx.config, pc), 2, jst)
    seeds, valid = np.asarray(seeds), np.asarray(valid)
    parts = jctx.bsd.partitionings[pc]
    rows = np.clip(parts["packed_index"][np.clip(seeds, 0, 1023)], 0,
                   parts["partition_of_texel"].shape[0] - 1).T.reshape(2 * N)
    pot = parts["partition_of_texel"][rows].astype(np.int32)
    counts = parts["partition_texel_count"][rows].astype(np.int32)
    tex_f = np.concatenate([tex, tex])
    ql = np.full((2 * N,), 11, np.int32)
    ql[::3] = 8
    ext = valid.T.reshape(2 * N).copy()
    ext[:3] = False
    jst_f = jc.make_block_state(jnp.asarray(tex_f), cfgs.channel_weights, 1)
    rx = jc._trial1_recs_jit(ek, cfgs, 1, False, pc, jst_f, jnp.asarray(pot),
                             jnp.asarray(counts), jnp.asarray(ql),
                             jnp.asarray(ext))
    rx = {k: np.asarray(v) for k, v in rx.items()}
    tst = tc.make_block_state(torch.from_numpy(tex_f), 1)
    rk = ttrial.trial1_records(
        tst, tctx.pass_tables("full", pc), tctx.config, 1, False,
        torch.from_numpy(ql), torch.from_numpy(ext),
        pot=torch.from_numpy(pot), counts=torch.from_numpy(counts))
    rk = {k: v.numpy() for k, v in rk.items()}
    assert set(rk) == set(rx)
    for k in rk:
        assert rk[k].shape == rx[k].shape, k
    live = rx["err"] < 1e29
    assert live.any(1).mean() > 0.8 and not live[:3].any()
    np.testing.assert_allclose(rk["err"][live], rx["err"][live], rtol=3e-4)
    wk, wx = rk["err"].argmin(1), rx["err"].argmin(1)
    assert (wk == wx).mean() > 0.9
    same = wk == wx
    for k in ("fmt", "vals", "mode", "useq", "match", "w64"):
        a, b = rk[k][same], rx[k][same]
        idx = wk[same].reshape((-1, 1) + (1,) * (a.ndim - 2))
        agree = (np.take_along_axis(a, idx, 1)
                 == np.take_along_axis(b, idx, 1)).mean()
        assert agree > 0.97, (k, agree)
    # The matched-format pack took part in these trials.
    assert rx["match"][live].any()
