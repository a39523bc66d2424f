"""astcenc_torch 1-plane trial records (kernel K2's plain version inside
trial1_records) against the JAX trial1_records on the CPU, at the
tests/test_pallas.py bounds, and tie handling of apply_records_1plane."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from astcenc_tpu import api as japi
from astcenc_tpu.codec import compress as jc
from astcenc_tpu.codec import trial as jtrial
from astcenc_tpu.ops import realign as jrealign
from astcenc_torch import api as tapi
from astcenc_torch import testdata
from astcenc_torch.codec import compress as tc
from astcenc_torch.codec import trial as ttrial
from astcenc_torch.ops import color_unquant as tcuq
from astcenc_torch.ops import realign as trealign

torch.set_num_threads(1)


def _slice_cfg(api):
    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    cfg.tune_partition_count_limit = 1
    cfg.tune_2plane_early_out_limit_correlation = 0.0
    return cfg


def _texels(N, T, seed):
    rng = np.random.RandomState(seed)
    tex = np.floor(rng.rand(N, T, 4) * 255.0).astype(np.float32) * 257.0
    tex[:16, :, 3] = 65535.0                 # opaque: 3-component ideal fit
    tex[16:24] = np.sort(tex[16:24], axis=1)  # smooth ramps
    return tex


def _check_records(rk, rx):
    """tests/test_pallas.py:322-339."""
    err_k, err_x = rk["err"], rx["err"]
    live = err_x < 1e29
    np.testing.assert_allclose(err_k[live], err_x[live], rtol=3e-4)
    wk, wx = err_k.argmin(1), err_x.argmin(1)
    assert (wk == wx).mean() > 0.9
    same = wk == wx
    for k in ("fmt", "vals", "mode", "useq", "w64"):
        a, b = rk[k][same], rx[k][same]
        idx = wk[same].reshape((-1, 1) + (1,) * (a.ndim - 2))
        agree = (np.take_along_axis(a, idx, 1)
                 == np.take_along_axis(b, idx, 1)).mean()
        assert agree > 0.97, (k, agree)


def test_records_match_jax():
    jctx = japi.context_alloc(_slice_cfg(japi))
    cfgs = jc._CfgStatic(jctx.config)
    N, T = 64, 36
    tex = _texels(N, T, 11)
    st = jc.make_block_state(jnp.asarray(tex), cfgs.channel_weights, 1)
    pot = jnp.zeros((N, T), jnp.int32)
    counts = jnp.zeros((N, 4), jnp.int32).at[:, 0].set(T)
    ql = jnp.full((N,), 11, jnp.int32)
    ext = jnp.ones((N,), bool).at[60:].set(False)
    rx = jc._trial1_recs_jit(japi._enc_key(jctx.bsd), cfgs, 1, False, 1,
                             st, pot, counts, ql, ext)
    rx = {k: np.asarray(v) for k, v in rx.items()}

    tctx = tapi.context_alloc(_slice_cfg(tapi), device="cpu")
    tst = tc.make_block_state(torch.from_numpy(tex), 1)
    ext_t = torch.ones(N, dtype=torch.bool)
    ext_t[60:] = False
    rk = ttrial.trial1_records(tst, tctx.pass_tables("full"), tctx.config, 1,
                               False, torch.full((N,), 11, dtype=torch.int32),
                               ext_t)
    rk = {k: v.numpy() for k, v in rk.items()}
    assert set(rk) == set(rx)
    for k in rk:
        assert rk[k].shape == rx[k].shape, k
    _check_records(rk, rx)
    assert (rk["err"][60:] >= 1e29).all()


def _realign_f64(grid, tex, ep0, ep1, Mf32, incid, wvalid, color_of, pn,
                 ncolors, slot):
    """The grouped realign of one lane in float64 (ops/realign.py), up to
    the class step of weight ``slot``: that step's (SA, e_dn, e_up)."""
    tex = tex.astype(np.float64)
    off = (ep1 - ep0).astype(np.float64) / 64.0
    M = Mf32.astype(np.float64)
    C_t = (off * off).sum(-1) * np.ones(len(tex))
    SC = (M * M).T @ C_t
    w = grid.astype(np.int64)
    down, up = pn[np.clip(w, 0, 64), 0], pn[np.clip(w, 0, 64), 1]
    for k in range(ncolors):
        infilled = M @ w
        diff = ep0 + off * infilled[:, None] - tex
        SA = incid.T @ (diff * diff).sum(-1)
        SB = M.T @ (diff * off).sum(-1)
        d_dn, d_up = down - w, up - w
        e_dn = SA + 2.0 * d_dn * SB + d_dn * d_dn * SC
        e_up = SA + 2.0 * d_up * SB + d_up * d_up * SC
        if color_of[slot] == k:
            return SA[slot], e_dn[slot], e_up[slot]
        ok = wvalid & (color_of == k)
        go_up = (e_up < SA) & (e_up < e_dn) & (w < 64) & ok
        go_dn = ~go_up & (e_dn < SA) & (w > 0) & ok
        w = np.where(go_up, up, np.where(go_dn, down, w))
    raise AssertionError("slot in no parity class")


def test_block247_realign_tie():
    """Block 247 of tests/test_torch_main.py's 96x96 image (the one block
    of that image the port encodes differently from JAX) parts from JAX in
    its 1-partition 1-plane pass, candidate 0, round 1: the records agree
    through round 0 and round 1 packs the same endpoints, but the round-1
    realign moves two weights (8 and 30, one parity class) differently.
    For each, moving up and staying have the same error exactly (float64),
    so the float32 comparison goes by rounding: the port's realign, and
    JAX's own realign compiled alone, move them; JAX's realign fused into
    its trial does not. The trial1_records compile is the one
    test_records_match_jax made (same configuration, same shapes)."""
    N, T = 64, 36
    img = testdata.synthetic_image(96, 96, 0)
    tctx = tapi.context_alloc(_slice_cfg(tapi), device="cpu")
    tex = np.repeat(tc.image_to_blocks(tctx, img)[247:248], N, 0)
    pt = tctx.pass_tables("full")
    rk = ttrial.trial1_records(tc.make_block_state(torch.from_numpy(tex), 1),
                               pt, tctx.config, 1, False,
                               torch.full((N,), 11, dtype=torch.int32),
                               torch.ones(N, dtype=torch.bool))
    rk = {k: v.numpy()[0] for k, v in rk.items()}

    jctx = japi.context_alloc(_slice_cfg(japi))
    cfgs = jc._CfgStatic(jctx.config)
    st = jc.make_block_state(jnp.asarray(tex), cfgs.channel_weights, 1)
    rx = jc._trial1_recs_jit(
        japi._enc_key(jctx.bsd), cfgs, 1, False, 1, st,
        jnp.zeros((N, T), jnp.int32),
        jnp.zeros((N, 4), jnp.int32).at[:, 0].set(T),
        jnp.full((N,), 11, jnp.int32), jnp.ones((N,), bool))
    rx = {k: np.asarray(v)[0] for k, v in rx.items()}
    # Records 0-1 (round 0) agree; record 2 (round 1) packs the same
    # endpoints and realigns differently.
    for k in ("err", "fmt", "vals", "w64"):
        np.testing.assert_array_equal(rk[k][:2], rx[k][:2], err_msg=k)
    np.testing.assert_array_equal(rk["vals"][2], rx["vals"][2])
    diff = np.nonzero(rk["w64"][2] != rx["w64"][2])[0]

    # The round-1 state: the round-0 grid and the decoded round-1 endpoints.
    m = int(np.nonzero(pt.mode_index_np == rk["mode"][0])[0][0])
    dm, wq = int(pt.dm_m_np[m]), int(pt.quant_m_np[m])
    W = pt.W
    grid = rk["w64"][1][:W]
    e0, e1, _, _ = tcuq.unpack_color_endpoints(
        1, torch.from_numpy(rk["fmt"][2][:1]),
        torch.from_numpy(rk["vals"][2][:1]))
    e0, e1 = e0.numpy()[0].astype(np.float32), e1.numpy()[0].astype(
        np.float32)
    Mf32 = pt.dec_f32[dm].numpy()
    incid = (Mf32 != 0).astype(np.float32)
    wvalid = pt.wvalid[dm].numpy()
    color_of = pt.dm_color[dm].numpy()
    pn = pt.weight_prev_next[wq].numpy()
    got, _ = trealign.realign_decimated_grouped(
        torch.from_numpy(grid[None]), torch.from_numpy(tex[:1]),
        torch.from_numpy(np.broadcast_to(e0, (1, T, 4)).copy()),
        torch.from_numpy(np.broadcast_to(e1, (1, T, 4)).copy()),
        (1.0, 1.0, 1.0, 1.0), torch.from_numpy(pn[None]),
        torch.from_numpy(Mf32[None]), torch.from_numpy(incid[None]),
        torch.from_numpy(wvalid[None]), torch.from_numpy(color_of[None]),
        pt.ncolors)
    want, _ = jax.jit(jrealign.realign_decimated_grouped, static_argnums=12)(
        jnp.asarray(grid[None]), jnp.asarray(tex[:1]),
        jnp.ones((1, T, 1), jnp.float32), jnp.asarray(e0[None, None]),
        jnp.asarray(e1[None, None]), (1.0, 1.0, 1.0, 1.0),
        jnp.asarray(pt.weight_prev_next.numpy()), jnp.asarray([wq]),
        jnp.asarray(Mf32[None]), jnp.asarray(incid[None]),
        jnp.asarray(wvalid[None]), jnp.asarray(color_of[None]), pt.ncolors)
    np.testing.assert_array_equal(got.numpy()[0], rk["w64"][2][:W])
    # JAX's own realign, compiled alone, moves them as the port does.
    np.testing.assert_array_equal(np.asarray(want)[0], got.numpy()[0])
    for slot in diff:
        SA, e_dn, e_up = _realign_f64(grid, tex[0], e0.astype(np.float64),
                                      e1.astype(np.float64), Mf32, incid,
                                      wvalid, color_of, pn, pt.ncolors, slot)
        print(f"block 247: weight {slot} (class {color_of[slot]}) moves "
              f"{grid[slot]} -> port {rk['w64'][2][slot]}, JAX "
              f"{rx['w64'][2][slot]}; float64 SA {SA!r}, e_dn {e_dn!r}, "
              f"e_up {e_up!r}")
        assert abs(min(e_dn, e_up) - SA) <= 1e-6 * SA


# Each case: (previous best, threshold, record errors) for one block.
TIE_CASES = [
    (1e30, 0.0, [5.0, 3.0, 3.0, 7.0, 3.0, 9.0]),       # argmin tie
    (1e30, 4.0, [5.0, 3.0, 3.0, 2.0, 3.0, 2.0]),       # first hit wins
    (3.0, 10.0, [3.0, 3.0, 2.0, 2.0, 9.0, 1.0]),       # strict < prev best
    (1e30, 1e31, [1e30] * 6),                          # nothing improves
    (2.0, 0.0, [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]),        # all tie prev best
    (1e30, 5.0, [6.0, 6.0, 4.0, 4.0, 4.0, 1.0]),       # hit after ties
]


def test_apply_records_ties():
    N = len(TIE_CASES)
    CK = 6
    rng = np.random.RandomState(2)
    err = np.array([c[2] for c in TIE_CASES], np.float32)
    recs = {
        "err": err,
        "fmt": rng.randint(0, 13, (N, CK, 4)).astype(np.int32),
        "vals": rng.randint(0, 256, (N, CK, 4, 8)).astype(np.int32),
        "useq": rng.randint(4, 21, (N, CK)).astype(np.int32),
        "match": rng.rand(N, CK) > 0.5,
        "w64": rng.randint(0, 65, (N, CK, 64)).astype(np.int32),
        "mode": rng.randint(0, 2048, (N, CK)).astype(np.int32),
    }
    jscb = jtrial.empty_scb(N, 36)
    jscb = dict(jscb)
    jscb["errorval"] = jnp.asarray([c[0] for c in TIE_CASES], jnp.float32)
    thr = np.array([c[1] for c in TIE_CASES], np.float32)
    pidx = np.arange(N, dtype=np.int32)
    want, wbest = jtrial.apply_records_1plane(
        jscb, {k: jnp.asarray(v) for k, v in recs.items()},
        jnp.asarray(thr), 1, jnp.asarray(pidx))
    tscb = ttrial.empty_scb(N, 36, "cpu")
    tscb["errorval"] = torch.tensor([c[0] for c in TIE_CASES])
    got, gbest = ttrial.apply_records_1plane(
        tscb, {k: torch.from_numpy(v) for k, v in recs.items()},
        torch.from_numpy(thr), 1, torch.from_numpy(pidx))
    np.testing.assert_array_equal(gbest.numpy(), np.asarray(wbest))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
