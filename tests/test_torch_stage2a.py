"""astcenc_torch stage 2a (1 partition, 2 planes) against the JAX package's
XLA path on the CPU: the 2-plane trial error and least-squares refit, the
folded 2-plane trial records (kernels K1 and K3's plain versions inside
trial2_records) at the tests/test_pallas.py bounds, the sequential record
replay, and the whole stage on a stage-1 result."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astcenc_tpu import api as japi
from astcenc_tpu.codec import compress as jc
from astcenc_tpu.codec import trial as jtrial
from astcenc_tpu.ops import recompute as jrecompute
from astcenc_torch import api as tapi
from astcenc_torch import testdata
from astcenc_torch.codec import compress as tc
from astcenc_torch.codec import trial as ttrial
from astcenc_torch.ops import recompute as trecompute
from astcenc_torch.ops import refine as trefine

torch.set_num_threads(1)

CW = (1.0, 1.0, 1.0, 1.0)


def _cfg(api):
    return api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)


@pytest.fixture(scope="module")
def ctxs():
    jctx = japi.context_alloc(_cfg(japi))
    return jctx, tapi.context_alloc(_cfg(tapi), device="cpu")


def _texels():
    """32 blocks of a seeded 24x48 image whose right half has an alpha of
    its own (the 2-plane stage's blocks), 4 of them with noise added so
    every channel pair decorrelates."""
    img = testdata.synthetic_image(24, 48, 4, independent_alpha=True)
    tex = tc.blockify(img[None].astype(np.float32) * (65535.0 / 255.0),
                      (6, 6, 1))
    rng = np.random.RandomState(8)
    tex[:4] = np.clip(tex[:4] + rng.normal(0, 3000.0, tex[:4].shape), 0,
                      65535.0)
    return np.floor(tex).astype(np.float32)


def test_trial_error_2plane_matches_jax(ctxs):
    jctx, tctx = ctxs
    rng = np.random.RandomState(1)
    N, T = 64, 36
    et = tctx.encoder_tables()
    Mint = et.dec_int[rng.randint(1, et.dec_int.shape[0], N)]
    W = Mint.shape[2]
    tex = np.floor(rng.rand(N, T, 4) * 65535.0).astype(np.float32)
    w1 = rng.randint(0, 65, (N, W)).astype(np.int32)
    w2 = rng.randint(0, 65, (N, W)).astype(np.int32)
    p2c = rng.randint(0, 4, N).astype(np.int32)
    ep0 = (rng.randint(0, 256, (N, 4)) * 257).astype(np.float32)
    ep1 = (rng.randint(0, 256, (N, 4)) * 257).astype(np.float32)
    for u8 in (False, True):
        want = np.asarray(jtrial.trial_error_2plane(
            jnp.asarray(tex), None, None, jnp.asarray(w1), jnp.asarray(w2),
            jnp.asarray(p2c), jnp.asarray(Mint), CW, 1, u8,
            ep=(jnp.asarray(ep0), jnp.asarray(ep1))))
        got = trefine.trial_error_2plane(
            *(torch.from_numpy(a) for a in (tex, w1, w2, p2c, Mint, ep0,
                                            ep1)), CW, u8).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_recompute_2planes_matches_jax():
    rng = np.random.RandomState(2)
    N, T = 64, 36
    tex = np.floor(rng.rand(N, T, 4) * 65535.0).astype(np.float32)
    u1 = (rng.randint(0, 65, (N, T)) / 64.0).astype(np.float32)
    u2 = (rng.randint(0, 65, (N, T)) / 64.0).astype(np.float32)
    u1[:4] = 0.5                                  # plane 1 all the same
    u2[4:8] = 0.25                                # plane 2 all the same
    p2c = rng.randint(0, 4, N).astype(np.int32)
    mean = tex.mean(1)
    ep0 = rng.rand(N, 4).astype(np.float32) * 65535.0
    ep1 = rng.rand(N, 4).astype(np.float32) * 65535.0
    args = (tex, u1, u2, p2c)
    want = jrecompute.recompute_ideal_colors_2planes(
        *(jnp.asarray(a) for a in args), CW, jnp.asarray(mean),
        jnp.asarray(ep0), jnp.asarray(ep1))
    got = trecompute.recompute_ideal_colors_2planes(
        *(torch.from_numpy(a) for a in args), CW, torch.from_numpy(mean),
        torch.from_numpy(ep0), torch.from_numpy(ep1))
    for k in ("ep0", "ep1", "rgbs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-2, err_msg=k)


def _records_pair(ctxs, tex, ext, ql):
    jctx, tctx = ctxs
    cfgs = jc._CfgStatic(jctx.config)
    st = jc.make_block_state(jnp.asarray(tex), cfgs.channel_weights, 1)
    rx = jc._trial2_recs_jit(japi._enc_key(jctx.bsd), cfgs, 1, False, st,
                             jnp.asarray(ext), jnp.asarray(ql))
    rx = {k: np.asarray(v) for k, v in rx.items()}
    tst = tc.make_block_state(torch.from_numpy(tex), 1)
    rk = ttrial.trial2_records(tst, tctx.pass_tables("two"), tctx.config, 1,
                               False, torch.from_numpy(ql),
                               torch.from_numpy(ext))
    return {k: v.numpy() for k, v in rk.items()}, rx


def test_trial2_records_match_jax(ctxs):
    """All four plane-2 components, folded into one batch."""
    tex = _texels()
    N = tex.shape[0]
    ext = np.ones((N, 4), bool)
    ext[-3:, 1] = False                           # some lanes may not refine
    ql = np.full((N,), 11, np.int32)
    ql[::5] = 7                                   # stage-1 winners' limits
    rk, rx = _records_pair(ctxs, tex, ext, ql)
    assert set(rk) == set(rx)
    for k in rk:
        assert rk[k].shape == rx[k].shape, k
    live = rx["err"] < 1e29
    assert live.any(1).mean() > 0.9
    np.testing.assert_array_equal(rk["err"] >= 1e29, ~live)
    np.testing.assert_allclose(rk["err"][live], rx["err"][live], rtol=3e-4)
    wk, wx = rk["err"].argmin(1), rx["err"].argmin(1)
    assert (wk == wx).mean() > 0.9
    same = wk == wx
    for k in ("fmt", "vals", "mode", "q", "w1_64", "w2_64"):
        a, b = rk[k][same], rx[k][same]
        idx = wk[same].reshape((-1, 1) + (1,) * (a.ndim - 2))
        agree = (np.take_along_axis(a, idx, 1)
                 == np.take_along_axis(b, idx, 1)).mean()
        assert agree > 0.97, (k, agree)


def test_apply_records_2plane_matches_jax():
    """The sequential take over one component's records, ties included."""
    rng = np.random.RandomState(3)
    N, CK = 48, 12
    err = rng.randint(1, 6, (N, CK)).astype(np.float32) * 100.0
    err[::7] = 1e30
    recs = {
        "err": err,
        "fmt": rng.randint(0, 13, (N, CK, 4)).astype(np.int32),
        "vals": rng.randint(0, 256, (N, CK, 4, 8)).astype(np.int32),
        "q": rng.randint(4, 21, (N, CK)).astype(np.int32),
        "mode": rng.randint(0, 2048, (N, CK)).astype(np.int32),
        "w1_64": rng.randint(0, 65, (N, CK, 64)).astype(np.int32),
        "w2_64": rng.randint(0, 65, (N, CK, 64)).astype(np.int32),
    }
    prev = rng.choice([1e30, 250.0, 100.0], N).astype(np.float32)
    fin = rng.rand(N) < 0.2
    thr = rng.choice([0.0, 300.0], N).astype(np.float32)
    p2c = rng.randint(0, 4, N).astype(np.int32)
    act = rng.rand(N) < 0.8
    jscb = dict(jtrial.empty_scb(N, 36))
    jscb["errorval"] = jnp.asarray(prev)
    jscb["finished"] = jnp.asarray(fin)
    want, wbest = jtrial.apply_records_2plane(
        jscb, {k: jnp.asarray(v) for k, v in recs.items()}, jnp.asarray(thr),
        jnp.asarray(p2c), jnp.asarray(act))
    tscb = ttrial.empty_scb(N, 36, "cpu")
    tscb["errorval"] = torch.from_numpy(prev)
    tscb["finished"] = torch.from_numpy(fin)
    got, gbest = ttrial.apply_records_2plane(
        tscb, {k: torch.from_numpy(v) for k, v in recs.items()},
        torch.from_numpy(thr), torch.from_numpy(p2c), torch.from_numpy(act))
    np.testing.assert_array_equal(gbest.numpy(), np.asarray(wbest))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_stage2a_matches_jax(ctxs):
    """Stage 2a on the port's stage-1 result, against JAX's _stage2a_2plane
    on the same state: the same blocks change, to the same encodings."""
    jctx, tctx = ctxs
    tex = _texels()
    scb, aux = tc.stage1_1plane(tctx, torch.from_numpy(tex))
    elig = ~scb["finished"] & ~aux["skip2p"]
    assert elig.sum() >= 8
    idx = torch.nonzero(elig)[:, 0]
    sub = tc.stage2a_2plane(tctx, tc._sub(aux["st"], idx), tc._sub(scb, idx),
                            aux["quant_limit"][idx], aux["best0"][idx],
                            aux["error_threshold"][idx], aux["overshoot"])
    got = {k: v.numpy() for k, v in tc._scatter(scb, idx, sub).items()}

    cfgs = jc._CfgStatic(jctx.config)
    jscb = {k: jnp.asarray(v.numpy()) for k, v in scb.items()}
    want = jc._stage2a_2plane(japi._enc_key(jctx.bsd), cfgs, jnp.asarray(tex),
                              jscb, jnp.asarray(aux["quant_limit"].numpy()),
                              jnp.asarray(aux["best0"].numpy()))
    want = {k: np.asarray(v) for k, v in want.items()}
    two = want["plane2_component"] >= 0
    assert two.sum() >= 4
    np.testing.assert_array_equal(got["plane2_component"] >= 0, two)
    same = np.ones(tex.shape[0], bool)
    for k in ("block_mode", "quant_mode", "plane2_component",
              "color_formats", "color_values", "weights", "weights2"):
        same &= (got[k] == want[k]).reshape(len(same), -1).all(1)
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_allclose(got["errorval"], want["errorval"], rtol=3e-4)
