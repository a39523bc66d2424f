"""astcenc_torch 1-plane trial records (kernel K2's plain version inside
trial1_records) against the JAX trial1_records on the CPU, at the
tests/test_pallas.py bounds, and tie handling of apply_records_1plane."""

import numpy as np
import torch

import jax.numpy as jnp

from astcenc_tpu import api as japi
from astcenc_tpu.codec import compress as jc
from astcenc_tpu.codec import trial as jtrial
from astcenc_torch import api as tapi
from astcenc_torch.codec import compress as tc
from astcenc_torch.codec import trial as ttrial

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
