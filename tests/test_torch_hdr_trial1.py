"""astcenc_torch 1-plane HDR trials against the JAX package's XLA path on
the CPU, at profile 2 (-ch): the records of trial1_records at one partition
(the HDR refit, the HDR pack and the plain version of kernel K5 between
rounds) at the tests/test_pallas.py bounds, and K5's plain version against
JAX's XLA round pieces (trial error, grouped realign, infill).

The texels are LNS blocks of a seeded ``synthetic_hdr_image``. One JAX HDR
trial program compiles here, a minute or two on a CPU; the 2-plane trial
is in tests/test_torch_hdr_trial2.py, which shares these helpers.
"""

import functools

import numpy as np
import pytest
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
from astcenc_torch.ops import refine as trefine

torch.set_num_threads(1)

PROFILE = 2
CW = (1.0, 1.0, 1.0, 1.0)


def _cfg(api):
    """-ch at -medium with one refinement round instead of three (the
    bootstrap, the refit, the pack and one round): each round is one more
    copy of the HDR pack for JAX to compile, and the tier-1 budget is
    tight. tests/test_torch_hdr_image.py runs all three rounds."""
    cfg = api.config_init(api.Profile.HDR_RGB_LDR_A, 6, 6, 1,
                          api.Quality.MEDIUM, 0)
    cfg.tune_refinement_limit = 1
    return cfg


@pytest.fixture(scope="module")
def ctxs():
    return (japi.context_alloc(_cfg(japi)),
            tapi.context_alloc(_cfg(tapi), device="cpu"))


def _texels(ctx, seed=2):
    """48 LNS blocks of a seeded 36x48 HDR image whose right half has an
    alpha of its own."""
    img = testdata.synthetic_hdr_image(36, 48, seed, independent_alpha=True)
    return tc.image_to_blocks(ctx, img)


def _agree(rk, rx, keys, within=1.0):
    """tests/test_pallas.py:322-339: error rtol 3e-4 on live records,
    winners > 0.9, payloads of agreeing winners > 0.97. With within < 1,
    that share of the live records must be within 3e-4, and every live
    record whose encoding (formats and values) equals JAX's."""
    assert set(rk) == set(rx)
    for k in rk:
        assert rk[k].shape == rx[k].shape, k
    live = rx["err"] < 1e29
    assert live.any(1).mean() > 0.9
    np.testing.assert_array_equal(rk["err"] >= 1e29, ~live)
    close = np.abs(rk["err"] - rx["err"]) <= 3e-4 * np.abs(rx["err"])
    same_enc = ((rk["fmt"] == rx["fmt"]).reshape(live.shape + (-1,)).all(-1)
                & (rk["vals"] == rx["vals"]).reshape(live.shape + (-1,))
                .all(-1))
    assert close[live & same_enc].all()
    assert close[live].mean() >= within, close[live].mean()
    wk, wx = rk["err"].argmin(1), rx["err"].argmin(1)
    assert (wk == wx).mean() > 0.9
    same = wk == wx
    for k in keys:
        a, b = rk[k][same], rx[k][same]
        idx = wk[same].reshape((-1, 1) + (1,) * (a.ndim - 2))
        agree = (np.take_along_axis(a, idx, 1)
                 == np.take_along_axis(b, idx, 1)).mean()
        assert agree > 0.97, (k, agree)
    return wk


def test_trial1_records_hdr_match_jax(ctxs):
    jctx, tctx = ctxs
    tex = _texels(tctx)
    N, T, _ = tex.shape
    cfgs = jc._CfgStatic(jctx.config)
    st = jc.make_block_state(jnp.asarray(tex), cfgs.channel_weights, PROFILE)
    ext = np.ones((N,), bool)
    ext[-4:] = False
    rx = jc._trial1_recs_jit(
        japi._enc_key(jctx.bsd), cfgs, PROFILE, False, 1, st,
        jnp.zeros((N, T), jnp.int32),
        jnp.zeros((N, 4), jnp.int32).at[:, 0].set(T),
        jnp.full((N,), 11, jnp.int32), jnp.asarray(ext))
    rx = {k: np.asarray(v) for k, v in rx.items()}
    tst = tc.make_block_state(torch.from_numpy(tex), PROFILE)
    rk = ttrial.trial1_records(tst, tctx.pass_tables("full"), tctx.config,
                               PROFILE, False,
                               torch.full((N,), 11, dtype=torch.int32),
                               torch.from_numpy(ext))
    rk = {k: v.numpy() for k, v in rk.items()}
    wk = _agree(rk, rx, ("fmt", "vals", "mode", "useq", "w64"))
    # The winners' endpoint formats are HDR ones (2, 3, 7, 11, 14).
    fmts = np.take_along_axis(rk["fmt"][:, :, 0], wk[:, None], 1)
    assert np.isin(fmts[:-4], (2, 3, 7, 11, 14)).all()
    assert (rk["err"][-4:] >= 1e29).all()


def _round_inputs(tctx, kind, seed):
    """Seeded inputs of one refinement round: grids, decimation modes and
    weight quants of the pass, decoded HDR endpoints, LNS texels."""
    rng = np.random.default_rng(seed)
    pt = tctx.pass_tables(kind)
    tex = _texels(tctx, seed)
    N, T, _ = tex.shape
    C = 2
    NC = N * C
    dm = rng.integers(0, pt.D, NC).astype(np.int32)
    wq = rng.integers(0, 12, NC).astype(np.int32)
    wcount = pt.wvalid.numpy().sum(1)[dm]
    unq = pt.weight_quant_unquant.numpy()
    levels = np.array([2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32])[wq]
    grid = unq[wq[:, None], rng.integers(0, 64, (NC, pt.W)) % levels[:, None]]
    grid = np.where(np.arange(pt.W)[None] < wcount[:, None], grid, 0)
    lo = np.sort(tex, 1)[:, 2].repeat(C, 0)        # near each block's range
    hi = np.sort(tex, 1)[:, -3].repeat(C, 0)
    return pt, tex, grid.astype(np.int32), dm, wq, lo, hi, C, rng


def _lane_stencils(pt, dm, wq):
    Mint, Mf32, incid, wvalid, color_of, pn = (
        t.numpy() for t in trefine._lane_tables(pt, torch.from_numpy(dm),
                                                torch.from_numpy(wq)))
    return Mint, Mf32, incid, wvalid, color_of, pn


def _check_round(got, want, grids):
    same = np.ones(got["err_pre"].shape, bool)
    for g in grids:
        same &= (got[g].numpy() == want[g]).all(1)
    assert same.mean() >= 0.99, same.mean()
    for k in ("err_pre", "err_post"):
        np.testing.assert_allclose(got[k].numpy()[same], want[k][same],
                                   rtol=3e-4)
    np.testing.assert_array_equal(got["adjusted"].numpy()[same],
                                  want["adjusted"][same])


def test_k5_plain_matches_jax_round(ctxs):
    """K5's plain version at pc 2 against JAX's trial error, grouped
    realign and infill (trial.py:675-713), and its bootstrap infill."""
    _, tctx = ctxs
    pt, tex, grid, dm, wq, lo, hi, C, rng = _round_inputs(tctx, "full", 3)
    N, T, _ = tex.shape
    NC = N * C
    pot = rng.integers(0, 2, (N, T)).astype(np.int32)
    ep0 = np.floor(lo[:, None, :] + rng.uniform(-2e3, 2e3, (NC, 4, 4)))
    ep1 = np.floor(hi[:, None, :] + rng.uniform(-2e3, 2e3, (NC, 4, 4)))
    ep0 = np.clip(ep0, 0, 65535).astype(np.int32)
    ep1 = np.clip(ep1, 0, 65535).astype(np.int32)
    alive = rng.uniform(size=NC) < 0.9
    args = [torch.from_numpy(a) for a in (grid, dm, wq, alive, ep0, ep1, tex,
                                          pot)]
    got = trefine.refine_round_1plane_plain(pt, *args, C, pt.ncolors, False,
                                            CW)
    boot = trefine.refine_round_1plane_plain(pt, *args, C, 0, False, CW)

    Mint, Mf32, incid, wvalid, color_of, pn = _lane_stencils(pt, dm, wq)
    tex_f = jnp.asarray(np.repeat(tex, C, 0))
    pmask = jnp.asarray(np.repeat(pot[..., None] == np.arange(4), C, 0)
                        .astype(np.float32))

    @jax.jit
    def jround(grid, e0, e1):
        err = functools.partial(
            jtrial.trial_error_1plane, tex_f, pmask, None, None,
            Mint=jnp.asarray(Mint), cw=CW, profile=PROFILE, u8_mask=False,
            ep=(e0, e1))
        new, adj = jrealign.realign_decimated_grouped(
            grid, tex_f, pmask, e0, e1, CW, jnp.asarray(pt.weight_prev_next
                                                        .numpy()),
            jnp.asarray(wq), jnp.asarray(Mf32), jnp.asarray(incid),
            jnp.asarray(wvalid), jnp.asarray(color_of), pt.ncolors)
        a = jnp.asarray(alive)
        new = jnp.where(a[:, None], new, grid)
        return {"grid": new, "adjusted": adj & a, "err_pre": err(grid),
                "err_post": err(new),
                "undec": jnp.einsum("ntw,nw->nt", jnp.asarray(Mf32),
                                    new.astype(jnp.float32)) / 64.0}

    want = {k: np.asarray(v) for k, v in jround(
        jnp.asarray(grid), jnp.asarray(ep0.astype(np.float32)),
        jnp.asarray(ep1.astype(np.float32))).items()}
    _check_round(got, want, ("grid",))
    same = (got["grid"].numpy() == want["grid"]).all(1)
    np.testing.assert_array_equal(got["undec"].numpy()[same],
                                  want["undec"][same])
    np.testing.assert_array_equal(
        boot["undec"].numpy(),
        np.einsum("ntw,nw->nt", Mf32, grid.astype(np.float32)) / 64.0)
    assert got["adjusted"].numpy().mean() > 0.3
