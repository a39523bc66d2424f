"""astcenc_torch 2-plane HDR trials against the JAX package's XLA path on
the CPU, at profile 2 (-ch): the folded records of trial2_records (the HDR
refit, the HDR pack and the plain versions of kernels K6 and K7 between
rounds) at the tests/test_pallas.py bounds, and the plain versions of K6
and K7 against JAX's XLA round pieces. One JAX HDR trial program compiles
here, a minute or two on a CPU.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from astcenc_tpu import api as japi
from astcenc_tpu.codec import compress as jc
from astcenc_tpu.codec import trial as jtrial
from astcenc_tpu.ops import realign as jrealign
from astcenc_torch.codec import compress as tc
from astcenc_torch.codec import trial as ttrial
from astcenc_torch.ops import refine as trefine
from test_torch_hdr_trial1 import (  # noqa: F401 (ctxs is a fixture)
    CW, PROFILE, _agree, _check_round, _lane_stencils, _round_inputs,
    _texels, ctxs)

torch.set_num_threads(1)


def test_trial2_records_hdr_match_jax(ctxs):
    """All four plane-2 components, folded into one batch."""
    jctx, tctx = ctxs
    tex = _texels(tctx)
    N = tex.shape[0]
    ext = np.ones((N, 4), bool)
    ext[-3:, 1] = False
    ql = np.full((N,), 11, np.int32)
    ql[::5] = 7
    cfgs = jc._CfgStatic(jctx.config)
    st = jc.make_block_state(jnp.asarray(tex), cfgs.channel_weights, PROFILE)
    rx = jc._trial2_recs_jit(japi._enc_key(jctx.bsd), cfgs, PROFILE, False,
                             st, jnp.asarray(ext), jnp.asarray(ql))
    rx = {k: np.asarray(v) for k, v in rx.items()}
    tst = tc.make_block_state(torch.from_numpy(tex), PROFILE)
    rk = ttrial.trial2_records(tst, tctx.pass_tables("two"), tctx.config,
                               PROFILE, False, torch.from_numpy(ql),
                               torch.from_numpy(ext))
    rk = {k: v.numpy() for k, v in rk.items()}
    # One block's round-0 refit differs from JAX's in its last bits (texel
    # sums in another order) and packs one value a step apart, in all
    # four components: 7 of its 1,869 live records differ by 0.2%.
    _agree(rk, rx, ("fmt", "vals", "mode", "q", "w1_64", "w2_64"),
           within=0.99)


def test_k6_k7_plain_match_jax_round(ctxs):
    """K6's plain version against JAX's 2-plane round pieces
    (trial.py:1237-1282) and K7's against the two infills."""
    _, tctx = ctxs
    pt, tex, g1, dm, wq, lo, hi, C, rng = _round_inputs(tctx, "two", 4)
    g2 = np.roll(g1, 1, 0)
    N0 = tex.shape[0]
    N = 2 * N0                        # two folded components per block
    C = g1.shape[0] // N
    NC = N * C
    p2c = np.concatenate([np.full(N0, 3), rng.integers(0, 3, N0)]).astype(
        np.int32)
    e0 = np.clip(np.floor(lo + rng.uniform(-2e3, 2e3, (NC, 4))), 0,
                 65535).astype(np.int32)
    e1 = np.clip(np.floor(hi + rng.uniform(-2e3, 2e3, (NC, 4))), 0,
                 65535).astype(np.int32)
    alive = rng.uniform(size=NC) < 0.9
    args = [torch.from_numpy(a) for a in (g1, g2, dm, wq, alive, p2c, e0, e1,
                                          tex)]
    got = trefine.refine_round_2plane_plain(pt, *args, C, pt.ncolors, False,
                                            CW)
    boot = trefine.refine_round_2plane_plain(pt, *args, C, 0, False, CW)

    Mint, Mf32, incid, wvalid, color_of, pn = _lane_stencils(pt, dm, wq)
    rows = np.arange(N) % N0
    tex_f = jnp.asarray(np.repeat(tex[rows], C, 0))
    p2c_f = np.repeat(p2c, C)
    p2lanes = jnp.asarray(np.arange(4)[None] == p2c_f[:, None])
    pmask = jnp.ones(tex_f.shape[:2] + (1,), jnp.float32)

    @jax.jit
    def jround(w1, w2, d0, d1):
        d0f, d1f = d0.astype(jnp.float32), d1.astype(jnp.float32)
        ep_t = (jnp.broadcast_to(d0f[:, None], tex_f.shape),
                jnp.broadcast_to(d1f[:, None], tex_f.shape))

        def err(a, b):
            return jtrial.trial_error_2plane(
                tex_f, None, None, a, b, jnp.asarray(p2c_f),
                jnp.asarray(Mint), CW, PROFILE, False, ep=(d0f, d1f))

        def realign(w, mask):
            return jrealign.realign_decimated_grouped(
                w, tex_f, pmask, d0[:, None], d1[:, None], CW,
                jnp.asarray(pt.weight_prev_next.numpy()), jnp.asarray(wq),
                jnp.asarray(Mf32), jnp.asarray(incid), jnp.asarray(wvalid),
                jnp.asarray(color_of), pt.ncolors, plane_mask=mask,
                ep_t=ep_t)

        n1, a1 = realign(w1, p2lanes)
        n2, a2 = realign(w2, ~p2lanes)
        a = jnp.asarray(alive)
        n1 = jnp.where(a[:, None], n1, w1)
        n2 = jnp.where(a[:, None], n2, w2)
        return {"grid1": n1, "grid2": n2, "adjusted": (a1 | a2) & a,
                "err_pre": err(w1, w2), "err_post": err(n1, n2)}

    want = {k: np.asarray(v) for k, v in jround(
        jnp.asarray(g1), jnp.asarray(g2), jnp.asarray(e0),
        jnp.asarray(e1)).items()}
    _check_round(got, want, ("grid1", "grid2"))
    for g, u in (("grid1", "undec1"), ("grid2", "undec2")):
        np.testing.assert_array_equal(
            got[u].numpy(),
            np.einsum("ntw,nw->nt", Mf32,
                      got[g].numpy().astype(np.float32)) / 64.0)
    for g, u in ((g1, "undec1"), (g2, "undec2")):
        np.testing.assert_array_equal(
            boot[u].numpy(),
            np.einsum("ntw,nw->nt", Mf32, g.astype(np.float32)) / 64.0)
