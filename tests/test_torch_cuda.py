"""astcenc_torch kernels K1-K7 and K9 against their plain PyTorch versions
on a CUDA card, and encodes through the kernels against the plain path.
Needs a card (the kernels have no CPU build) and no jax, so it also runs
where jax is missing:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from astcenc_torch import api, testdata
from astcenc_torch.codec import compress as tc
from astcenc_torch.codec import partition_search
from astcenc_torch.codec import trial
from astcenc_torch.ops import msearch, psearch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _slice_cfg():
    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    cfg.tune_partition_count_limit = 1
    cfg.tune_2plane_early_out_limit_correlation = 0.0
    return cfg


def _medium_ctx(dev):
    return api.context_alloc(api.config_init(
        api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0), device=dev)


def _check_msearch(got, want):
    """tests/test_pallas.py::_check_agreement bounds."""
    g = {k: v.cpu().numpy() for k, v in got.items()}
    w = {k: v.cpu().numpy() for k, v in want.items()}
    same = g["mode"] == w["mode"]
    assert same.mean() > 0.96
    rel = np.abs(g["err"][same] - w["err"][same]) / np.maximum(
        np.abs(w["err"][same]), 1.0)
    assert np.median(rel) < 1e-5 and np.percentile(rel, 95) < 1e-3
    for k in ("dm", "wq", "valid"):
        np.testing.assert_array_equal(g[k][same], w[k][same], err_msg=k)
    for k in ("cq", "cqm", "fmt"):
        assert (g[k][same] == w[k][same]).mean() > 0.99, k
    for k in ("uq", "uq2"):
        if k in w:
            assert (g[k][same] == w[k][same]).mean() > 0.995, k


def _ms_inputs(rng, N, T, dev, S=4, pc=1, two=False):
    a = [rng.rand(N, T).astype(np.float32),
         rng.rand(N, T).astype(np.float32) * 1e8,
         rng.rand(N).astype(np.float32) * 2.0,
         rng.randint(5, 12, (N,)).astype(np.int32),
         rng.rand(N, 21, S).astype(np.float32) * 1e9,
         rng.randint(0, 16, (N, 21, 4) if pc == 1 else (N, 21, S, pc)
                     ).astype(np.int32)]
    a = [torch.from_numpy(x).to(dev) for x in a]
    kw = {}
    if two:
        kw = {"wei2": torch.from_numpy(rng.rand(N, T).astype(np.float32)).to(
                  dev),
              "wes2": torch.from_numpy(
                  rng.rand(N, T).astype(np.float32) * 1e8).to(dev),
              "mcut2": torch.from_numpy(
                  rng.rand(N).astype(np.float32) * 2.0).to(dev)}
    return a, kw


def test_msearch_kernel_matches_plain(cuda_device):
    """K1, 1 plane, 1 partition, random inputs."""
    pt = api.context_alloc(_slice_cfg(), device=cuda_device).pass_tables(
        "full")
    a, _ = _ms_inputs(np.random.RandomState(9), 4096, 36, cuda_device)
    _check_msearch(msearch.mode_search_cuda(pt, *a, 3),
                   msearch.mode_search_plain(pt, *a, 3))


def test_msearch_kernel_two_planes(cuda_device):
    """K1 with two planes (the 2-plane modes, plane-2 cutoffs)."""
    pt = _medium_ctx(cuda_device).pass_tables("two")
    a, kw = _ms_inputs(np.random.RandomState(10), 4096, 36, cuda_device,
                       two=True)
    got = msearch.mode_search_cuda(pt, *a, 3, **kw)
    assert "uq2" in got
    _check_msearch(got, msearch.mode_search_plain(pt, *a, 3, **kw))


@pytest.mark.parametrize("pc", [2, 3, 4])
def test_msearch_kernel_partitions(cuda_device, pc):
    """K1 over 2-4 partitions (combined tables, matched-format quant)."""
    pt = _medium_ctx(cuda_device).pass_tables("full", pc)
    S = {2: 7, 3: 10, 4: 13}[pc]
    a, _ = _ms_inputs(np.random.RandomState(11 + pc), 4096, 36, cuda_device,
                      S=S, pc=pc)
    _check_msearch(msearch.mode_search_cuda(pt, *a, 3),
                   msearch.mode_search_plain(pt, *a, 3))


def _check_records(rk, rx, keys):
    """tests/test_pallas.py:322-339 bounds on the trial records."""
    live = rx["err"] < 1e29
    np.testing.assert_allclose(rk["err"][live], rx["err"][live], rtol=3e-4)
    wk, wx = rk["err"].argmin(1), rx["err"].argmin(1)
    assert (wk == wx).mean() > 0.9
    same = wk == wx
    for k in keys:
        a, b = rk[k][same], rx[k][same]
        idx = wk[same].reshape((-1, 1) + (1,) * (a.ndim - 2))
        assert (np.take_along_axis(a, idx, 1)
                == np.take_along_axis(b, idx, 1)).mean() > 0.97, k


def _random_texels(N, seed, dev):
    rng = np.random.RandomState(seed)
    tex = np.floor(rng.rand(N, 36, 4) * 255.0).astype(np.float32) * 257.0
    tex[:N // 4, :, 3] = 65535.0
    return tc.make_block_state(torch.from_numpy(tex).to(dev), 1)


def test_trial_records_kernels_match_plain(cuda_device):
    """K2, 1 partition."""
    ctx = api.context_alloc(_slice_cfg(), device=cuda_device)
    N = 4096
    st = _random_texels(N, 5, cuda_device)
    ql = torch.full((N,), 11, dtype=torch.int32, device=cuda_device)
    ext = torch.ones(N, dtype=torch.bool, device=cuda_device)
    rk, rx = ({k: v.cpu().numpy() for k, v in trial.trial1_records(
        st, ctx.pass_tables("full"), ctx.config, 1, False, ql, ext,
        use_kernels=k).items()} for k in (True, False))
    _check_records(rk, rx, ("fmt", "vals", "mode", "useq", "w64"))


@pytest.mark.parametrize("pc", [2, 3, 4])
def test_trial_records_kernels_partitions(cuda_device, pc):
    """K2 over 2-4 partitions, on random partitionings of the table."""
    ctx = _medium_ctx(cuda_device)
    N = 2048
    st = _random_texels(N, 20 + pc, cuda_device)
    tabs = ctx.partition_tables(pc)
    rows = torch.from_numpy(np.random.RandomState(pc).randint(
        0, tabs.count_selected, N)).to(cuda_device)
    ql = torch.full((N,), 11, dtype=torch.int32, device=cuda_device)
    ext = torch.ones(N, dtype=torch.bool, device=cuda_device)
    rk, rx = ({k: v.cpu().numpy() for k, v in trial.trial1_records(
        st, ctx.pass_tables("full", pc), ctx.config, 1, False, ql, ext,
        pot=tabs.pot[rows], counts=tabs.counts[rows],
        use_kernels=k).items()} for k in (True, False))
    _check_records(rk, rx, ("fmt", "vals", "mode", "useq", "match", "w64"))


def _trial2_inputs(dev, seed=7, N=1024):
    ctx = _medium_ctx(dev)
    st = _random_texels(N, seed, dev)
    ql = torch.full((N,), 11, dtype=torch.int32, device=dev)
    ext = torch.ones((N, 4), dtype=torch.bool, device=dev)
    return ctx, (st, ctx.pass_tables("two"), ctx.config, 1, False, ql, ext)


def test_trial2_records_kernels_match_plain(cuda_device):
    """K1 (two planes) and K3 through trial2_records. A K1 grid that differs
    in one weight (K1's own bound allows 0.5%) changes that candidate's
    pre-realign error by percents, so the record errors are held to 3e-4
    on the candidates whose mode and starting grids agree, and those must
    be at least 99.5% of the live candidates."""
    _, args = _trial2_inputs(cuda_device)
    rk, rx = ({k: v.cpu().numpy() for k, v in trial.trial2_records(
        *args, use_kernels=k).items()} for k in (True, False))
    NB, CK = rx["err"].shape
    R = args[2].tune_refinement_limit
    C = CK // (R + 1)

    def per_cand(a):
        return a.reshape((NB, C, R + 1) + a.shape[2:])

    start = ((per_cand(rk["mode"]) == per_cand(rx["mode"])).all(2)
             & (per_cand(rk["w1_64"])[:, :, 0] == per_cand(rx["w1_64"])[:, :, 0]
                ).all(-1)
             & (per_cand(rk["w2_64"])[:, :, 0] == per_cand(rx["w2_64"])[:, :, 0]
                ).all(-1))
    live_c = (per_cand(rx["err"]) < 1e29).any(2)
    assert start[live_c].mean() >= 0.995
    live = (rx["err"] < 1e29) & np.repeat(start, R + 1, 1)
    np.testing.assert_allclose(rk["err"][live], rx["err"][live], rtol=3e-4)
    wk, wx = rk["err"].argmin(1), rx["err"].argmin(1)
    assert (wk == wx).mean() > 0.9
    same = wk == wx
    for k in ("fmt", "vals", "mode", "q", "w1_64", "w2_64"):
        a, b = rk[k][same], rx[k][same]
        idx = wk[same].reshape((-1, 1) + (1,) * (a.ndim - 2))
        assert (np.take_along_axis(a, idx, 1)
                == np.take_along_axis(b, idx, 1)).mean() > 0.97, k


def test_trial2_refine_kernel_matches_plain(cuda_device):
    """K3 alone, on the inputs the plain mode search gives trial2_records:
    every record within 3e-4, payloads at the record bounds."""
    from astcenc_torch.ops import refine
    _, args = _trial2_inputs(cuda_device, seed=17)
    seen = {}
    orig = refine.trial2_refine

    def grab(*a, **kw):
        seen.setdefault("args", a)
        return orig(*a, **kw)

    refine.trial2_refine = grab
    try:
        trial.trial2_records(*args, use_kernels=False)
    finally:
        refine.trial2_refine = orig
    a = seen["args"]
    got = refine.trial2_refine_cuda(*a)
    want = refine.trial2_refine_plain(*a)
    g = {k: v.cpu().numpy() for k, v in got.items()}
    w = {k: v.cpu().numpy() for k, v in want.items()}
    for k in ("err_pre", "err_post"):
        live = w[k] < 1e29
        np.testing.assert_array_equal(g[k] < 1e29, live)
        np.testing.assert_allclose(g[k][live], w[k][live], rtol=3e-4)
    for k in ("fmt", "vals", "w1post", "w2post"):
        assert (g[k] == w[k]).mean() >= 0.97, k


@pytest.mark.parametrize("pc", [2, 3, 4])
def test_psearch_kernel_matches_plain(cuda_device, pc):
    """K4 line errors and the candidate seeds they select."""
    ctx = _medium_ctx(cuda_device)
    N = 2048
    st = _random_texels(N, 30 + pc, cuda_device)
    tabs = ctx.partition_tables(pc)
    S = min(34, tabs.count_selected)
    top = torch.from_numpy(np.random.RandomState(pc).randint(
        0, tabs.count_selected, (N, S)).astype(np.int32)).to(cuda_device)
    ua = st["uses_alpha"].to(torch.int32)
    args = (st["texels"], ua, top, tabs.pot, tabs.counts, pc, 0.05 ** 2,
            (1.0, 1.0, 1.0, 1.0))
    uk, sk = psearch.line_errors_cuda(*args)
    ux, sx = psearch.line_errors_plain(*args)
    torch.testing.assert_close(uk, ux, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(sk, sx, rtol=1e-4, atol=0.0)
    sel_k = partition_search.select_candidates(uk, sk, tabs.seed,
                                               top.long(), 2)
    sel_x = partition_search.select_candidates(ux, sx, tabs.seed,
                                               top.long(), 2)
    assert (sel_k[0] == sel_x[0]).float().mean() >= 0.99
    assert (sel_k[1] == sel_x[1]).float().mean() >= 0.99


def test_encode_kernels_match_plain(cuda_device):
    """A 96x96 encode of the 1-partition 1-plane configuration through the
    kernels and through the plain versions."""
    ctx = api.context_alloc(_slice_cfg(), device=cuda_device)
    img = testdata.synthetic_image(96, 96, 3)
    got = api.compress_image(ctx, img)
    want = tc.compress_image(ctx, img, use_kernels=False)
    assert (got == want).all(1).mean() >= 0.9


def _hdr_ctx(dev, profile=api.Profile.HDR_RGB_LDR_A):
    return api.context_alloc(api.config_init(
        profile, 6, 6, 1, api.Quality.MEDIUM, 0), device=dev)


def _hdr_state(ctx, seed, dev, side=96):
    img = testdata.synthetic_hdr_image(side, side, seed,
                                       independent_alpha=True)
    tex = torch.from_numpy(tc.image_to_blocks(ctx, img)).to(dev)
    return tc.make_block_state(tex, int(ctx.config.profile))


def _first_calls(mod, name, run, key):
    """Run ``run()`` with ``mod.name`` wrapped; the arguments of the first
    call of each form, by ``key(args)``."""
    seen = {}
    orig = getattr(mod, name)

    def wrap(*a, **kw):
        seen.setdefault(key(a), a)
        return orig(*a, **kw)

    setattr(mod, name, wrap)
    try:
        run()
    finally:
        setattr(mod, name, orig)
    return seen


def _check_round(got, want, grids):
    """K5/K6 against the plain version: grids identical on >= 99.9% of the
    lanes, errors within 3e-4, infills equal on those lanes."""
    same = torch.ones_like(want["err_pre"], dtype=torch.bool)
    for g in grids:
        same &= (got[g] == want[g]).all(1)
    assert same.float().mean() >= 0.999
    for k in ("err_pre", "err_post"):
        torch.testing.assert_close(got[k][same], want[k][same], rtol=3e-4,
                                   atol=0.0)
    assert (got["adjusted"][same] == want["adjusted"][same]).all()
    for u in [k for k in want if k.startswith("undec")]:
        assert (got[u][same] == want[u][same]).all()


@pytest.mark.parametrize("pc", [1, 2])
def test_refine_round_kernel_matches_plain(cuda_device, pc):
    """K5 (and its bootstrap) on the inputs the plain path gives a 1-plane
    HDR trial."""
    from astcenc_torch.ops import refine
    ctx = _hdr_ctx(cuda_device)
    st = _hdr_state(ctx, 40 + pc, cuda_device)
    N = st["texels"].shape[0]
    ql = torch.full((N,), 11, dtype=torch.int32, device=cuda_device)
    ext = torch.ones(N, dtype=torch.bool, device=cuda_device)
    kw = {}
    if pc > 1:
        tabs = ctx.partition_tables(pc)
        rows = torch.from_numpy(np.random.RandomState(pc).randint(
            0, tabs.count_selected, N)).to(cuda_device)
        kw = {"pot": tabs.pot[rows], "counts": tabs.counts[rows]}
    seen = _first_calls(
        refine, "refine_round_1plane",
        lambda: trial.trial1_records(st, ctx.pass_tables("full", pc),
                                     ctx.config, 2, False, ql, ext,
                                     use_kernels=False, **kw),
        lambda a: a[10] > 0)
    for realign in (False, True):                  # bootstrap, then a round
        a = seen[realign]
        _check_round(refine.refine_round_1plane_cuda(*a),
                     refine.refine_round_1plane_plain(*a), ("grid",))


def test_refine_round2_kernels_match_plain(cuda_device):
    """K6 and K7 on the inputs the plain path gives the folded 2-plane HDR
    trial."""
    from astcenc_torch.ops import refine
    ctx = _hdr_ctx(cuda_device)
    st = _hdr_state(ctx, 50, cuda_device)
    N = st["texels"].shape[0]
    ql = torch.full((N,), 11, dtype=torch.int32, device=cuda_device)
    ext = torch.ones((N, 4), dtype=torch.bool, device=cuda_device)
    seen = _first_calls(
        refine, "refine_round_2plane",
        lambda: trial.trial2_records(st, ctx.pass_tables("two"), ctx.config,
                                     2, False, ql, ext, use_kernels=False),
        lambda a: a[11] > 0)
    a = seen[True]
    _check_round(refine.refine_round_2plane_cuda(*a),
                 refine.refine_round_2plane_plain(*a), ("grid1", "grid2"))
    a = seen[False]
    got = refine.refine_round_2plane_cuda(*a)
    want = refine.refine_round_2plane_plain(*a)
    for u in ("undec1", "undec2"):
        assert (got[u] == want[u]).all()


def test_quant_lookup_kernel_matches_plain(cuda_device):
    """K9, bit for bit, clamping included."""
    from astcenc_torch.ops import gather
    rng = np.random.RandomState(12)
    q = torch.from_numpy(rng.randint(-2, 19, 70000).astype(np.int32)).to(
        cuda_device)
    v = torch.from_numpy(rng.randint(-20, 280, (70000, 9)).astype(
        np.int32)).to(cuda_device)
    assert (gather.quant_lookup_cuda(q, v)
            == gather.quant_lookup_plain(q, v)).all()


def test_hdr_encode_kernels_match_plain(cuda_device):
    """A 96x96 -cH (HDR alpha) encode through the kernels and through the
    plain versions; HDR endpoint formats, HDR alpha (15) among them."""
    from astcenc_torch.codec import decompress
    ctx = _hdr_ctx(cuda_device, api.Profile.HDR)
    img = testdata.synthetic_hdr_image(96, 96, 3, independent_alpha=True)
    got = api.compress_image(ctx, img)
    want = tc.compress_image(ctx, img, use_kernels=False)
    assert (got == want).all(1).mean() >= 0.99
    fmts = decompress.endpoint_formats(ctx.torch_decode_tables(),
                                       torch.from_numpy(got).to(cuda_device))
    assert (fmts == 15).any()


def test_main_path_encode_kernels_match_plain(cuda_device):
    """A 96x96 6x6 -medium encode (every stage) through the kernels and
    through the plain versions."""
    ctx = _medium_ctx(cuda_device)
    img = testdata.synthetic_image(96, 96, 3, independent_alpha=True)
    got = api.compress_image(ctx, img)
    want = tc.compress_image(ctx, img, use_kernels=False)
    assert (got == want).all(1).mean() >= 0.99
