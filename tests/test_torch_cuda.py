"""astcenc_torch kernels K1-K8, the colour pack kernel (K9), the texel-sum
kernel and the colour decode kernel against their plain PyTorch versions
on a CUDA card, and encodes through the kernels against the plain path
and with the refinement kernels switched off; the card's blocks against the JAX package's, from committed NumPy fixtures
(tests/data/torch_ldr, tests/data/torch_hdr); and the port's divisions by
constants on the card against the CPU's. Needs a card (the kernels have no
CPU build) and no jax, so it also runs where jax is missing:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from astcenc_torch import api, obs, testdata
from astcenc_torch.codec import compress as tc
from astcenc_torch.codec import partition_search
from astcenc_torch.codec import trial
from astcenc_torch.ops import msearch, psearch
from astcenc_torch.utils import metrics

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


@pytest.fixture
def launched():
    """``launched(kernel)``: the launches of ``kernel`` that the program's
    launch counters (``obs``) counted since the last call."""
    obs.collect()
    obs.enable()
    yield lambda kernel: obs.collect().counters.get("launch." + kernel, 0)
    obs.disable()
    obs.collect()


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


@pytest.mark.parametrize("profile", [0, 2, 3])
def test_color_pack_kernel_matches_plain(cuda_device, launched, profile):
    """The colour pack kernel against the plain pack, bit for bit, on the
    seeded batch with the pack's corner cases (testdata.pack_batch: every
    format at every quant level, endpoints at 0 and 65535, major-component
    ties, rgbo vectors at each mode cutoff): one launch per pack call,
    through both routers."""
    from astcenc_torch.ops import color_pack as cp
    from astcenc_torch.ops import color_pack_hdr as cph
    b = [torch.from_numpy(a).to(cuda_device)
         for a in testdata.pack_batch(30 + profile, 20000, corners=True)]
    launched("color_pack")
    got = cph.pack_color_endpoints(profile, *b)
    assert launched("color_pack") == 1
    want = cph.pack_color_endpoints_plain(profile, *b)
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    got = cp.pack_color_endpoints_ldr(b[0], b[1], b[2], b[4], b[5])
    assert launched("color_pack") == 1
    want = cp.pack_color_endpoints_ldr_plain(b[0], b[1], b[2], b[4], b[5])
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()


@pytest.mark.parametrize("profile", [0, 1, 2, 3])
def test_color_unpack_kernel_matches_plain(cuda_device, launched, profile):
    """The colour decode kernel against the plain decode, bit for bit on
    all four outputs, on testdata.unpack_batch's rows (every format with
    all values 0 and all 255, every mode of the HDR RGB, RGB scale and
    alpha decodes, seeded rows) as (N, pc) with N * pc >= 100,000 and a
    ragged last thread block: one launch per call, none with
    ``use_kernel=False``."""
    from astcenc_torch.ops import color_unquant as cuq
    N, pc = 25013, 4
    fmt, vals = (torch.from_numpy(a).to(cuda_device)
                 for a in testdata.unpack_batch(50 + profile, N * pc))
    fmt, vals = fmt.reshape(N, pc), vals.reshape(N, pc, 8)
    assert set(fmt.unique().tolist()) == set(range(16))
    launched("color_unpack")
    got = cuq.unpack_color_endpoints(profile, fmt, vals)
    assert launched("color_unpack") == 1
    want = cuq.unpack_color_endpoints_plain(profile, fmt, vals)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g == w).all()
    plain = cuq.unpack_color_endpoints(profile, fmt, vals, use_kernel=False)
    assert launched("color_unpack") == 0
    assert all((p == w).all() for p, w in zip(plain, want))


def test_hdr_ch_crop_kernels_match_plain(cuda_device):
    """A 256x256 -ch crop through the kernels (the colour pack kernel on
    every pack) and through the plain versions: every block identical."""
    ctx = _hdr_ctx(cuda_device)
    img = testdata.synthetic_hdr_image(256, 256, 4, independent_alpha=True)
    got = api.compress_image(ctx, img)
    want = tc.compress_image(ctx, img, use_kernels=False)
    assert (got == want).all()


def test_refine_off_ldr_crop_kernels_match_plain(cuda_device, monkeypatch):
    """A 256x256 LDR crop with the refinement kernels off (the plain
    refinement, its realign lookups on K8 and its packs on the colour pack
    kernel) against the plain versions: every block identical."""
    ctx = _medium_ctx(cuda_device)
    img = testdata.synthetic_image(256, 256, 5, independent_alpha=True)
    got, n = _refine_off(monkeypatch, ctx, img)
    assert n["K8"] > 0 and n["K9"] > 0, n
    want = tc.compress_image(ctx, img, use_kernels=False)
    assert (got == want).all()


def test_hdr_encode_kernels_match_plain(cuda_device, launched):
    """A 96x96 -cH (HDR alpha) encode through the kernels (the colour
    decode kernel among them) and through the plain versions; HDR endpoint
    formats, HDR alpha (15) among them."""
    from astcenc_torch.codec import decompress
    ctx = _hdr_ctx(cuda_device, api.Profile.HDR)
    img = testdata.synthetic_hdr_image(96, 96, 3, independent_alpha=True)
    launched("color_unpack")
    got = api.compress_image(ctx, img)
    assert launched("color_unpack") > 0
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


@pytest.mark.parametrize("itype", ["int32", "int64"])
@pytest.mark.parametrize("dtype,C", [("int32", None), ("int32", 2),
                                     ("float32", None), ("float32", 2)])
def test_row_gather_kernel_matches_plain(cuda_device, launched, dtype, C,
                                        itype):
    """K8, bit for bit, with int32 and int64 indices: out-of-range indices,
    and float32 NaN payloads, +-Inf, -0.0 and denormals."""
    from astcenc_torch.ops import gather
    rng = np.random.RandomState(13)
    shape = (3000, 300) + ((C,) if C else ())
    if dtype == "int32":
        rows = rng.randint(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
            np.int32)
    else:
        rows = (rng.standard_normal(shape) * 1e3).astype(np.float32)
        flat = rows.reshape(-1).view(np.uint32)
        bits = np.array([0x7FC00000, 0xFFC12345, 0x7F800001, 0x7F800000,
                         0xFF800000, 0x80000000, 0x00000001, 0x807FFFFF],
                        np.uint32)
        flat[rng.choice(flat.size, 800, replace=False)] = np.tile(bits, 100)
    idx = rng.randint(-40, 340, (3000, 200)).astype(itype)
    if itype == "int64":
        idx[::97, 3] = -2 ** 40                # clamped in 64 bits
        idx[1::97, 5] = 2 ** 40
    r = torch.from_numpy(rows).to(cuda_device)
    i = torch.from_numpy(idx).to(cuda_device)
    launched("row_gather")
    got = gather.row_lookup(r, i)
    assert launched("row_gather") == 1
    want = gather.row_lookup_plain(r, i)
    assert got.dtype == r.dtype and got.shape == want.shape
    if dtype == "float32":
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert (got == want).all()


def _refine_off(monkeypatch, ctx, img, value="refine"):
    """Encode with ASTC_DISABLE_KERNELS=value; the blocks and the launches
    of every kernel during that encode (the program's launch counters)."""
    kernels = {"K1": "msearch", "K2": "refine", "K3": "refine2",
               "K4": "psearch", "K5": "refine_round", "K6": "refine_round2",
               "K7": "refine_boot2", "K8": "row_gather", "K9": "color_pack"}
    obs.collect()
    obs.enable()
    try:
        with monkeypatch.context() as m:
            m.setenv("ASTC_DISABLE_KERNELS", value)
            blocks = api.compress_image(ctx, img)
        counts = obs.collect().counters
    finally:
        obs.disable()
    return blocks, {k: counts.get("launch." + n, 0)
                    for k, n in kernels.items()}


def test_refine_off_ldr_crop_matches_fused(cuda_device, monkeypatch):
    """A 256x256 synthetic texture at 6x6 -medium with the refinement
    kernels off: no K2/K3 launch, K8 and K9 launched, the fused encode's
    blocks."""
    ctx = _medium_ctx(cuda_device)
    img = testdata.synthetic_image(256, 256, 0, independent_alpha=True)
    want = api.compress_image(ctx, img)
    got, n = _refine_off(monkeypatch, ctx, img)
    assert n["K2"] == 0 and n["K3"] == 0, n
    assert n["K8"] > 0 and n["K9"] > 0 and n["K1"] > 0, n
    assert (got == want).all()


def test_refine_off_hdr_crop_matches_fused(cuda_device, monkeypatch):
    """A 256x256 synthetic HDR texture at -ch with the refinement kernels
    off: no K5-K7 launch, K8 launched, the fused encode's blocks."""
    ctx = _hdr_ctx(cuda_device)
    img = testdata.synthetic_hdr_image(256, 256, 0, independent_alpha=True)
    want = api.compress_image(ctx, img)
    got, n = _refine_off(monkeypatch, ctx, img)
    assert n["K5"] == 0 and n["K6"] == 0 and n["K7"] == 0, n
    assert n["K8"] > 0 and n["K9"] > 0, n
    assert (got == want).all()


def _footprint_inputs(dev, bx, quality, kind, pc, n_blocks, seed):
    """The arguments the plain trial front end hands the mode search (K1)
    and the 1-plane (K2) or 2-plane refinement (K3) on their first call,
    for a seeded synthetic image at a bx x bx footprint and a preset; for
    pc >= 2 on seeded partitionings of the partition table."""
    from astcenc_torch.ops import refine
    ctx = api.context_alloc(api.config_init(
        api.Profile.LDR, bx, bx, 1, getattr(api.Quality, quality), 0),
        device=dev)
    img = testdata.synthetic_image(bx * 8, bx * (-(-n_blocks // 8)), seed,
                                   independent_alpha=True)
    tex = torch.from_numpy(tc.image_to_blocks(ctx, img)[:n_blocks]).to(dev)
    st = tc.make_block_state(tex, 0)
    N = tex.shape[0]
    ql = torch.full((N,), 11, dtype=torch.int32, device=dev)
    seen = {}
    saved = {(m, n): getattr(m, n) for m, n in ((msearch, "mode_search"),
                                                (refine, "trial1_refine"),
                                                (refine, "trial2_refine"))}

    def grab(key, fn):
        def wrap(*a, **kw):
            seen.setdefault(key, (a, {k: v for k, v in kw.items()
                                      if k != "use_kernel"}))
            return fn(*a, **kw)
        return wrap

    msearch.mode_search = grab("K1", saved[(msearch, "mode_search")])
    refine.trial1_refine = grab("K2", saved[(refine, "trial1_refine")])
    refine.trial2_refine = grab("K3", saved[(refine, "trial2_refine")])
    try:
        if kind == "two":
            ext = torch.ones((N, 4), dtype=torch.bool, device=dev)
            trial.trial2_records(st, ctx.pass_tables("two"), ctx.config, 0,
                                 False, ql, ext, use_kernels=False)
        else:
            ext = torch.ones(N, dtype=torch.bool, device=dev)
            kw = {}
            if pc > 1:
                tabs = ctx.partition_tables(pc)
                rows = torch.from_numpy(np.random.RandomState(seed).randint(
                    0, tabs.count_selected, N)).to(dev)
                kw = {"pot": tabs.pot[rows], "counts": tabs.counts[rows]}
            trial.trial1_records(st, ctx.pass_tables("full", pc), ctx.config,
                                 0, False, ql, ext, use_kernels=False, **kw)
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    return seen


@pytest.mark.parametrize("bx,quality,kind,pc", [
    (4, "FASTEST", "full", 1), (4, "FASTEST", "two", 1),
    (8, "THOROUGH", "full", 1), (8, "THOROUGH", "two", 1),
    (8, "THOROUGH", "full", 2), (8, "THOROUGH", "full", 3),
    (8, "THOROUGH", "full", 4),
    (12, "EXHAUSTIVE", "full", 1), (12, "EXHAUSTIVE", "two", 1)])
def test_msearch_kernel_footprints(cuda_device, bx, quality, kind, pc):
    """K1 against its plain version beyond 6x6 -medium: every footprint
    and preset the kernel takes, up to W = 64, T = 144, C = 8 and 529
    modes, on the inputs the plain front end gives it."""
    n = {4: 512, 8: 128, 12: 48}[bx]
    a, kw = _footprint_inputs(cuda_device, bx, quality, kind, pc, n,
                              bx + pc)["K1"]
    _check_msearch(msearch.mode_search_cuda(*a, **kw),
                   msearch.mode_search_plain(*a, **kw))


def _refine_records(rf, wgrid0, N, C):
    """K2 outputs -> per-block records [r0-pre, r0-post, r1-post, ...]."""
    K = rf["err_post"].shape[0] + 1

    def rec(pre0, post):
        rr = torch.cat([pre0[None], post], 0)
        shp = tuple(rr.shape[2:])
        rr = rr.reshape((K, N, C) + shp)
        return rr.permute((1, 2, 0) + tuple(range(3, 3 + len(shp)))).reshape(
            (N, C * K) + shp).cpu().numpy()

    return {"err": rec(rf["err_pre"], rf["err_post"]),
            "fmt": rec(rf["fmt"][0], rf["fmt"]),
            "vals": rec(rf["vals"][0], rf["vals"]),
            "w": rec(wgrid0, rf["wpost"])}


@pytest.mark.parametrize("bx,quality,pc", [
    (8, "THOROUGH", 1), (8, "THOROUGH", 2), (8, "THOROUGH", 3),
    (12, "EXHAUSTIVE", 1), (12, "EXHAUSTIVE", 2), (12, "EXHAUSTIVE", 3)])
def test_refine_kernel_footprints(cuda_device, bx, quality, pc):
    """K2 against its plain version at 8x8 -thorough and 12x12
    -exhaustive (W = 64, T up to 144, C up to 8, R = 4), pc 1-3, on the
    inputs the plain front end gives it."""
    from astcenc_torch.ops import refine
    n = {8: 128, 12: 48}[bx]
    a, _ = _footprint_inputs(cuda_device, bx, quality, "full", pc, n,
                             bx + 10 * pc)["K2"]
    N, C = a[8].shape[0], a[12]
    rk = _refine_records(refine.trial1_refine_cuda(*a), a[1], N, C)
    rx = _refine_records(refine.trial1_refine_plain(*a), a[1], N, C)
    live = rx["err"] < 1e29
    np.testing.assert_array_equal(rk["err"] < 1e29, live)
    _check_records(rk, rx, ("fmt", "vals", "w"))


@pytest.mark.parametrize("bx,quality", [(8, "THOROUGH"),
                                        (12, "EXHAUSTIVE")])
def test_refine2_kernel_footprints(cuda_device, bx, quality):
    """K3 against its plain version at 8x8 -thorough and 12x12 -exhaustive
    two planes (T up to 144, C up to 8, R = 4), on the inputs the plain
    front end gives it: the records at the record bounds, and every output
    bit for bit (K3's sums run in its plain version's order)."""
    from astcenc_torch.ops import refine
    n = {8: 64, 12: 32}[bx]
    a, _ = _footprint_inputs(cuda_device, bx, quality, "two", 1, n,
                             bx + 40)["K3"]
    got, want = refine.trial2_refine_cuda(*a), refine.trial2_refine_plain(*a)
    for k, w in want.items():
        diff = int((_bits(got[k]) != _bits(w)).sum())
        print(f"K3 {bx}x{bx} {k}: {diff} of {w.numel()} values differ")
        assert diff == 0, k


def _hdr_footprint_inputs(dev, bx, quality, kind, pc, n_blocks, seed):
    """The arguments the plain HDR -ch trial front end hands K5 (1 plane,
    keyed by ncolors > 0: its bootstrap and its first round) or K6 (two
    planes, its first round) for a seeded synthetic float16 image at a bx x
    bx footprint and a preset; for pc >= 2 on seeded partitionings of the
    partition table."""
    from astcenc_torch.ops import refine
    ctx = api.context_alloc(api.config_init(
        api.Profile.HDR_RGB_LDR_A, bx, bx, 1, getattr(api.Quality, quality),
        0), device=dev)
    img = testdata.synthetic_hdr_image(bx * 8, bx * (-(-n_blocks // 8)),
                                       seed, independent_alpha=True)
    tex = torch.from_numpy(tc.image_to_blocks(ctx, img)[:n_blocks]).to(dev)
    profile = int(ctx.config.profile)
    st = tc.make_block_state(tex, profile)
    N = tex.shape[0]
    ql = torch.full((N,), 11, dtype=torch.int32, device=dev)
    if kind == "two":
        ext = torch.ones((N, 4), dtype=torch.bool, device=dev)
        return _first_calls(
            refine, "refine_round_2plane",
            lambda: trial.trial2_records(st, ctx.pass_tables("two"),
                                         ctx.config, profile, False, ql, ext,
                                         use_kernels=False),
            lambda a: a[11] > 0)
    ext = torch.ones(N, dtype=torch.bool, device=dev)
    kw = {}
    if pc > 1:
        tabs = ctx.partition_tables(pc)
        rows = torch.from_numpy(np.random.RandomState(seed).randint(
            0, tabs.count_selected, N)).to(dev)
        kw = {"pot": tabs.pot[rows], "counts": tabs.counts[rows]}
    return _first_calls(
        refine, "refine_round_1plane",
        lambda: trial.trial1_records(st, ctx.pass_tables("full", pc),
                                     ctx.config, profile, False, ql, ext,
                                     use_kernels=False, **kw),
        lambda a: a[10] > 0)


def _round_differing(tag, got, want):
    """How many output values of a K5/K6 call differ from the plain
    version's, bit for bit (printed)."""
    diff = sum(int((_bits(got[k]) != _bits(w)).sum())
               for k, w in want.items())
    total = sum(w.numel() for w in want.values())
    print(f"{tag}: {diff} of {total} values differ from the plain version")
    return diff


@pytest.mark.parametrize("bx,quality,pc", [
    (8, "THOROUGH", 1), (8, "THOROUGH", 2), (8, "THOROUGH", 3),
    (12, "EXHAUSTIVE", 1), (12, "EXHAUSTIVE", 2), (12, "EXHAUSTIVE", 3),
    (12, "EXHAUSTIVE", 4)])
def test_refine_round_kernel_footprints(cuda_device, bx, quality, pc):
    """K5, its bootstrap and a round, against its plain version at 8x8
    -thorough (C = 4) and 12x12 -exhaustive (C = 8, W = 64, T = 144), pc
    1-4, on the inputs the plain HDR -ch front end gives it: every output
    bit for bit (K5's sums run in its plain version's order)."""
    from astcenc_torch.ops import refine
    n = {8: 128, 12: 48}[bx]
    seen = _hdr_footprint_inputs(cuda_device, bx, quality, "full", pc, n,
                                 bx + 10 * pc)
    for realign in (False, True):
        a = seen[realign]
        got = refine.refine_round_1plane_cuda(*a)
        want = refine.refine_round_1plane_plain(*a)
        tag = (f"K5 {bx}x{bx} pc{pc} C{a[9]} "
               f"{'round' if realign else 'bootstrap'}")
        _check_round(got, want, ("grid",))
        assert _round_differing(tag, got, want) == 0, tag


@pytest.mark.parametrize("bx,quality", [(8, "THOROUGH"),
                                        (12, "EXHAUSTIVE")])
def test_refine_round2_kernel_footprints(cuda_device, bx, quality):
    """K6 against its plain version at 8x8 -thorough (C = 4: a texel row's
    16 warps in one CTA) and 12x12 -exhaustive two planes (C = 8: a row's
    components over two CTAs), on the inputs the plain HDR -ch front end
    gives it: every output bit for bit."""
    from astcenc_torch.ops import refine
    n = {8: 64, 12: 32}[bx]
    a = _hdr_footprint_inputs(cuda_device, bx, quality, "two", 1, n,
                              bx + 40)[True]
    assert a[10] == {8: 4, 12: 8}[bx], a[10]
    got = refine.refine_round_2plane_cuda(*a)
    want = refine.refine_round_2plane_plain(*a)
    _check_round(got, want, ("grid1", "grid2"))
    assert _round_differing(f"K6 {bx}x{bx} C{a[10]}", got, want) == 0


def _psearch_inputs(dev, bx, P, n_blocks, seed):
    """The arguments the partition search hands K4 (the line errors) for a
    seeded synthetic image at a bx x bx footprint, -thorough (S up to 82),
    with alpha varying in the right half's blocks and constant in the
    left half's; and the seed of each partitioning."""
    ctx = api.context_alloc(api.config_init(
        api.Profile.LDR, bx, bx, 1, api.Quality.THOROUGH, 0), device=dev)
    img = testdata.synthetic_image(bx * 8, bx * (-(-n_blocks // 8)), seed,
                                   independent_alpha=True)
    img[:, :img.shape[1] // 2, 3] = 255
    tex = torch.from_numpy(tc.image_to_blocks(ctx, img)[:n_blocks]).to(dev)
    st = tc.make_block_state(tex, 1)
    cfg = ctx.config
    limit = getattr(cfg, f"tune_{P}partition_index_limit")
    seen = {}
    orig = psearch.line_errors

    def grab(*a, **kw):
        seen.setdefault("K4", a)
        return orig(*a, **kw)

    psearch.line_errors = grab
    try:
        partition_search.find_best_partition_candidates(
            st, ctx.partition_tables(P), bx * bx, trial.effective_cw(cfg), P,
            limit, 2, use_kernels=False)
    finally:
        psearch.line_errors = orig
    return seen["K4"], ctx.partition_tables(P).seed


@pytest.mark.parametrize("bx", [4, 8, 12])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_psearch_kernel_footprints(cuda_device, bx, P):
    """K4 against its plain version at 4x4, 8x8 and 12x12 (T up to 144),
    2-4 partitions, blocks with and without alpha, on the inputs the
    partition search gives it: chip_smoke.py's bounds (99.9% of the line
    errors within 1e-4, 99% of the selected seeds and valid flags)."""
    a, seeds = _psearch_inputs(cuda_device, bx, P,
                               {4: 256, 8: 64, 12: 32}[bx], bx + P)
    uk, sk = psearch.line_errors_cuda(*a)
    ux, sx = psearch.line_errors_plain(*a)
    for g, w in ((uk, ux), (sk, sx)):
        rel = ((g - w).abs() / w.abs().clamp(min=1e-30)).cpu().numpy()
        assert (rel <= 1e-4).mean() >= 0.999, rel.max()
    top = a[2]
    sel_k = partition_search.select_candidates(uk, sk, seeds, top.long(), 2)
    sel_x = partition_search.select_candidates(ux, sx, seeds, top.long(), 2)
    assert (sel_k[0] == sel_x[0]).float().mean() >= 0.99
    assert (sel_k[1] == sel_x[1]).float().mean() >= 0.99


def _bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _division_case(case, dev):
    """Outputs of one site that divides by a constant, on ``dev``, from
    seeded inputs."""
    from astcenc_torch.codec import compress as comp
    from astcenc_torch.ops import formats, recompute
    rng = np.random.default_rng(61)
    N, P, T = 4096, 2, 36
    cw = (1.0, 1.0, 1.0, 1.0)
    if case == "error_tables":
        ep0, ep1, _, _ = testdata.endpoint_pairs(rng, N * P)
        counts = rng.integers(1, T, (N, P)).astype(np.int32)
        eci = {k: rng.uniform(0, 1e6, (N, P)).astype(np.float32)
               for k in ("rgb_scale_error", "rgb_luma_error",
                         "luminance_error", "alpha_drop_error")}
        return formats.color_error_tables_hdr(
            {k: torch.from_numpy(v).to(dev) for k, v in eci.items()},
            *(torch.from_numpy(x).to(dev) for x in (
                ep0.reshape(N, P, 4), ep1.reshape(N, P, 4), counts)), cw,
            True)
    if case == "rgbo_fallback":
        tex = rng.uniform(0, 65535, (N, T, 4)).astype(np.float32)
        pot = rng.integers(0, P, (N, T))
        pot[:N // 4] = 0                  # partition 1 empty
        pmask = np.eye(P, dtype=np.float32)[pot]
        u = (rng.integers(0, 65, (N, T)) / 64.0).astype(np.float32)
        u[N // 4:N // 2] = 0.5            # one weight: a singular solve
        e0 = rng.uniform(0, 30000, (N, P, 4)).astype(np.float32)
        e1 = e0 + rng.uniform(0, 30000, (N, P, 4)).astype(np.float32)
        t = [torch.from_numpy(x).to(dev) for x in (
            tex, pmask, pmask.sum(1).astype(np.int32), u)]
        e0, e1 = torch.from_numpy(e0).to(dev), torch.from_numpy(e1).to(dev)
        rc = recompute.recompute_ideal_colors_1plane(*t, cw, e0, e1,
                                                     is_hdr=True)
        # In the refit the fallback rows have equal endpoints (an empty
        # partition or one weight), so it also runs alone, on sums whose
        # solve is NaN (no weight) in the first quarter of the rows and
        # endpoints that differ.
        ws = rng.uniform(1, 36, (N, P, 4)).astype(np.float32)
        ws[:N // 4] = 0.0
        sums = [torch.from_numpy(x).to(dev) for x in (
            ws, rng.uniform(0, 36, (N, P, 4)).astype(np.float32),
            rng.uniform(0, 1e6, (N, P, 4)).astype(np.float32),
            rng.uniform(0, 1e6, (N, P, 4)).astype(np.float32),
            rng.uniform(0, 36, (N, P)).astype(np.float32))]
        return ([rc[k] for k in ("ep0", "ep1", "rgbs", "rgbo")]
                + [recompute._rgbo(*sums, e0, e1)])
    # Constant blocks at profile 2: LNS colour, UNORM16 alpha.
    tex0 = rng.integers(0, 65536, (1024, 4)).astype(np.float32)
    tex = torch.from_numpy(np.repeat(tex0[:, None], T, 1)).to(dev)
    ctx = api.context_alloc(api.config_init(
        api.Profile.HDR_RGB_LDR_A, 6, 6, 1, api.Quality.MEDIUM, 0),
        device=dev)
    _, aux = comp.stage1_1plane(ctx, tex)
    assert bool(aux["is_const"].all())
    return [aux["const_color"]]


@pytest.mark.parametrize("case", ["error_tables", "rgbo_fallback",
                                  "constant_color"])
def test_constant_divisions_match_cpu(cuda_device, case):
    """The sites that divide by a constant (softfloat.div) give the CPU's
    float32 quotients on the card, bit for bit: the HDR colour-error tables
    (the luminance difference / 3; their RGB range error sums three
    channels in a fixed order), the HDR refit's RGBO fallback (/ 3), taken
    on a quarter of the rows with an empty partition, a quarter with one
    weight for every texel, and alone on rows whose solve is NaN, and the
    profile-2 constant colour (alpha / 65535)."""
    got, want = (_division_case(case, d) for d in (cuda_device, "cpu"))
    for g, w in zip(got, want):
        diff = int((_bits(g) != _bits(w)).sum())
        print(f"{case}: {diff} of {w.numel()} values differ from the CPU's")
        assert diff == 0


def test_encoding_choice_errors_against_cpu(cuda_device):
    """ROADMAP §C3: formats.encoding_choice_errors sums over texels through
    the texel-sum kernel and over channels in a fixed order, so the card
    adds as the CPU does. On seeded 2-partition blocks this prints how many
    of its values differ from the CPU's and by how much (of the
    partition's error scale, the weighted sum of its squared texels), and
    holds every value and flag bit for bit."""
    from astcenc_torch.ops import formats
    rng = np.random.default_rng(67)
    N, P, T = 4096, 2, 36
    cw = (1.0, 1.0, 1.0, 1.0)
    tex = rng.uniform(0, 65535, (N, T, 4)).astype(np.float32)
    tex[:N // 2] = np.sort(tex[:N // 2], 1)           # smoother blocks
    pmask = np.eye(P, dtype=np.float32)[rng.integers(0, P, (N, T))]
    ep0, ep1, _, _ = testdata.endpoint_pairs(rng, N * P)
    lum = rng.random(N) < 0.25
    args = (tex, pmask, ep0.reshape(N, P, 4), ep1.reshape(N, P, 4))

    def run(dev):
        t = [torch.from_numpy(x).to(dev) for x in args]
        out = formats.encoding_choice_errors(
            *t, cw, torch.from_numpy(lum).to(dev), 65535.0)
        return {k: v.cpu() for k, v in out.items()}

    got, want = run(cuda_device), run("cpu")
    scale = np.einsum("ntp,nt->np", pmask.astype(np.float64),
                      (tex.astype(np.float64) ** 2).sum(-1))
    for k, w in want.items():
        g = got[k]
        if w.dtype == torch.bool:
            assert (g == w).all(), k
            continue
        diff = int((_bits(g) != _bits(w)).sum())
        rel = (np.abs(g.double().numpy() - w.double().numpy())
               / np.maximum(scale, 1.0))
        print(f"encoding_choice_errors {k}: {diff} of {w.numel()} values "
              f"differ from the CPU's, at most {rel.max():.3e} of the "
              f"partition's scale")
        assert bool(torch.isfinite(g).all()) and diff == 0, k


@pytest.mark.parametrize("T", [16, 36, 144, 216])
def test_texel_sum_kernel_matches_plain(cuda_device, T):
    """The texel-sum kernel against its plain version, bit for bit, in its
    three orders, on strided and broadcast views as the glue passes them:
    a one-hot mask with texels, a channel slice and three channels, the
    channel pairs of the correlation, the block sum and the prefix sums."""
    from astcenc_torch.ops import texel_sum as ts
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.normal(0, 3e4, (256, T, 4)).astype(
        np.float32)).to(cuda_device)
    m = torch.from_numpy(np.eye(3, dtype=np.float32)[
        rng.integers(0, 3, (256, T))]).to(cuda_device)
    ones = torch.ones((), device=cuda_device).expand(256, T, 1)
    upper = torch.ones((T, T), device=cuda_device).triu().expand(256, T, T)
    for a, b, order in ((m, x, "seq"), (m, x[..., 1:2], "seq"),
                        (m, x[..., :3], "seq"), (x, x, "seq"),
                        (ones, x, "outer"), (upper, x[..., :1].abs(), "wide")):
        got = ts.texel_sum_cuda(a, b, order)
        want = ts.texel_sum_plain(a, b, order)
        assert int((_bits(got) != _bits(want)).sum()) == 0, (order, b.shape)


def _site_inputs(dev, T=36):
    """Seeded block texels for the summing sites: the 6x6 blocks of a
    synthetic LDR image (smooth, correlated channels, an independent alpha
    half) and as many uniform random blocks; a 2-partition one-hot mask."""
    rng = np.random.default_rng(71)
    img = testdata.synthetic_image(192, 384, 71, independent_alpha=True)
    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    blk = tc.image_to_blocks(api.context_alloc(cfg, device="cpu"), img)
    tex = np.concatenate([blk, rng.uniform(0, 65535, blk.shape).astype(
        np.float32)])
    pmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, tex.shape[:2])]
    return (torch.from_numpy(tex).to(dev), torch.from_numpy(pmask).to(dev),
            rng)


def _sum_site(case, dev):
    """Named outputs of one site that sums over texels or channels outside
    any kernel, on ``dev``, from seeded inputs (ROADMAP §C3)."""
    from astcenc_torch.ops import ideal, recompute
    tex, pmask, rng = _site_inputs(dev)
    N, T, _ = tex.shape
    cw = (1.0, 1.0, 1.0, 1.0)
    if case == "ideal_fit":
        out = {}
        for cm in ((1, 1, 1, 1), (1, 1, 1, 0)):
            avg, dirv = ideal.avgs_and_dirs(tex, pmask, cm)
            fit = ideal.ideal_colors_and_weights(
                tex, pmask, pmask.sum(1), tex.amin(1), tex.amax(1), cw, cm,
                omitted_component=None if cm[3] else 3)
            out.update({f"{k}{sum(cm)}": v for k, v in (
                ("avg", avg), ("dir", dirv),
                ("unit", ideal.normalize_safe(dirv, cm)),
                ("weights", fit["weights"]), ("wes", fit["weight_error_scale"]),
                ("ep0_", fit["ep0"]), ("ep1_", fit["ep1"]))})
        return out
    if case == "kmeans":
        return {f"part{P}": partition_search.kmeans(tex, cw, T, P)
                for P in (2, 3, 4)}
    if case == "correlation":
        return {"lowest": tc._lowest_correlation(tex, cw)}
    if case == "block_state":
        st = tc.make_block_state(tex, 1)
        return {k: st[k] for k in ("data_mean", "data_min", "data_max")}
    # The HDR refit (-ch): 1 plane at 2 partitions, 2 planes.
    u = torch.from_numpy((rng.integers(0, 65, (N, T)) / 64.0).astype(
        np.float32)).to(dev)
    u2 = torch.from_numpy((rng.integers(0, 65, (N, T)) / 64.0).astype(
        np.float32)).to(dev)
    e0 = torch.from_numpy(rng.uniform(0, 30000, (N, 2, 4)).astype(
        np.float32)).to(dev)
    e1 = e0 + 1000.0
    r1 = recompute.recompute_ideal_colors_1plane(
        tex, pmask, pmask.sum(1), u, cw, e0, e1, is_hdr=True)
    p2c = torch.from_numpy(rng.integers(0, 4, N).astype(np.int32)).to(dev)
    r2 = recompute.recompute_ideal_colors_2planes(
        tex, u, u2, p2c, cw, tex.cpu().mean(1).to(dev), e0[:, 0], e1[:, 0],
        is_hdr=True)
    return {**{f"{k}_1": v for k, v in r1.items()},
            **{f"{k}_2": v for k, v in r2.items()}}


@pytest.mark.parametrize("case", ["ideal_fit", "kmeans", "correlation",
                                  "block_state", "hdr_refit"])
def test_sum_sites_match_cpu(cuda_device, case):
    """ROADMAP §C3: the sites that sum over texels or channels outside the
    kernels give the CPU's values on the card, bit for bit: the ideal fit
    of the trial front end (partition means, dominant directions, their
    normalization, the projection), the k-means partition assignment, the
    2-plane correlation gate, the block state and the HDR refit. Prints
    how many values of each output differ."""
    got, want = (_sum_site(case, d) for d in (cuda_device, "cpu"))
    bad = {}
    for k, w in want.items():
        diff = int((_bits(got[k]) != _bits(w)).sum())
        print(f"{case} {k}: {diff} of {w.numel()} values differ from the "
              f"CPU's")
        if diff:
            bad[k] = diff
    assert not bad, bad


def _card_vs_cpu(dev, hdr):
    """A 256x256 image at 6x6 -medium (LDR, or -ch on a float16 image)
    encoded on the card and by the CPU port: the share of identical blocks
    and the indices of the others."""
    if hdr:
        img = testdata.synthetic_hdr_image(256, 256, 5, independent_alpha=True)
        prof = api.Profile.HDR_RGB_LDR_A
    else:
        img = testdata.synthetic_image(256, 256, 5, independent_alpha=True)
        prof = api.Profile.LDR
    cfg = api.config_init(prof, 6, 6, 1, api.Quality.MEDIUM, 0)
    got = api.compress_image(api.context_alloc(cfg, device=dev), img)
    want = api.compress_image(api.context_alloc(cfg, device="cpu"), img)
    same = (got == want).all(1)
    return float(same.mean()), np.flatnonzero(~same)


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "ch"])
def test_card_encode_matches_cpu(cuda_device, hdr):
    """ROADMAP §C3: a 256x256 image encoded on the card and by the CPU port,
    block by block. Prints the share of identical blocks and the blocks
    that differ."""
    share, diff = _card_vs_cpu(cuda_device, hdr)
    print(f"{'-ch' if hdr else 'LDR'} 256x256: {share:.6f} of blocks "
          f"identical card vs CPU; differing blocks {diff.tolist()}")
    assert share == 1.0, diff.tolist()


def test_12x12_thorough_crop_matches_cpu(cuda_device):
    """The benchmark's 12x12 -thorough cell (LOW preset row: T 144, up to
    4 partitions): a 144x144 crop of whole blocks from the top centre of
    its first texture (texture 0 of ``content_seed`` 13001, an alpha of its
    own on the right half) encodes to the same blocks on the card as by
    the CPU port."""
    img = testdata.synthetic_image(1024, 1024, [13001, 0],
                                   independent_alpha=True)[:144, 432:576]
    cfg = api.config_init(api.Profile.LDR, 12, 12, 1, api.Quality.THOROUGH, 0)
    got = api.compress_image(api.context_alloc(cfg, device=cuda_device), img)
    want = api.compress_image(api.context_alloc(cfg, device="cpu"), img)
    same = (got == want).all(1)
    print(f"12x12 -thorough 144x144: {same.mean():.6f} of blocks identical "
          f"card vs CPU; differing blocks {np.flatnonzero(~same).tolist()}")
    assert same.all(), np.flatnonzero(~same).tolist()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name", ["rgba96", "alpha48"])
def test_ldr_blocks_match_jax_fixture(cuda_device, name):
    """tests/test_torch_main.py's images at 6x6 -medium encoded on the card
    against JAX's blocks (tests/data/torch_ldr): at least 90% identical,
    PSNR within 0.05 dB; the CPU port's agreement printed beside."""
    fx = np.load(os.path.join(DATA, "torch_ldr", f"ref_medium_{name}.npz"))
    h, w = (int(v) for v in fx["shape"])
    img = testdata.synthetic_image(h, w, int(fx["seed"]),
                                   independent_alpha=bool(
                                       fx["independent_alpha"]))
    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    ctx = api.context_alloc(cfg, device=cuda_device)
    got = api.compress_image(ctx, img)
    cpu = api.compress_image(api.context_alloc(cfg, device="cpu"), img)
    want = fx["blocks"]
    ident = float((got == want).all(1).mean())
    ident_cpu = float((cpu == want).all(1).mean())
    pg, pw = (_psnr(api.decompress_image(ctx, b, w, h)[0], img)
              for b in (got, want))
    print(f"{name}: card {ident:.4f} of blocks identical to JAX (CPU port "
          f"{ident_cpu:.4f}); PSNR {pg:.6f} dB, JAX {pw:.6f} dB")
    assert ident >= 0.9 and abs(pg - pw) <= 0.05, (ident, pg, pw)


def test_hdr_blocks_match_jax_fixture(cuda_device):
    """tests/test_torch_hdr_image.py's 48x48 image at 6x6 -medium -ch
    encoded on the card against JAX's blocks (tests/data/torch_hdr): at
    least 90% identical, mPSNR within 0.05 dB; the CPU port's agreement
    printed beside."""
    fx = np.load(os.path.join(DATA, "torch_hdr", "ref_ch_48x48.npz"))
    h, w = (int(v) for v in fx["shape"])
    img = testdata.synthetic_hdr_image(h, w, int(fx["seed"]),
                                       independent_alpha=True)
    cfg = api.config_init(api.Profile.HDR_RGB_LDR_A, 6, 6, 1,
                          api.Quality.MEDIUM, 0)
    ctx = api.context_alloc(cfg, device=cuda_device)
    got = api.compress_image(ctx, img)
    cpu = api.compress_image(api.context_alloc(cfg, device="cpu"), img)
    want = fx["blocks"]
    ident = float((got == want).all(1).mean())
    ident_cpu = float((cpu == want).all(1).mean())
    src = img.astype(np.float32)
    mg, mw = (metrics.mpsnr(api.decompress_image(
        ctx, b, w, h, out_type="f32")[0], src) for b in (got, want))
    print(f"48x48 -ch: card {ident:.4f} of blocks identical to JAX (CPU "
          f"port {ident_cpu:.4f}); mPSNR {mg:.5f} dB, JAX {mw:.5f} dB")
    assert ident >= 0.9 and abs(mg - mw) <= 0.05, (ident, mg, mw)


# --- the weighted (USE_ALPHA_WEIGHT) and RGBM forms of K2-K7 ---------------

def _form_calls(dev, kind, side=48):
    """The arguments (positional, keywords) a small plain encode hands each
    kernel's router on its first call of each form: kind "a" (6x6 -medium
    -a on an image with transparent holes: blocks whose scale is 0), "rgbm"
    (6x6 -medium RGBM on ``testdata.rgbm_image``, texels whose M is 0) or
    "ch_a" (6x6 -medium -ch -a). Keys: ("K2", pass kind, pc), ("K3",),
    ("K4", P), ("K5", realign), ("K6",), ("K7",)."""
    from astcenc_torch.ops import refine
    profile, flags = {"a": (api.Profile.LDR, api.Flags.USE_ALPHA_WEIGHT),
                      "rgbm": (api.Profile.LDR, api.Flags.MAP_RGBM),
                      "ch_a": (api.Profile.HDR_RGB_LDR_A,
                               api.Flags.USE_ALPHA_WEIGHT)}[kind]
    img = {"a": lambda: testdata.footprint_image("ldr_holes", side, side, 5),
           "rgbm": lambda: testdata.rgbm_image(side, side, 6),
           "ch_a": lambda: testdata.synthetic_hdr_image(
               side, side, 7, independent_alpha=True)}[kind]()
    ctx = api.context_alloc(api.config_init(profile, 6, 6, 1,
                                            api.Quality.MEDIUM, flags),
                            device=dev)
    seen = {}
    wrapped = [(refine, "trial1_refine",
                lambda a: ("K2", a[0].kind, a[0].pc)),
               (refine, "trial2_refine", lambda a: ("K3",)),
               (refine, "refine_round_1plane", lambda a: ("K5", a[10] > 0)),
               (refine, "refine_round_2plane",
                lambda a: ("K6",) if a[11] > 0 else ("K7",)),
               (psearch, "line_errors", lambda a: ("K4", a[5]))]
    orig = {name: getattr(mod, name) for mod, name, _ in wrapped}

    def wrap(name, key):
        def fn(*a, **kw):
            seen.setdefault(key(a), (a, {k: v for k, v in kw.items()
                                         if k in ("cw_scale", "rgbm")}))
            return orig[name](*a, **kw)
        return fn

    for mod, name, key in wrapped:
        setattr(mod, name, wrap(name, key))
    try:
        tc.compress_image(ctx, img, use_kernels=False)
    finally:
        for mod, name, _ in wrapped:
            setattr(mod, name, orig[name])
    return seen


_FORM_FNS = {"K2": ("trial1_refine_cuda", "trial1_refine_plain"),
             "K3": ("trial2_refine_cuda", "trial2_refine_plain"),
             "K5": ("refine_round_1plane_cuda", "refine_round_1plane_plain"),
             "K6": ("refine_round_2plane_cuda", "refine_round_2plane_plain"),
             "K7": ("refine_round_2plane_cuda", "refine_round_2plane_plain")}


@pytest.mark.parametrize("kind,kern", [
    ("a", "K2"), ("a", "K3"), ("a", "K4"), ("ch_a", "K5"), ("ch_a", "K6"),
    ("ch_a", "K7"), ("rgbm", "K2"), ("rgbm", "K3")])
def test_weighted_forms_match_plain(cuda_device, kind, kern):
    """Each new form on the inputs a small encode hands it: the kernel
    equals its plain version bit for bit (K4: chip_smoke.py's share
    bounds, as its static form), a unit ``cw_scale`` gives exactly the
    static form's outputs, and under RGBM the kernel rejects the same
    lanes (a decoded M of 0) as the plain version, some at least."""
    from astcenc_torch.ops import refine
    calls = {k: v for k, v in _form_calls(cuda_device, kind).items()
             if k[0] == kern}
    assert calls, f"{kern} was not called"
    for key, (a, kw) in sorted(calls.items(), key=str):
        if kind != "rgbm":
            assert kw["cw_scale"] is not None, key
        if kern == "K4":
            uk, sk = psearch.line_errors_cuda(*a, **kw)
            ux, sx = psearch.line_errors_plain(*a, **kw)
            for g, w in ((uk, ux), (sk, sx)):
                rel = ((g - w).abs() / w.abs().clamp(min=1e-30)).cpu()
                assert (rel <= 1e-4).float().mean() >= 0.999, key
            static = psearch.line_errors_cuda(*a)
            unit = psearch.line_errors_cuda(
                *a, cw_scale=torch.ones_like(kw["cw_scale"]))
            assert all((_bits(s) == _bits(u)).all()
                       for s, u in zip(static, unit)), key
            continue
        cuda_fn, plain_fn = (getattr(refine, n) for n in _FORM_FNS[kern])
        got, want = cuda_fn(*a, **kw), plain_fn(*a, **kw)
        assert _round_differing(f"{kind} {key}", got, want) == 0, key
        n = {"K2": a[8], "K3": a[11], "K5": a[7]}.get(kern)
        blocks = (n.shape[0] if n is not None
                  else a[1].shape[0] // a[10])
        ones = torch.ones(blocks, dtype=torch.float32, device=cuda_device)
        static = cuda_fn(*a, rgbm=kw["rgbm"])
        unit = cuda_fn(*a, cw_scale=ones, rgbm=kw["rgbm"])
        assert all((_bits(unit[k]) == _bits(v)).all()
                   for k, v in static.items()), key
        if kind == "rgbm":
            alive = a[4 if kern == "K2" else 5]
            for k in ("err_pre", "err_post"):
                rej_k = int(((got[k] >= 1e30) & alive).sum())
                rej_x = int(((want[k] >= 1e30) & alive).sum())
                print(f"rgbm {key} {k}: {rej_k} live lanes rejected")
                assert rej_k == rej_x, key
            assert int(((want["err_pre"] >= 1e30) & alive).sum()) > 0, key


@pytest.mark.parametrize("quality", ["MEDIUM", "EXHAUSTIVE"])
@pytest.mark.parametrize("profile", ["LDR", "HDR_RGB_LDR_A"])
def test_3d_kernels_match_plain(cuda_device, profile, quality):
    """6x6x6 (T = 216, 435 modes): a small volume encoded through the
    kernels and through the plain versions, >= 99% of blocks identical
    (K1 at its largest mode count, K4 at T above 144, K2 and K5 at their
    largest shared memory with -exhaustive's candidates)."""
    ctx = api.context_alloc(api.config_init(
        getattr(api.Profile, profile), 6, 6, 6,
        getattr(api.Quality, quality), 0), device=cuda_device)
    vol = testdata.synthetic_volume(12, 11, 17, 9,
                                    hdr=profile != "LDR")
    got = api.compress_image(ctx, vol)
    want = tc.compress_image(ctx, vol, use_kernels=False)
    same = float((got == want).all(1).mean())
    print(f"6x6x6 {profile} {quality}: {same:.4f} of {got.shape[0]} blocks "
          f"identical")
    assert same >= 0.99
