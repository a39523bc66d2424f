"""The astcenc_torch encoder on the inputs beyond plain 2D textures, on the
CPU, against the JAX package's blocks of the same inputs.

Each configuration has a committed fixture ``tests/data/torch_features/
<name>.npz``: the input's kind, seed and shape (``image`` makes it again),
the profile, the footprint, the preset's name and quality, the flags and
JAX's blocks. The configurations:

- A (``USE_ALPHA_WEIGHT``, ``-a``): 4x4 -medium, 6x6 -medium and 8x8
  -thorough on an image with translucent alpha and transparent holes
  (``testdata.footprint_image`` kind "ldr_holes": stages 2a and 2b, so the
  refinement kernels K2, K3 and the partition kernel K4 with per-block
  weights, and blocks whose weights are zero), and 6x6 -medium -ch -a on
  the HDR image (the 1-round kernels K5, K6 and K7);
- M (``MAP_RGBM``, scale 5): 4x4 -medium, 6x6 -medium and 8x8 -thorough on
  an RGBM texture (``testdata.rgbm_image``) with texels whose M is 0;
- N (non-finite input): the 36 cases of tests/test_nan_inputs.py, NaN,
  +Inf and -Inf in each channel under LDR, HDR and HDR_RGB_LDR_A at 4x4
  -fastest, one 12-block image a profile (``testdata.nonfinite_image``);
- V (3D): every legal 3D footprint at -fastest, 4x4x4 and 6x6x6 at
  -medium, 4x4x4 -thorough and 6x6x6 -medium -ch, on seeded volumes
  (``testdata.synthetic_volume``) of 12 blocks whose width and height are
  not multiples of the footprint (the edge clamp).

The images hold 12 to 16 blocks. The tests ask of the port's blocks what
tests/test_torch_footprints.py asks: at least 90% identical to JAX's and
the decode within 0.05 dB PSNR (mPSNR for HDR) of JAX's blocks decoded by
the port's decoder; each prints its share and its block mix. Non-finite
inputs are scored against the image with the bad texel set to 0.5.

A JAX encode compiles for one to several minutes per configuration on a
CPU, so tier-1 reads the fixtures; the ``slow`` test rebuilds one
configuration with JAX and compares it with the committed fixture. To
rebuild them (one configuration per process):

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
        import test_torch_features as m; m.write_fixtures(['4x4_medium_a'])"

(no argument writes every configuration), or check one with
``python -m pytest --runslow tests/test_torch_features.py -k
"rebuild and 4x4_medium_a"``.
"""

import os

import numpy as np
import pytest
import torch

from astcenc_torch import api as tapi
from astcenc_torch import testdata
from astcenc_torch.codec import compress as tcomp
from astcenc_torch.codec import decompress as tdec
from astcenc_torch.codec import trial as ttrial
from astcenc_torch.ops import color_pack as tpack
from astcenc_torch.ops import recompute as trecompute
from astcenc_torch.utils import metrics

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_features")
PRESETS = {"fastest": 0.0, "medium": 60.0, "thorough": 98.0}
PROFILES = {"ldr": 1, "ch": 2, "cH": 3}
FLAGS = {"": 0, "a": int(tapi.Flags.USE_ALPHA_WEIGHT),
         "rgbm": int(tapi.Flags.MAP_RGBM)}
LEGAL_3D = ((3, 3, 3), (4, 3, 3), (4, 4, 3), (4, 4, 4), (5, 4, 4),
            (5, 5, 4), (5, 5, 5), (6, 5, 5), (6, 6, 5), (6, 6, 6))


def _configs():
    """name: dict(group, kind, profile, block, preset, flag, shape, seed)."""
    out = {}

    def add(group, block, preset, kind, profile="ldr", flag="", shape=None):
        dims = "x".join(str(d) for d in (block if block[2] > 1
                                         else block[:2]))
        name = "_".join(p for p in (dims, preset, "" if profile == "ldr"
                                    else profile, flag) if p)
        if kind == "nonfinite":
            name = f"nonfinite_{profile}"
        if shape is None:
            bx, by, bz = block
            shape = ((2 * bz, 2 * by - 1, 3 * bx - 1) if bz > 1
                     else (4 * by, 4 * bx))
        out[name] = dict(group=group, kind=kind, profile=profile,
                         block=tuple(block), preset=preset, flag=flag,
                         shape=tuple(shape), seed=200 + len(out))

    for b, preset in (((4, 4, 1), "medium"), ((6, 6, 1), "medium"),
                      ((8, 8, 1), "thorough")):
        add("A", b, preset, "ldr_holes", flag="a")
    add("A", (6, 6, 1), "medium", "hdr", "ch", "a")
    for b, preset in (((4, 4, 1), "medium"), ((6, 6, 1), "medium"),
                      ((8, 8, 1), "thorough")):
        add("M", b, preset, "rgbm", flag="rgbm")
    for profile in ("ldr", "ch", "cH"):
        add("N", (4, 4, 1), "fastest", "nonfinite", profile,
            shape=(4, 48))
    for b in LEGAL_3D:
        add("V", b, "fastest", "volume")
    add("V", (4, 4, 4), "medium", "volume")
    add("V", (6, 6, 6), "medium", "volume")
    add("V", (4, 4, 4), "thorough", "volume")
    add("V", (6, 6, 6), "medium", "volume_hdr", "ch")
    return out


CONFIGS = _configs()


def fixture_path(name, root=FIXTURES):
    return os.path.join(root, f"{name}.npz")


def config(api, c):
    """The configuration ``c`` in the JAX package's or the port's API."""
    return api.config_init(api.Profile(PROFILES[c["profile"]]), *c["block"],
                           PRESETS[c["preset"]], FLAGS[c["flag"]])


def image(c):
    """The input of configuration ``c``: (H, W, 4) or (D, H, W, 4)."""
    return testdata.feature_image(c["kind"], c["shape"], c["seed"])


def jax_blocks(name):
    """JAX's encode of configuration ``name``."""
    from astcenc_tpu import api as japi
    c = CONFIGS[name]
    return japi.compress_image(japi.context_alloc(config(japi, c)), image(c))


def write_fixtures(names=None, root=FIXTURES):
    """JAX's blocks of each configuration in ``names`` (all by default) as
    a fixture."""
    os.makedirs(root, exist_ok=True)
    for name in names or list(CONFIGS):
        c = CONFIGS[name]
        np.savez(fixture_path(name, root), name=name, kind=c["kind"],
                 seed=np.int32(c["seed"]), shape=np.array(c["shape"], np.int32),
                 profile=np.int32(PROFILES[c["profile"]]),
                 block=np.array(c["block"], np.int32), preset=c["preset"],
                 quality=np.float32(PRESETS[c["preset"]]),
                 flags=np.int32(FLAGS[c["flag"]]), blocks=jax_blocks(name))


def _dims(c):
    """(width, height, depth) of the input."""
    s = c["shape"]
    return (s[2], s[1], s[0]) if len(s) == 3 else (s[1], s[0], 1)


def _score(c, dec, img):
    """PSNR (mPSNR for HDR) of a decode against the input."""
    if c["kind"] == "nonfinite":
        src = np.nan_to_num(img[None], nan=0.5, posinf=0.5, neginf=0.5)
        if c["profile"] != "ldr":
            return metrics.mpsnr(dec, src)
        mse = np.mean((dec.astype(np.float64) - src) ** 2)
        return 10.0 * np.log10(1.0 / mse)
    if c["profile"] != "ldr":
        return metrics.mpsnr(dec, np.asarray(img, np.float32))
    src = img if img.ndim == 4 else img[None]
    mse = np.mean((dec.astype(np.float64) - src.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


def block_mix(ctx, blocks):
    const, pc, planes = (t.numpy() for t in tdec.block_types(
        ctx.torch_decode_tables(), torch.from_numpy(np.asarray(blocks))))
    mix = {f"pc{p}": int(((pc == p) & ~const).sum()) for p in (1, 2, 3, 4)}
    mix["2plane"] = int(((planes == 2) & ~const).sum())
    mix["const"] = int(const.sum())
    return mix


def check_fixture(name, root=FIXTURES, got=None, ctx=None):
    """Hold an encode of configuration ``name`` (the port's on the CPU
    unless ``got`` is given) to the committed JAX blocks. Returns (share
    identical, the port's dB, JAX's dB, the block mix)."""
    c = CONFIGS[name]
    fx = np.load(fixture_path(name, root))
    assert str(fx["name"]) == name and str(fx["kind"]) == c["kind"]
    assert int(fx["seed"]) == c["seed"]
    assert tuple(fx["shape"]) == c["shape"]
    assert int(fx["profile"]) == PROFILES[c["profile"]]
    assert tuple(fx["block"]) == c["block"]
    assert str(fx["preset"]) == c["preset"]
    assert int(fx["flags"]) == FLAGS[c["flag"]]
    img = image(c)
    if ctx is None:
        ctx = tapi.context_alloc(config(tapi, c), device="cpu")
    if got is None:
        got = tapi.compress_image(ctx, img)
    want = fx["blocks"]
    w, h, d = _dims(c)
    bx, by, bz = c["block"]
    n = (-(-w // bx)) * (-(-h // by)) * (-(-d // bz))
    assert got.shape == want.shape == (n, 16)
    ident = float((got == want).all(1).mean())
    out = "u8" if c["profile"] == "ldr" and c["kind"] != "nonfinite" \
        else "f32"
    dg = tapi.decompress_image(ctx, got, w, h, d, out_type=out)
    dw = tapi.decompress_image(ctx, want, w, h, d, out_type=out)
    pg, pw = _score(c, dg, img), _score(c, dw, img)
    mix = block_mix(ctx, got)
    hdr = c["profile"] != "ldr"
    print(f"{name}: {ident:.4f} of {n} blocks identical to JAX; "
          f"{'mPSNR' if hdr else 'PSNR'} {pg:.6f} dB, JAX {pw:.6f} dB; "
          f"blocks {mix}")
    assert np.isfinite(dg).all()
    assert ident >= 0.9, (name, ident)
    assert abs(pg - pw) <= 0.05, (name, pg, pw)
    return ident, pg, pw, mix


def test_configurations_cover_the_inputs():
    """Four -a, three RGBM, three non-finite and fourteen 3D
    configurations, each committed, the 3D ones at every legal 3D
    footprint."""
    groups = [c["group"] for c in CONFIGS.values()]
    assert [groups.count(g) for g in "AMNV"] == [4, 3, 3, 14]
    assert {c["block"] for c in CONFIGS.values()
            if c["preset"] == "fastest" and c["group"] == "V"} \
        == set(LEGAL_3D)
    for name in CONFIGS:
        assert os.path.exists(fixture_path(name)), name


@pytest.mark.parametrize("name", list(CONFIGS))
def test_feature_matches_jax(name):
    check_fixture(name)


def test_nonfinite_cases_decode_finite():
    """Each of the 36 non-finite cases (a fixture's block each) decodes to
    finite texels, and the texels that held 0.5 decode near it (the check
    of tests/test_nan_inputs.py)."""
    for name in (k for k, c in CONFIGS.items() if c["kind"] == "nonfinite"):
        c = CONFIGS[name]
        ctx = tapi.context_alloc(config(tapi, c), device="cpu")
        blocks = tapi.compress_image(ctx, image(c))
        out = tapi.decompress_image(ctx, blocks, 48, 4, 1, out_type="f32")[0]
        for k in range(12):
            blk = out[:, 4 * k:4 * k + 4]
            assert np.isfinite(blk).all(), (name, k)
            assert abs(float(blk[3, 3, 1]) - 0.5) < 0.1, (name, k)


def _encode(img, flags, preset=60.0):
    cfg = tapi.config_init(tapi.Profile.LDR, 6, 6, 1, preset, flags)
    return tapi.compress_image(tapi.context_alloc(cfg, device="cpu"), img)


def test_alpha_weight_opaque_is_bit_identical():
    """-a on an opaque image gives the blocks of the encode without it
    (every block's scale is 1; tests/test_alpha_weight.py:45); on a
    translucent image some blocks differ (:53)."""
    img = testdata.synthetic_image(24, 36, 11)
    img[..., 3] = 255
    a = int(tapi.Flags.USE_ALPHA_WEIGHT)
    assert np.array_equal(_encode(img, 0), _encode(img, a))
    img = testdata.footprint_image("ldr_holes", 24, 36, 12)
    assert not np.array_equal(_encode(img, 0), _encode(img, a))


def test_block_state_cw_scale():
    """``make_block_state``'s per-block scale is the block's largest alpha
    over 65535 (tests/test_alpha_weight.py:61), and absent without the
    flag."""
    tex = torch.zeros((3, 16, 4))
    tex[0, :, 3] = 65535.0
    tex[1, :, 3] = 32767.5
    tex[2, 5, 3] = 13107.0
    st = tcomp.make_block_state(tex, 1, alpha_weight=True)
    s = st["cw_scale"].numpy()
    assert s.dtype == np.float32
    assert s[0] == pytest.approx(1.0)
    assert s[1] == pytest.approx(0.5, abs=1e-4)
    assert s[2] == np.float32(13107.0) * np.float32(1.0 / 65535.0)
    assert "cw_scale" not in tcomp.make_block_state(tex, 1)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CONFIGS))
def test_rebuild_fixture_unchanged(tmp_path, name):
    write_fixtures([name], str(tmp_path))
    got, want = np.load(fixture_path(name, str(tmp_path))), np.load(
        fixture_path(name))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])


# Block 6 of 4x4_medium_rgbm, the one block of the feature fixtures that is
# not JAX's: its 2-plane trial for component 3 (M), candidate 2, lane 2 of
# the round-0 refit when the block is repeated C5_ROWS times.
C5_FIXTURE = os.path.join(os.path.dirname(FIXTURES), "torch_known",
                          "rgbm_block6_refit.npz")
C5_BLOCK, C5_ROWS, C5_LANE = 6, 8, 2


def _c5_port_round0():
    """The port's 2-plane records of block C5_BLOCK (its rows repeated
    C5_ROWS times, every component trying) and the arguments and results
    of the round-0 refit and colour pack of lane C5_LANE."""
    c = CONFIGS["4x4_medium_rgbm"]
    ctx = tapi.context_alloc(config(tapi, c), device="cpu")
    tex = np.repeat(tcomp.image_to_blocks(ctx, image(c))[
        C5_BLOCK:C5_BLOCK + 1], C5_ROWS, 0)
    _, aux = tcomp.stage1_1plane(ctx, torch.from_numpy(tex))
    seen = {}
    refit, pack = (trecompute.recompute_ideal_colors_2planes,
                   tpack.pack_color_endpoints_ldr)

    def spy(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            seen.setdefault(name, (args, out))
            return out
        return call

    trecompute.recompute_ideal_colors_2planes = spy("refit", refit)
    tpack.pack_color_endpoints_ldr = spy("pack", pack)
    try:
        recs = ttrial.trial2_records(
            aux["st"], ctx.pass_tables("two"), ctx.config, 1, False,
            aux["quant_limit"], torch.ones((C5_ROWS, 4), dtype=torch.bool),
            use_kernels=False)
    finally:
        trecompute.recompute_ideal_colors_2planes = refit
        tpack.pack_color_endpoints_ldr = pack
    return ({k: v.numpy() for k, v in recs.items()}, seen["refit"],
            seen["pack"][0], (tex, aux["quant_limit"].numpy()))


def write_c5_fixture(path=C5_FIXTURE):
    """JAX's side of the block: its jitted records, and its refit run
    eagerly and under ``jax.jit`` on the port's round-0 refit arguments
    (every lane; lane C5_LANE kept)."""
    import jax
    import jax.numpy as jnp
    from astcenc_tpu import api as japi
    from astcenc_tpu.codec import compress as jc
    from astcenc_tpu.ops import recompute as jrecompute
    c = CONFIGS["4x4_medium_rgbm"]
    _, (args, _), _, (tex, quant_limit) = _c5_port_round0()
    jargs = [jnp.asarray(a.numpy()) if torch.is_tensor(a) else a
             for a in args]
    eager = jrecompute.recompute_ideal_colors_2planes(*jargs)
    jit = jax.jit(jrecompute.recompute_ideal_colors_2planes,
                  static_argnums=4)(*jargs)
    jctx = japi.context_alloc(config(japi, c))
    cfgs = jc._CfgStatic(jctx.config)
    st = jc.make_block_state(jnp.asarray(tex), cfgs.channel_weights, 1)
    recs = jc._trial2_recs_jit(
        japi._enc_key(jctx.bsd), cfgs, 1, False, st,
        jnp.ones((C5_ROWS, 4), bool), jnp.asarray(quant_limit))
    L = C5_LANE
    np.savez(path, **{f"eager_{k}": np.asarray(eager[k])[L]
                      for k in ("ep0", "ep1", "rgbs")},
             **{f"jit_{k}": np.asarray(jit[k])[L]
                for k in ("ep0", "ep1", "rgbs")},
             jax_vals=np.asarray(recs["vals"])[0],
             jax_err=np.asarray(recs["err"])[0])


def test_rgbm_block6_is_jax_jit_rounding():
    """The one RGBM block that is not JAX's (block 6 of 4x4_medium_rgbm,
    15 of 16) parts from JAX in the round-0 refit of its 2-plane trial for
    component 3, candidate 2. The port's refit there is JAX's refit run
    eagerly, bit for bit; JAX's jitted refit ends each RGB scale value one
    float32 step higher (64121.5 against 64121.496 and so on), and the
    colour pack's G scale sits on a rounding tie, so JAX packs 236 and the
    port 235. A last-bit difference of JAX's compilation, not a port
    fault: every record before candidate 2 agrees."""
    recs, (args, out), pack_args, _ = _c5_port_round0()
    fx = np.load(C5_FIXTURE)
    L = C5_LANE
    for k in ("ep0", "ep1", "rgbs"):
        np.testing.assert_array_equal(out[k][L].numpy(), fx[f"eager_{k}"])
    steps = (out["rgbs"][L].numpy().view(np.int32)
             - fx["jit_rgbs"].view(np.int32))
    assert steps.tolist() == [-1, -1, -1, 0], steps
    ep0, ep1, _, fmt_req, cq = (a[L:L + 1] for a in pack_args)
    fmt_p, v_p = tpack.pack_color_endpoints_ldr(ep0, ep1,
                                                out["rgbs"][L:L + 1],
                                                fmt_req, cq)
    fmt_j, v_j = tpack.pack_color_endpoints_ldr(
        ep0, ep1, torch.from_numpy(fx["jit_rgbs"][None]), fmt_req, cq)
    # The records: [r0-pre, r0-post, r1-post, r2-post] per candidate.
    assert int(fmt_p[0]) == int(fmt_j[0]) == 10
    np.testing.assert_array_equal(v_p[0].numpy(), recs["vals"][0, 8, 0])
    np.testing.assert_array_equal(v_j[0].numpy(), fx["jax_vals"][8, 0])
    assert (v_j - v_p)[0].tolist() == [0, 1, 0, 0, 0, 0, 0, 0]
    np.testing.assert_array_equal(recs["vals"][0, :8], fx["jax_vals"][:8])
    np.testing.assert_array_equal(recs["err"][0, :8], fx["jax_err"][:8])
    g = float(out["rgbs"][L, 1]) / 257.0
    print(f"block 6: G scale {g!r} (port) and "
          f"{float(fx['jit_rgbs'][1]) / 257.0!r} (JAX jitted) over 257")


@pytest.mark.slow
def test_rebuild_c5_fixture_unchanged(tmp_path):
    path = str(tmp_path / "c5.npz")
    write_c5_fixture(path)
    got, want = np.load(path), np.load(C5_FIXTURE)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
