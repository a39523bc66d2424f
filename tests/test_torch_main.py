"""The astcenc_torch main path end to end on the CPU: 6x6 LDR -medium, MID
preset with nothing overridden (stage 1, stage 2a, stage 2b, finalize),
through the port's api.compress_image, against the JAX package's
api.compress_image on two seeded images: a 96x96 synthetic image and a
48x48 one whose right half has an independent alpha channel. At least 90%
of blocks identical and the decoded PSNR within 0.05 dB, per image.

A JAX -medium encode compiles for minutes on a CPU, so both images go
through JAX in one call, side by side on one canvas (the block grid keeps
them apart: blocks never straddle the seam): ``jax_reference``. Its
results never change, so they are committed as NumPy fixtures and the
tests read those: ``tests/data/torch_ldr/ref_medium_<name>.npz`` (the
seed, the shape, the independent-alpha flag and JAX's blocks of each
image; the card's tests, which have no jax, read them too:
tests/test_torch_cuda.py, chip_smoke.py) and ``ref_medium_scb.npz`` (the
canvas's symbolic blocks as JAX's finalize step hands them to the pack,
and their JAX physical blocks; tests/test_torch_physical.py packs them).
The ``slow`` test encodes with JAX again, rewrites the fixtures into a
temporary directory and compares them with the committed ones. To rebuild
them:

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
        import test_torch_main as m; m.write_fixtures()"
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astcenc_tpu import api as japi
from astcenc_tpu.codec import compress as jc
from astcenc_torch import api as tapi
from astcenc_torch import testdata
from astcenc_torch.codec import compress as tc
from astcenc_torch.codec import decompress as tdec

torch.set_num_threads(2)

# name: (height, width, seed, independent alpha)
IMAGES = {"rgba96": (96, 96, 0, False), "alpha48": (48, 48, 3, True)}
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_ldr")


def fixture_path(name, root=FIXTURES):
    return os.path.join(root, f"ref_medium_{name}.npz")


def load_scb_fixture(root=FIXTURES):
    """(scb, packed): the committed symbolic blocks of the canvas and their
    JAX physical blocks."""
    fx = np.load(fixture_path("scb", root))
    return ({k[4:]: fx[k] for k in fx.files if k.startswith("scb_")},
            fx["packed"])


def write_fixtures(root=FIXTURES):
    """JAX's blocks of each image (``jax_reference()``) as a fixture."""
    ref = jax_reference()
    os.makedirs(root, exist_ok=True)
    for name, (h, w, seed, alpha) in IMAGES.items():
        np.savez(fixture_path(name, root), seed=np.int32(seed),
                 shape=np.array([h, w], np.int32),
                 independent_alpha=np.bool_(alpha),
                 blocks=ref["blocks"][name])
    np.savez_compressed(fixture_path("scb", root), packed=ref["packed"],
                        **{f"scb_{k}": v for k, v in ref["scb"].items()})


def config(api):
    return api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


def _canvas_rows():
    """Rows of each image's blocks in the 16 x 24 block canvas."""
    by, bx = np.divmod(np.arange(16 * 24), 144 // 6)
    return {"rgba96": np.nonzero(bx < 16)[0],
            "alpha48": np.nonzero((bx >= 16) & (by < 8))[0]}


def _images():
    return {k: testdata.synthetic_image(h, w, s, independent_alpha=a)
            for k, (h, w, s, a) in IMAGES.items()}


@functools.lru_cache(maxsize=None)
def jax_reference():
    """JAX's encode of both images in one call. Returns a dict: images,
    per-image JAX blocks ``blocks[name]`` and block rows into the canvas
    ``rows[name]``, and ``scb``: the canvas's symbolic blocks as JAX's
    finalize step hands them to the pack, with ``packed`` their JAX
    physical blocks."""
    imgs = _images()
    canvas = np.zeros((96, 144, 4), np.uint8)
    canvas[:, :96] = imgs["rgba96"]
    canvas[:48, 96:] = imgs["alpha48"]
    canvas[48:, 96:] = imgs["alpha48"][::-1]
    jctx = japi.context_alloc(config(japi))
    got = japi.compress_image(jctx, canvas)
    rows = _canvas_rows()

    # The same batch through JAX's stages (compress_symbolic_batch at the
    # bucket compress_image padded to, so every stage reuses its compile).
    tctx = tapi.context_alloc(config(tapi), device="cpu")
    tex = tc.image_to_blocks(tctx, canvas)
    n = tex.shape[0]
    bucket = max(64, 1 << (n - 1).bit_length())
    tex = jnp.asarray(np.concatenate(
        [tex, np.broadcast_to(tex[:1], (bucket - n,) + tex.shape[1:])]))
    ek = japi._enc_key(jctx.bsd)
    cfgs = jc._CfgStatic(jctx.config)
    scb, aux = jc._stage1_1plane(jctx._dtables_key, ek, cfgs, tex)
    scb = jc._stage2a_2plane(ek, cfgs, tex, scb, aux["quant_limit"],
                             aux["best0"])
    scb = jc._stage2b_multipart(ek, cfgs, tex, scb, aux["quant_limit"],
                                aux["best0"])
    s = dict(scb)
    err = s["block_type_error"]
    s["const_u16"] = aux["is_const"] | (err & ~aux["is_const"])
    s["const_f16"] = jnp.zeros_like(err)
    s["constant_color"] = aux["const_color"]
    s["block_mode"] = jnp.where(err, int(ek.tables.m1_mode_index[0]),
                                s["block_mode"])
    s["quant_mode"] = jnp.where(err, 4, s["quant_mode"])
    s["partition_count"] = jnp.where(err, 1, s["partition_count"])
    packed = np.array(jc._pack_jit(jctx._dtables_key, s))[:n]
    np.testing.assert_array_equal(packed, got)
    return {"images": imgs, "jctx": jctx, "rows": rows,
            "blocks": {k: got[r] for k, r in rows.items()},
            "scb": {k: np.array(v)[:n] for k, v in s.items()},
            "packed": packed}


@pytest.fixture(scope="module")
def ref():
    """``jax_reference()``'s results, read from the committed fixtures."""
    scb, packed = load_scb_fixture()
    return {"images": _images(), "rows": _canvas_rows(),
            "blocks": {k: np.load(fixture_path(k))["blocks"]
                       for k in IMAGES},
            "scb": scb, "packed": packed}


def _kinds(scb, rows):
    ok = ~scb["block_type_error"][rows]
    pc = scb["partition_count"][rows]
    two = scb["plane2_component"][rows] >= 0
    return {"2plane": int((ok & two).sum()), "pc2": int((ok & (pc == 2)).sum()),
            "pc3": int((ok & (pc == 3)).sum())}


@pytest.mark.parametrize("name", list(IMAGES))
def test_main_path_matches_jax(ref, name):
    img = ref["images"][name]
    h, w = img.shape[:2]
    tctx = tapi.context_alloc(config(tapi), device="cpu")
    got = tapi.compress_image(tctx, img)
    want = ref["blocks"][name]
    assert got.shape == want.shape == ((h // 6) * (w // 6), 16)
    ident = (got == want).all(1).mean()
    assert ident >= 0.9, ident
    # JAX's blocks decoded by the port's decoder, which is JAX's bit for
    # bit (tests/test_torch_decode.py).
    dg = tapi.decompress_image(tctx, got, w, h)[0]
    dw = tapi.decompress_image(tctx, want, w, h)[0]
    pg, pw = _psnr(dg, img), _psnr(dw, img)
    # Every later stage decides blocks of this image in JAX's encode.
    kinds = _kinds(ref["scb"], ref["rows"][name])
    print(f"{name}: {ident:.4f} of blocks identical to JAX; PSNR "
          f"{pg:.6f} dB, JAX {pw:.6f} dB; JAX's blocks won by later "
          f"stages {kinds}")
    assert abs(pg - pw) <= 0.05
    assert min(kinds.values()) >= 1, kinds
    # The port's blocks hold those kinds too, read from their headers.
    const, pc, planes = tdec.block_types(tctx.torch_decode_tables(),
                                         torch.from_numpy(got))
    assert (planes == 2).any() and (pc == 2).any() and (pc == 3).any()
    assert not (const & (planes == 2)).any()


def test_block_types_match_symbolic(ref):
    """decompress.block_types reads back what JAX's symbolic blocks say."""
    tctx = tapi.context_alloc(config(tapi), device="cpu")
    s = ref["scb"]
    const, pc, planes = (x.numpy() for x in tdec.block_types(
        tctx.torch_decode_tables(), torch.from_numpy(ref["packed"])))
    np.testing.assert_array_equal(const, s["const_u16"])
    real = ~s["const_u16"]
    np.testing.assert_array_equal(pc[real], s["partition_count"][real])
    np.testing.assert_array_equal(planes[real] == 2,
                                  s["plane2_component"][real] >= 0)


@pytest.mark.parametrize("name", list(IMAGES))
def test_fixture_matches_jax(ref, name):
    """The committed fixture of this image names the image and holds JAX's
    blocks of it: those of the committed canvas at the image's rows (the
    slow test_rebuild_fixture_unchanged holds both to a fresh JAX
    encode)."""
    h, w, seed, alpha = IMAGES[name]
    fx = np.load(fixture_path(name))
    assert int(fx["seed"]) == seed and tuple(fx["shape"]) == (h, w)
    assert bool(fx["independent_alpha"]) == alpha
    np.testing.assert_array_equal(fx["blocks"],
                                  ref["packed"][ref["rows"][name]])


def test_canvas_fixture_decodes_to_images(ref):
    """The committed canvas blocks encode this file's images: each image's
    rows, decoded by the port, give the PSNR of JAX's encode of it
    (34.377785 and 30.941039 dB, printed by test_main_path_matches_jax at
    the fixtures' making)."""
    tctx = tapi.context_alloc(config(tapi), device="cpu")
    for name, want_db in (("rgba96", 34.377785), ("alpha48", 30.941039)):
        img = ref["images"][name]
        h, w = img.shape[:2]
        dec = tapi.decompress_image(
            tctx, ref["packed"][ref["rows"][name]], w, h)[0]
        assert abs(_psnr(dec, img) - want_db) < 1e-5, name


@pytest.mark.slow
def test_rebuild_fixture_unchanged(tmp_path):
    write_fixtures(str(tmp_path))
    for name in list(IMAGES) + ["scb"]:
        got, want = np.load(fixture_path(name, str(tmp_path))), np.load(
            fixture_path(name))
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])
