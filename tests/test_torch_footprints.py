"""The astcenc_torch encoder at every legal 2D footprint and every preset on
the CPU, against the JAX package's blocks of the same images.

Each configuration has a committed fixture ``tests/data/torch_footprints/
<name>.npz``: the image's kind, seed and shape (``testdata.footprint_image``
makes it again), the profile, the footprint, the preset's name and quality,
the ``a_scale_radius`` override and JAX's blocks. The configurations:

- F: each legal 2D footprint at -fastest, LDR, on an image whose sides are
  not multiples of the footprint (the edge clamp);
- P: 4x4, 6x6, 8x8 and 12x12 at -fast, -medium, -thorough and -exhaustive,
  LDR, without 6x6 -medium (``tests/test_torch_main.py``). These reach the
  three preset tables: HIGH below 25 texels (4x4: no mode-0 pass, 512
  partitionings a count at -exhaustive), MID (6x6) and LOW (8x8, 12x12: T
  up to 144, W up to 64, 8 candidates and 4 rounds at -exhaustive);
- H: 4x4 -thorough -ch (HIGH rows, T = 16) and 12x12 -medium -cH (T = 144,
  HDR alpha);
- R: 6x6 -medium with ``a_scale_radius = 2`` on an image with transparent
  holes (``testdata.alpha_holes``): blocks inside a hole are masked, those
  at its edge are not;
- C: 4x4 -medium on a 32x32 image with transparent holes (64 blocks) on
  which JAX picks four partitions for a block (``4x4_medium_pc4``, the
  first fixture with a 4-partition block; ``test_four_partitions``).

The images hold 16 blocks, 9 at -exhaustive (``BLOCKS``). The tests ask of
the port's blocks what tests/test_torch_main.py asks at 6x6 -medium: at
least 90% identical to JAX's and the decode within 0.05 dB PSNR (mPSNR for
HDR) of JAX's blocks decoded by the port's decoder; each prints its share.
The -exhaustive cases are in tests/test_torch_footprints_exhaustive.py.

A JAX encode compiles for 45-540 s per configuration on a CPU, so tier-1
reads the fixtures; the ``slow`` test rebuilds one configuration with JAX
and compares it with the committed fixture. To rebuild them (one JAX
process at a time, one configuration per process; all 32 take one to two
hours):

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
        import test_torch_footprints as m; m.write_fixtures(['4x4_fastest'])"

(no argument writes every configuration), or check one with
``python -m pytest --runslow tests/test_torch_footprints.py -k
"rebuild and 4x4_fastest"``.
"""

import os

import numpy as np
import pytest
import torch

from astcenc_torch import api as tapi
from astcenc_torch import testdata
from astcenc_torch.codec import decompress as tdec
from astcenc_torch.codec.compress import blockify
from astcenc_torch.tables.percentile import LEGAL_2D_SIZES
from astcenc_torch.utils import metrics

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_footprints")
PRESETS = {"fastest": 0.0, "fast": 10.0, "medium": 60.0, "thorough": 98.0,
           "exhaustive": 100.0}
PROFILES = {"ldr": 1, "ch": 2, "cH": 3}
# Blocks across and down each image.
BLOCKS = {"exhaustive": 3}


def _configs():
    """name: dict(kind, profile, bx, by, preset, radius, shape, seed)."""
    out = {}

    def add(group, bx, by, preset, profile="ldr", radius=0, edge=0,
            suffix="", seed=None):
        name = f"{bx}x{by}_{preset}" + ("" if profile == "ldr"
                                        else f"_{profile}")
        if radius:
            name += f"_r{radius}"
        name += suffix
        nb = BLOCKS.get(preset, 4)
        kind = ("hdr" if profile != "ldr"
                else "ldr_holes" if radius or suffix else "ldr")
        shape = (nb * by - edge, nb * bx - edge) if kind != "ldr_holes" \
            else (8 * by, 8 * bx)
        out[name] = dict(group=group, kind=kind, profile=profile, bx=bx,
                         by=by, preset=preset, radius=radius, shape=shape,
                         seed=100 + len(out) if seed is None else seed)

    for bx, by in LEGAL_2D_SIZES:
        add("F", bx, by, "fastest", edge=1)
    for bx, by in ((4, 4), (6, 6), (8, 8), (12, 12)):
        for preset in ("fast", "medium", "thorough", "exhaustive"):
            if (bx, preset) != (6, "medium"):
                add("P", bx, by, preset)
    add("H", 4, 4, "thorough", "ch")
    add("H", 12, 12, "medium", "cH")
    add("R", 6, 6, "medium", radius=2)
    add("C", 4, 4, "medium", suffix="_pc4", seed=4)
    return out


CONFIGS = _configs()
EXHAUSTIVE = [k for k, c in CONFIGS.items() if c["preset"] == "exhaustive"]
OTHERS = [k for k in CONFIGS if k not in EXHAUSTIVE]


def fixture_path(name, root=FIXTURES):
    return os.path.join(root, f"{name}.npz")


def config(api, c):
    """The configuration ``c`` in the JAX package's or the port's API."""
    cfg = api.config_init(api.Profile(PROFILES[c["profile"]]), c["bx"],
                          c["by"], 1, PRESETS[c["preset"]], 0)
    cfg.a_scale_radius = c["radius"]
    return cfg


def image(c):
    h, w = c["shape"]
    return testdata.footprint_image(c["kind"], h, w, c["seed"])


def jax_blocks(name):
    """JAX's encode of configuration ``name`` (45-540 s of compile)."""
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
                 block=np.array([c["bx"], c["by"]], np.int32),
                 preset=c["preset"], quality=np.float32(PRESETS[c["preset"]]),
                 a_scale_radius=np.int32(c["radius"]),
                 blocks=jax_blocks(name))


def check_fixture(name, root=FIXTURES):
    """Encode configuration ``name`` with the port on the CPU and hold it to
    the committed JAX blocks. Returns (share identical, the port's dB, JAX's
    dB)."""
    c = CONFIGS[name]
    fx = np.load(fixture_path(name, root))
    assert str(fx["name"]) == name and str(fx["kind"]) == c["kind"]
    assert int(fx["seed"]) == c["seed"]
    assert tuple(fx["shape"]) == c["shape"]
    assert int(fx["profile"]) == PROFILES[c["profile"]]
    assert tuple(fx["block"]) == (c["bx"], c["by"])
    assert str(fx["preset"]) == c["preset"]
    assert int(fx["a_scale_radius"]) == c["radius"]
    img = image(c)
    h, w = c["shape"]
    ctx = tapi.context_alloc(config(tapi, c), device="cpu")
    got = tapi.compress_image(ctx, img)
    want = fx["blocks"]
    n = (-(-h // c["by"])) * (-(-w // c["bx"]))
    assert got.shape == want.shape == (n, 16)
    ident = float((got == want).all(1).mean())
    hdr = c["profile"] != "ldr"
    out = "f32" if hdr else "u8"
    dg = tapi.decompress_image(ctx, got, w, h, out_type=out)[0]
    dw = tapi.decompress_image(ctx, want, w, h, out_type=out)[0]
    if hdr:
        src = img.astype(np.float32)
        pg, pw = metrics.mpsnr(dg, src), metrics.mpsnr(dw, src)
    else:
        pg, pw = _psnr(dg, img), _psnr(dw, img)
    const, pc, planes = (t.numpy() for t in tdec.block_types(
        ctx.torch_decode_tables(), torch.from_numpy(got)))
    mix = {f"pc{p}": int(((pc == p) & ~const).sum()) for p in (1, 2, 3, 4)}
    mix["2plane"] = int(((planes == 2) & ~const).sum())
    mix["const"] = int(const.sum())
    print(f"{name}: {ident:.4f} of {n} blocks identical to JAX; "
          f"{'mPSNR' if hdr else 'PSNR'} {pg:.6f} dB, JAX {pw:.6f} dB; "
          f"blocks {mix}")
    assert np.isfinite(dg).all()
    assert ident >= 0.9, (name, ident)
    assert abs(pg - pw) <= 0.05, (name, pg, pw)
    return ident, pg, pw


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


def test_configurations_cover_footprints_and_presets():
    """Every legal 2D footprint at -fastest, the 4 x 4 grid of footprints
    and presets but the fixtured 6x6 -medium, two HDR, one alpha-scale
    and one 4-partition configuration: 33 fixtures, each committed."""
    groups = [c["group"] for c in CONFIGS.values()]
    assert [groups.count(g) for g in "FPHRC"] == [14, 15, 2, 1, 1]
    for name in CONFIGS:
        assert os.path.exists(fixture_path(name)), name


@pytest.mark.parametrize("name", OTHERS)
def test_footprint_matches_jax(name):
    check_fixture(name)


def test_alpha_scale_masks_blocks():
    """The R fixture's image has blocks that alpha-scale RDO zeroes (JAX's
    blocks there are constant transparent black) and blocks at a hole's
    edge with some zero alpha that it keeps."""
    name = next(k for k, c in CONFIGS.items() if c["radius"])
    c = CONFIGS[name]
    fx = np.load(fixture_path(name))
    ctx = tapi.context_alloc(config(tapi, c), device="cpu")
    dec = tapi.decompress_blocks(ctx, fx["blocks"]).numpy()
    masked = (dec == 0).all((1, 2))
    src = blockify(image(c)[None].astype(np.float32), (c["bx"], c["by"], 1))
    holes = (src[..., 3] == 0)
    edge = holes.any(1) & ~masked
    print(f"{name}: {int(masked.sum())} of {masked.size} blocks masked, "
          f"{int(edge.sum())} with transparent texels kept")
    assert masked.sum() >= 2 and edge.sum() >= 2
    assert (holes.all(1) | ~masked).all()


def test_four_partitions():
    """JAX's blocks of ``4x4_medium_pc4`` hold a 4-partition block, and
    the port's encode matches them (``test_footprint_matches_jax``) with a
    4-partition block of its own."""
    name = "4x4_medium_pc4"
    c = CONFIGS[name]
    ctx = tapi.context_alloc(config(tapi, c), device="cpu")
    want = np.load(fixture_path(name))["blocks"]
    got = tapi.compress_image(ctx, image(c))
    counts = []
    for blocks in (want, got):
        const, pc, _ = (t.numpy() for t in tdec.block_types(
            ctx.torch_decode_tables(), torch.from_numpy(blocks)))
        counts.append(np.nonzero((pc == 4) & ~const)[0].tolist())
    print(f"{name}: 4-partition blocks JAX {counts[0]}, port {counts[1]}")
    assert counts[0] and counts[1]


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CONFIGS))
def test_rebuild_fixture_unchanged(tmp_path, name):
    write_fixtures([name], str(tmp_path))
    got, want = np.load(fixture_path(name, str(tmp_path))), np.load(
        fixture_path(name))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
