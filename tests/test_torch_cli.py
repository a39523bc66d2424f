"""The port's CLI (``astcenc_torch.cli``) on the CPU, against the JAX
package's CLI on the same files.

The cases mirror tests/test_cli.py (all but ``test_rgbm_codec_utility``,
which tests ``tools/rgbm_codec.py``), plus a 48x48 6x6 -medium ``-dtrace``
case whose image makes the encoder try two planes and two and three
partitions. Each case runs the reference's command lines on small seeded
images (``_write_inputs``) through ``cli.main(args, device="cpu")``.

JAX's CLI on the same command lines is committed under
``tests/data/torch_cli/<case>/``: the .astc and .ktx files, the decoded
images, the ``-dimage`` PNGs, the ``-dtrace`` tree (gzipped) and
``meta.json`` (each command's exit code and its standard output with the
times masked). Tier-1 reads them and runs no JAX; the ``slow`` test
rebuilds a case with JAX and compares. To rebuild one:

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
        import test_torch_cli as m; m.write_fixtures(['dtrace_6x6_medium'])"

(no argument: every case; see README for how long each takes). The gates:

- the .astc and .ktx headers are byte for byte JAX's;
- at least 90% of the blocks are JAX's, and the decode's PSNR is within
  0.05 dB of JAX's blocks decoded by the port;
- JAX's blocks decoded by the port's CLI are JAX's decoded images exactly,
  and the port's own decoded images and diagnostic images equal JAX's
  wherever the blocks are equal;
- the printed lines have JAX's format, and JAX's numbers where every block
  is equal;
- the ``-dtrace`` tree has JAX's block, pass and candidate nodes with
  JAX's keys on every block, and on the blocks that are equal every
  integer value is JAX's; the float values (trial errors, correlations,
  printed with six digits) are summed in other orders, so at least 95% of
  them print the same and 99% agree within 1e-4;
- the negative paths give JAX's exit codes.
"""

import contextlib
import gzip
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from astcenc_torch import api as tapi
from astcenc_torch import cli as tcli
from astcenc_torch import testdata
from astcenc_torch.codec.trace import parse_trace
from astcenc_torch.io import astc_file, image_io, ktx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_cli")
_FILE = re.compile(r".*\.(png|astc|ktx|json|exr)$")
_DIAG = ("partitioning", "weight_plane2", "weight_density", "weight_quant",
         "color_quant", "cem_index", "cem_components", "cem_style",
         "cem_hdr")

# case: (input set, command lines); file names are relative to the case's
# folder.
CASES = {
    "roundtrip": ("small", [
        ["-cl", "in.png", "out.astc", "4x4", "-fastest"],
        ["-dl", "out.astc", "out.png"],
        ["-cl", "in.png", "out.ktx", "4x4", "-fastest", "-silent"],
        ["-dl", "out.ktx", "out_ktx.png"]]),
    "compare_metrics": ("small", [
        ["-tl", "in.png", "rt.png", "4x4", "-fastest"]]),
    "repeats": ("small", [
        ["-cl", "in.png", "out.astc", "4x4", "-fastest", "-repeats", "2"]]),
    "ssw": ("small", [
        ["-cl", "in.png", "out.astc", "4x4", "-fastest", "-ssw", "rgb",
         "-silent"]]),
    "zdim_3d": ("vol", [
        ["-cl", "vol.png", "vol.astc", "3x3x3", "-fastest", "-zdim", "3",
         "-silent"],
        ["-dl", "vol.astc", "vol_out.png"]]),
    "dtrace": ("small", [
        ["-cl", "in.png", "out.astc", "4x4", "-fastest", "-dtrace",
         "trace.json", "-silent"]]),
    "dimage": ("small", [
        ["-cl", "in.png", "dimg.astc", "4x4", "-fastest", "-dimage",
         "-silent"]]),
    "pp_normalize": ("normal", [
        ["-tl", "n.png", "n_out.png", "4x4", "-fastest", "-pp-normalize",
         "-silent"]]),
    "pp_premultiply": ("premul", [
        ["-tl", "p.png", "p_out.png", "4x4", "-fastest", "-pp-premultiply",
         "-silent"],
        ["-ts", "p.png", "p_out2.png", "4x4", "-fastest", "-pp-premultiply",
         "-silent"]]),
    "dtrace_6x6_medium": ("wide", [
        ["-cl", "in.png", "out.astc", "6x6", "-medium", "-dtrace",
         "trace.json", "-silent"]]),
    "negative": ("small", [
        [], ["-cl"], ["-cl", "in.png"], ["-cl", "in.png", "o.astc"],
        ["-cl", "in.png", "o.astc", "4x4"],
        ["-zz", "a", "b"],
        ["-cl", "in.png", "o.astc", "4x4", "-fastest", "-unknownflag"],
        ["-cl", "in.png", "o.astc", "4x4", "-fastest", "-zdim", "2"],
        ["-cl", "only.png", "o.astc", "3x3x3", "-fastest", "-zdim", "2"],
        ["-cl", "x.png", "y.astc", "4x4", "-fastest", "-pp-normalize",
         "-pp-premultiply"],
        ["-cl", "in.png", "o.astc", "4x4", "-fastest", "-ssw", "xyz"],
        ["-cl", "in.png", "o.astc", "4x4", "-fastest", "-ssw", "rgbaa"]]),
}


def _write_inputs(kind, folder):
    """The input images of an input set, written with Pillow."""
    if kind == "small":
        image_io.save_image(os.path.join(folder, "in.png"),
                            testdata.synthetic_image(16, 16, 41))
        # tests/test_cli.py's -zdim slice without its siblings
        rng = np.random.RandomState(6)
        image_io.save_image(os.path.join(folder, "only_0.png"),
                            rng.randint(0, 255, (6, 6, 4), np.uint8))
    elif kind == "wide":
        image_io.save_image(os.path.join(folder, "in.png"),
                            testdata.synthetic_image(48, 48, 3))
    elif kind == "vol":
        rng = np.random.RandomState(5)
        for zi in range(3):
            img = rng.randint(0, 255, (9, 9, 4), np.uint8)
            img[..., 3] = 255
            image_io.save_image(os.path.join(folder, f"vol_{zi}.png"), img)
    elif kind == "normal":
        img = np.zeros((8, 8, 4), np.uint8)
        img[...] = (200, 180, 220, 255)
        image_io.save_image(os.path.join(folder, "n.png"), img)
    elif kind == "premul":
        img = np.zeros((8, 8, 4), np.uint8)
        img[..., 0] = 200
        img[..., 3] = 128
        image_io.save_image(os.path.join(folder, "p.png"), img)


# The files each input set writes; the first is the image of the case.
_INPUTS = {"small": ("in.png", "only_0.png"), "wide": ("in.png",),
           "vol": ("vol_0.png", "vol_1.png", "vol_2.png"),
           "normal": ("n.png",), "premul": ("p.png",)}


def _paths(args, folder):
    return [os.path.join(folder, a) if _FILE.match(a) else a for a in args]


def _mask(text):
    """Standard output with every number of the performance block masked
    (times vary from run to run)."""
    out, perf = [], False
    for line in text.splitlines():
        perf = perf or line.startswith("Performance metrics")
        out.append(re.sub(r" *[0-9.]+", " #", line) if perf else line)
    return out


def run_case(main, name, folder, **kw):
    """Run a case's command lines with ``main`` in ``folder``. Returns
    (exit codes, standard outputs)."""
    kind, steps = CASES[name]
    _write_inputs(kind, folder)
    rcs, outs = [], []
    for args in steps:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                rc = main(_paths(args, folder), **kw)
            except SystemExit as e:
                rc = e.code
        rcs.append(rc)
        outs.append(buf.getvalue())
    return rcs, outs


def write_fixtures(names=None, root=FIXTURES):
    """JAX's CLI outputs of each case in ``names`` (every case by default),
    written under ``root/<case>/``."""
    import tempfile
    from astcenc_tpu import cli as jcli
    for name in names or list(CASES):
        dest = os.path.join(root, name)
        shutil.rmtree(dest, ignore_errors=True)
        os.makedirs(dest)
        with tempfile.TemporaryDirectory() as work:
            rcs, outs = run_case(jcli.main, name, work)
            inputs = set(_INPUTS[CASES[name][0]])
            for f in sorted(os.listdir(work)):
                if f in inputs:
                    continue
                src = os.path.join(work, f)
                if f.endswith(".json"):
                    with open(src, "rb") as a, gzip.GzipFile(
                            os.path.join(dest, f + ".gz"), "wb",
                            mtime=0) as b:
                        b.write(a.read())
                else:
                    shutil.copy(src, os.path.join(dest, f))
        with open(os.path.join(dest, "meta.json"), "w") as f:
            json.dump({"rcs": rcs, "stdout": [_mask(o) for o in outs]}, f,
                      indent=1)


def _meta(name):
    with open(os.path.join(FIXTURES, name, "meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ported(tmp_path_factory):
    """Run each case with the port's CLI once; {case: (folder, rcs,
    outputs)}."""
    done = {}

    def get(name):
        if name not in done:
            folder = str(tmp_path_factory.mktemp(name))
            rcs, outs = run_case(tcli.main, name, folder, device="cpu")
            done[name] = (folder, rcs, outs)
        return done[name]
    return get


def _fx(name, f):
    return os.path.join(FIXTURES, name, f)


def _load_input(folder, name):
    kind = CASES[name][0]
    if kind == "vol":
        return np.stack([image_io.load_image(os.path.join(
            folder, f"vol_{z}.png"))[0] for z in range(3)])
    return image_io.load_image(os.path.join(folder, _INPUTS[kind][0]))[0][
        None]


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 999.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def check_blocks(name, folder, fname, profile=tapi.Profile.LDR):
    """The port's compressed file against JAX's: the header byte for byte,
    >= 90% of the blocks, the decode within 0.05 dB. Returns (the mask of
    equal blocks, the footprint, the image dims, the share)."""
    mine, theirs = os.path.join(folder, fname), _fx(name, fname)
    if fname.endswith(".ktx"):
        raw = open(theirs, "rb").read()
        kv = int.from_bytes(raw[60:64], "little")
        head = 64 + kv + 4
        _, bd, dims, got, _ = ktx.read_ktx(mine)
        _, _, _, want, _ = ktx.read_ktx(theirs)
    else:
        head = 16
        bd, dims, got = astc_file.read_astc(mine)
        _, _, want = astc_file.read_astc(theirs)
    assert open(mine, "rb").read()[:head] == open(theirs, "rb").read()[:head]
    assert got.shape == want.shape
    same = (got == want).all(1)
    ctx = tapi.context_alloc(tapi.config_init(profile, *bd, 60.0, 0),
                             device="cpu")
    src = _load_input(folder, name)
    pg, pw = (_psnr(tapi.decompress_image(ctx, b, *dims), src)
              for b in (got, want))
    print(f"{name}/{fname}: {same.mean():.4f} of {same.size} blocks "
          f"identical to JAX; PSNR {pg:.6f} dB, JAX {pw:.6f} dB")
    assert same.mean() >= 0.9 and abs(pg - pw) <= 0.05, (same.mean(), pg,
                                                          pw)
    return same, bd, dims, float(same.mean())


def _block_mask(same, bd, dims):
    """(H, W) mask of the texels of equal blocks (2D)."""
    w, h = dims[0], dims[1]
    nx, ny = -(-w // bd[0]), -(-h // bd[1])
    m = same[:nx * ny].reshape(ny, nx)
    return np.kron(m, np.ones(bd[1::-1], bool))[:h, :w]


def check_image(name, folder, fname, mask=None):
    """The port's decoded (or diagnostic) image against JAX's: equal on the
    texels of ``mask`` (every texel by default)."""
    got = image_io.load_image(os.path.join(folder, fname))[0]
    want = image_io.load_image(_fx(name, fname))[0]
    assert got.shape == want.shape, fname
    sel = np.ones(got.shape[:2], bool) if mask is None else mask
    np.testing.assert_array_equal(got[sel], want[sel], err_msg=fname)
    return got


def check_stdout(name, outs, identical):
    """The printed lines in JAX's format; JAX's numbers where every block
    is JAX's."""
    want = _meta(name)["stdout"]
    for got, w in zip(outs, want):
        got = _mask(got)
        assert [re.sub(r" *[0-9.]+", " #", x) for x in got] == [
            re.sub(r" *[0-9.]+", " #", x) for x in w]
        if identical:
            assert got == w


def check_jax_decode(name, folder, compressed, decoded):
    """JAX's compressed file decoded by the port's CLI is JAX's decoded
    image exactly."""
    out = os.path.join(folder, "jax_" + decoded)
    assert tcli.main(["-dl", _fx(name, compressed), out], device="cpu") == 0
    np.testing.assert_array_equal(image_io.load_image(out)[0],
                                  image_io.load_image(_fx(name, decoded))[0])


def _trace_values(node, out):
    _, attrs, children = node
    for k, v in attrs.items():
        for x in (v if isinstance(v, list) else [v]):
            out.append((k, x))
    for c in children:
        _trace_values(c, out)
    return out


def _shape(node):
    name, attrs, children = node
    return name, tuple(sorted(attrs)), tuple(_shape(c) for c in children)


def check_trace(name, folder, same):
    """The port's -dtrace tree against JAX's (see the module docstring)."""
    mine = parse_trace(os.path.join(folder, "trace.json"))
    with gzip.open(_fx(name, "trace.json.gz"), "rt") as f:
        theirs_path = os.path.join(folder, "jax_trace.json")
        open(theirs_path, "w").write(f.read())
    theirs = parse_trace(theirs_path)
    assert mine[0] == theirs[0] == "root"
    bm, bt = mine[2], theirs[2]
    assert len(bm) == len(bt) == same.size
    floats = []
    for i, (a, b) in enumerate(zip(bm, bt)):
        assert _shape(a) == _shape(b), i
        if not same[i]:
            continue
        for (ka, va), (kb, vb) in zip(_trace_values(a, []),
                                      _trace_values(b, [])):
            assert ka == kb
            if isinstance(vb, float):
                floats.append((va, vb))
            else:
                assert va == vb, (i, ka, va, vb)
    va, vb = np.array(floats).T
    rel = np.abs(va - vb) / np.maximum(np.maximum(np.abs(va), np.abs(vb)),
                                       1e-30)
    passes = sum(c[0] == "pass" for b in bm for c in b[2])
    print(f"{name}: {len(bm)} blocks, {passes} pass nodes; of {rel.size} "
          f"float values on equal blocks {np.mean(rel == 0):.4f} print the "
          f"same, {np.mean(rel < 1e-4):.4f} within 1e-4, largest "
          f"{rel.max():.3g}")
    assert np.mean(rel == 0) >= 0.95 and np.mean(rel < 1e-4) >= 0.99
    return mine


# --- the cases of tests/test_cli.py -------------------------------------

def test_compress_decompress_roundtrip(ported):
    folder, rcs, outs = ported("roundtrip")
    assert rcs == _meta("roundtrip")["rcs"] == [0, 0, 0, 0]
    assert "Coding rate" in outs[0] and "Coding time" in outs[0]
    for comp, dec in (("out.astc", "out.png"), ("out.ktx", "out_ktx.png")):
        same, bd, dims, share = check_blocks("roundtrip", folder, comp)
        check_image("roundtrip", folder, dec, _block_mask(same, bd, dims))
        check_jax_decode("roundtrip", folder, comp, dec)
    check_stdout("roundtrip", outs, share == 1.0)


def test_roundtrip_compare_metrics(ported):
    folder, rcs, outs = ported("compare_metrics")
    assert rcs == _meta("compare_metrics")["rcs"] == [0]
    for label in ("Quality metrics", "PSNR (LDR-RGBA):",
                  "Alpha-weighted PSNR:", "PSNR (LDR-RGB):",
                  "Performance metrics", "Decoding rate"):
        assert label in outs[0]
    # The same image and encode as the roundtrip case's out.astc.
    bd, dims, got = astc_file.read_astc(os.path.join(ported("roundtrip")[0],
                                                     "out.astc"))
    _, _, want = astc_file.read_astc(_fx("roundtrip", "out.astc"))
    same = (got == want).all(1)
    check_image("compare_metrics", folder, "rt.png",
                _block_mask(same, bd, dims))
    check_stdout("compare_metrics", outs, bool(same.all()))
    print(outs[0])


def test_repeats_flag(ported):
    folder, rcs, outs = ported("repeats")
    assert rcs == _meta("repeats")["rcs"] == [0]
    assert "Coding time" in outs[0]
    _, _, _, share = check_blocks("repeats", folder, "out.astc")
    check_stdout("repeats", outs, share == 1.0)


def test_ssw_flag_parses_and_zeroes_weights(ported):
    from astcenc_tpu import cli as jcli
    folder, rcs, _ = ported("ssw")
    assert rcs == _meta("ssw")["rcs"] == [0]
    check_blocks("ssw", folder, "out.astc")
    args = ["4x4", "-fastest", "-ssw", "rga"]
    opts = tcli._parse_options(args, True)
    assert opts == jcli._parse_options(args, True)
    ov = opts["overrides"]
    assert ov["cw_r_weight"] == 1.0 and ov["cw_g_weight"] == 1.0
    assert ov["cw_b_weight"] == 0.0 and ov["cw_a_weight"] == 1.0


def test_ssw_invalid_pattern():
    for pat in ("xyz", "rgbaa"):
        with pytest.raises(SystemExit):
            tcli._parse_options(["4x4", "-fastest", "-ssw", pat], True)


def _negative(ported):
    folder, rcs, _ = ported("negative")
    want = _meta("negative")["rcs"]
    assert rcs == want, (rcs, want)
    return dict(zip(map(tuple, CASES["negative"][1]), rcs))


def test_zdim_2d_block_error(ported):
    rc = _negative(ported)[("-cl", "in.png", "o.astc", "4x4", "-fastest",
                            "-zdim", "2")]
    assert rc == 1


def test_zdim_3d_slices(ported):
    folder, rcs, _ = ported("zdim_3d")
    assert rcs == _meta("zdim_3d")["rcs"] == [0, 0]
    bd, idim, _ = astc_file.read_astc(os.path.join(folder, "vol.astc"))
    assert bd == (3, 3, 3) and idim[2] == 3
    same, _, _, share = check_blocks("zdim_3d", folder, "vol.astc")
    if share == 1.0:
        check_image("zdim_3d", folder, "vol_out.png")
    check_jax_decode("zdim_3d", folder, "vol.astc", "vol_out.png")


def test_zdim_missing_slice_fails(ported):
    rc = _negative(ported)[("-cl", "only.png", "o.astc", "3x3x3",
                            "-fastest", "-zdim", "2")]
    assert rc == 1


def test_negative_missing_args(ported):
    codes = _negative(ported)
    for args in CASES["negative"][1][:7]:
        rc = codes[tuple(args)]
        assert rc in (0, 1)
        if args and args[0] == "-cl" and len(args) >= 5 \
                and "-unknownflag" not in args:
            continue
        if args:
            assert rc == 1, args


def test_mpsnr_flag_parses():
    from astcenc_tpu import cli as jcli
    args = ["4x4", "-fastest", "-mpsnr", "-5", "5"]
    opts = tcli._parse_options(args, True)
    assert opts["mpsnr"] == (-5, 5)
    assert opts == jcli._parse_options(args, True)


def test_dtrace_tree(ported):
    folder, rcs, _ = ported("dtrace")
    assert rcs == _meta("dtrace")["rcs"] == [0]
    same, _, _, _ = check_blocks("dtrace", folder, "out.astc")
    name, attrs, children = check_trace("dtrace", folder, same)
    blocks = [c for c in children if c[0] == "block"]
    assert len(blocks) == 16
    assert "pos_x" in blocks[0][1] and "tune_error_threshold" in blocks[0][1]
    passes = [c for c in blocks[0][2] if c[0] == "pass"]
    assert passes and "partition_count" in passes[0][1]
    cands = [c for b in blocks for p in b[2] if p[0] == "pass"
             for c in p[2] if c[0] == "candidate"]
    assert cands and "weight_quant" in cands[0][1]
    assert "error_prerealign" in cands[0][1]


def test_dimage_set(ported):
    folder, rcs, _ = ported("dimage")
    assert rcs == _meta("dimage")["rcs"] == [0]
    same, bd, dims, _ = check_blocks("dimage", folder, "dimg.astc")
    mask = _block_mask(same, bd, dims)
    for suffix in _DIAG:
        img = check_image("dimage", folder, f"dimg_diag_{suffix}.png", mask)
        assert img.shape[:2] == (16, 16)


def test_pp_normalize(ported):
    folder, rcs, _ = ported("pp_normalize")
    assert rcs == _meta("pp_normalize")["rcs"] == [0]
    dec = check_image("pp_normalize", folder, "n_out.png")
    v = dec[..., :3].astype(np.float32) / 255.0 * 2.0 - 1.0
    assert np.all(np.abs(np.sqrt((v * v).sum(-1)) - 1.0) < 0.1)


def test_pp_premultiply(ported):
    folder, rcs, _ = ported("pp_premultiply")
    assert rcs == _meta("pp_premultiply")["rcs"] == [0, 0]
    dec = check_image("pp_premultiply", folder, "p_out.png")
    dec2 = check_image("pp_premultiply", folder, "p_out2.png")
    assert abs(int(dec[0, 0, 0]) - 100) <= 6
    assert int(dec2[0, 0, 0]) > int(dec[0, 0, 0]) + 10


def test_pp_exclusive(ported):
    rc = _negative(ported)[("-cl", "x.png", "y.astc", "4x4", "-fastest",
                            "-pp-normalize", "-pp-premultiply")]
    assert rc != 0


# --- beyond tests/test_cli.py ---------------------------------------------

def test_dtrace_6x6_medium(ported):
    """6x6 -medium on 48x48: the tree holds 1-plane, 2-plane (every
    ``plane_component`` node) and 2- and 3-partition passes
    (``partition_index``), and every block its ``lowest_correl``."""
    folder, rcs, _ = ported("dtrace_6x6_medium")
    assert rcs == _meta("dtrace_6x6_medium")["rcs"] == [0]
    same, _, _, _ = check_blocks("dtrace_6x6_medium", folder, "out.astc")
    _, _, blocks = check_trace("dtrace_6x6_medium", folder, same)
    kinds = {(p[1]["partition_count"], p[1]["plane_count"])
             for b in blocks for p in b[2] if p[0] == "pass"}
    assert {(1, 1), (1, 2), (2, 1), (3, 1)} <= kinds
    assert all("lowest_correl" in b[1] for b in blocks)
    assert any("plane_component" in p[1] for b in blocks for p in b[2]
               if p[0] == "pass")
    assert any("partition_index" in p[1] for b in blocks for p in b[2]
               if p[0] == "pass")


def test_main_module_usage():
    """``python -m astcenc_torch`` with no arguments prints the usage and
    exits 0 (every other command needs the card)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "astcenc_torch"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("astcenc-torch:")


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CASES))
def test_rebuild_fixture_unchanged(tmp_path, name):
    write_fixtures([name], str(tmp_path))
    want = sorted(os.listdir(os.path.join(FIXTURES, name)))
    assert sorted(os.listdir(os.path.join(str(tmp_path), name))) == want
    for f in want:
        a = os.path.join(str(tmp_path), name, f)
        b = os.path.join(FIXTURES, name, f)
        if f.endswith(".gz"):
            assert gzip.open(a).read() == gzip.open(b).read(), f
        elif f.endswith(".png"):
            np.testing.assert_array_equal(image_io.load_image(a)[0],
                                          image_io.load_image(b)[0])
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), f
