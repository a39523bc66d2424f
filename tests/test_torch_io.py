"""The port's file containers, image I/O and metrics against the JAX
package's, on the CPU.

``astcenc_torch/io`` and ``astcenc_torch/utils/metrics.py`` are the port's
own copies of the JAX package's NumPy-only modules. Each case below runs
the same inputs through both packages and asks for the same bytes on disk,
the same arrays back, the same exception class on a malformed file, and
metrics equal to the last float64 digit. No encode runs here.

The cases of tests/test_io_containers.py, each through both packages, but
two: ``test_exr_interop_with_reference`` needs the reference encoder's
binary and ``test_exr_piz_corpus`` its test images, which no host of this
project holds. Neither package's ``write_exr`` writes PIZ (it writes only
uncompressed files), so the PIZ reader is held piece by piece: the inverse
wavelet on seeded arrays, the Huffman and PIZ decoders on seeded byte
strings (the same output or the same error class).
"""

import os
import struct
import zlib

import numpy as np
import pytest

from astcenc_torch.io import astc_file as t_astc
from astcenc_torch.io import dds as t_dds
from astcenc_torch.io import exr as t_exr
from astcenc_torch.io import image_io as t_image_io
from astcenc_torch.io import ktx as t_ktx
from astcenc_torch.utils import metrics as t_metrics
from astcenc_tpu.io import astc_file as j_astc
from astcenc_tpu.io import dds as j_dds
from astcenc_tpu.io import exr as j_exr
from astcenc_tpu.io import image_io as j_image_io
from astcenc_tpu.io import ktx as j_ktx
from astcenc_tpu.utils import metrics as j_metrics

FUZZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "fuzz")


def _same(a, b, what=""):
    """Equal results: arrays bit for bit with one dtype, tuples item by
    item, everything else by ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), what
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def _outcome(fn, *args):
    """(the result, None) or (None, the exception's class name)."""
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001
        return None, type(e).__name__


def _both(tmp_path, name, write_j, write_t):
    """Write a file with each package; their bytes must be equal. Returns
    the two paths."""
    pj, pt = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
    write_j(pj)
    write_t(pt)
    assert open(pj, "rb").read() == open(pt, "rb").read(), name
    return pj, pt


def _read_both(read_j, read_t, path):
    got_j, err_j = _outcome(read_j, path)
    got_t, err_t = _outcome(read_t, path)
    assert err_j == err_t, (path, err_j, err_t)
    if err_j is None:
        _same(got_j, got_t, path)
    return got_t, err_t


# --- the cases of tests/test_io_containers.py ------------------------------

def test_ktx_compressed_roundtrip(tmp_path):
    blocks = np.arange(16 * 24, dtype=np.uint8).reshape(24, 16)
    pj, pt = _both(tmp_path, "t.ktx",
                   lambda p: j_ktx.write_ktx_compressed(
                       p, (6, 6, 1), (34, 23, 1), blocks),
                   lambda p: t_ktx.write_ktx_compressed(
                       p, (6, 6, 1), (34, 23, 1), blocks))
    kind, bd, idim, payload, srgb = _read_both(j_ktx.read_ktx,
                                               t_ktx.read_ktx, pt)[0]
    assert (kind, bd, idim, srgb) == ("astc", (6, 6, 1), (34, 23, 1), False)
    np.testing.assert_array_equal(payload, blocks)


def test_ktx_srgb_and_3d(tmp_path):
    z = np.zeros((64, 16), np.uint8)
    for name, bd, idim, srgb in (("t3.ktx", (3, 3, 3), (12, 12, 12), False),
                                 ("ts.ktx", (8, 8, 1), (64, 64, 1), True)):
        _, pt = _both(tmp_path, name,
                      lambda p: j_ktx.write_ktx_compressed(p, bd, idim, z,
                                                           srgb=srgb),
                      lambda p: t_ktx.write_ktx_compressed(p, bd, idim, z,
                                                           srgb=srgb))
        got = _read_both(j_ktx.read_ktx, t_ktx.read_ktx, pt)[0]
        assert got[1:3] == (bd, idim) and got[4] == srgb


def test_ktx_uncompressed_roundtrip(tmp_path):
    img = np.random.RandomState(0).randint(0, 255, (1, 8, 12, 4), np.uint8)
    _, pt = _both(tmp_path, "u.ktx",
                  lambda p: j_ktx.write_ktx_uncompressed(p, img),
                  lambda p: t_ktx.write_ktx_uncompressed(p, img))
    kind, _, _, data, _ = _read_both(j_ktx.read_ktx, t_ktx.read_ktx, pt)[0]
    assert kind == "raw"
    np.testing.assert_array_equal(data, img)


def test_dds_roundtrip(tmp_path):
    img = np.random.RandomState(1).randint(0, 255, (1, 6, 9, 4), np.uint8)
    _, pt = _both(tmp_path, "t.dds", lambda p: j_dds.write_dds(p, img),
                  lambda p: t_dds.write_dds(p, img))
    data, is_hdr = _read_both(j_dds.read_dds, t_dds.read_dds, pt)[0]
    assert not is_hdr
    np.testing.assert_array_equal(data, img)


def test_dds_f16(tmp_path):
    img = np.random.RandomState(2).rand(1, 4, 4, 4).astype(np.float16)
    _, pt = _both(tmp_path, "f.dds", lambda p: j_dds.write_dds(p, img),
                  lambda p: t_dds.write_dds(p, img))
    data, is_hdr = _read_both(j_dds.read_dds, t_dds.read_dds, pt)[0]
    assert is_hdr
    np.testing.assert_allclose(data, img.astype(np.float32), rtol=1e-3)


def test_ktx_bad_magic(tmp_path):
    p = str(tmp_path / "bad.ktx")
    open(p, "wb").write(b"not a ktx file at all")
    assert _read_both(j_ktx.read_ktx, t_ktx.read_ktx, p)[1] == "KtxError"


def test_exr_roundtrip(tmp_path):
    src = (np.random.RandomState(5).rand(17, 23, 4) * 8).astype(np.float32)
    _, pt = _both(tmp_path, "a.exr",
                  lambda p: j_exr.write_exr(p, src, ncomp=4),
                  lambda p: t_exr.write_exr(p, src, ncomp=4))
    back, ncomp = _read_both(j_exr.read_exr, t_exr.read_exr, pt)[0]
    assert ncomp == 4
    np.testing.assert_array_equal(
        back, src.astype(np.float16).astype(np.float32))


def test_exr_truncated(tmp_path):
    p = str(tmp_path / "bad.exr")
    open(p, "wb").write(b"\x76\x2f\x31\x01")
    assert _read_both(j_exr.read_exr, t_exr.read_exr, p)[1] is not None


def _rle_compress(data: bytes) -> bytes:
    """EXR RLE with its predictor (deinterleave, then delta): the inverse
    of the readers' post-pass, as tests/test_io_containers.py builds it."""
    arr = np.frombuffer(data, np.uint8)
    planar = np.concatenate([arr[0::2], arr[1::2]])
    d = np.concatenate([planar[:1],
                        (planar[1:].astype(np.int64)
                         - planar[:-1].astype(np.int64) + 128) % 256]
                       ).astype(np.uint8).tobytes()
    out = bytearray()
    i = 0
    while i < len(d):
        j = i
        while j + 1 < len(d) and d[j + 1] == d[i] and j - i < 126:
            j += 1
        if j > i:
            out.append(j - i)
            out.append(d[i])
            i = j + 1
        else:
            k = i
            while (k < len(d) and k - i < 127
                   and not (k + 1 < len(d) and d[k + 1] == d[k])):
                k += 1
            out.append(256 - (k - i))
            out += d[i:k]
            i = k
    return bytes(out)


def _zips_compress(data: bytes) -> bytes:
    """EXR ZIPS: the same predictor, then zlib."""
    arr = np.frombuffer(data, np.uint8)
    planar = np.concatenate([arr[0::2], arr[1::2]])
    d = np.concatenate([planar[:1],
                        (planar[1:].astype(np.int64)
                         - planar[:-1].astype(np.int64) + 128) % 256]
                       ).astype(np.uint8).tobytes()
    return zlib.compress(d)


def _recompress(path, out_path, comp_id, compress):
    """Rewrite an uncompressed one-line-per-block EXR with its scanlines
    recompressed (stored raw where that is not smaller)."""
    raw = bytearray(open(path, "rb").read())
    key = b"compression\x00compression\x00"
    raw[raw.index(key) + len(key) + 4] = comp_id
    off = 8
    while True:
        end = raw.index(b"\x00", off)
        name = bytes(raw[off:end])
        off = end + 1
        if not name:
            break
        off = raw.index(b"\x00", off) + 1
        (sz,) = struct.unpack("<I", bytes(raw[off:off + 4]))
        off += 4 + sz
    (_, _, _, y1) = struct.unpack(
        "<4i", bytes(raw[raw.index(b"dataWindow\x00box2i\x00") + 21:][:16]))
    H = y1 + 1
    offsets = struct.unpack(f"<{H}Q", bytes(raw[off:off + 8 * H]))
    out = bytearray(raw[:off + 8 * H])
    for i, bo in enumerate(offsets):
        y, size = struct.unpack("<ii", bytes(raw[bo:bo + 8]))
        payload = bytes(raw[bo + 8:bo + 8 + size])
        comp = compress(payload)
        if len(comp) >= len(payload):
            comp = payload
        struct.pack_into("<Q", out, off + 8 * i, len(out))
        out += struct.pack("<ii", y, len(comp)) + comp
    open(out_path, "wb").write(out)


@pytest.mark.parametrize("kind", ["rle", "zips"])
def test_exr_rle_roundtrip(tmp_path, kind):
    """RLE- (the case of tests/test_io_containers.py) and ZIPS-compressed
    EXR files, made by recompressing an uncompressed write, read alike by
    both packages and equal to the uncompressed read."""
    rng = np.random.RandomState(9)
    img = np.repeat(rng.rand(8, 4, 3).astype(np.float32), 4, axis=1)
    base = str(tmp_path / "plain.exr")
    t_exr.write_exr(base, img)
    packed = str(tmp_path / f"{kind}.exr")
    _recompress(base, packed, {"rle": 1, "zips": 2}[kind],
                {"rle": _rle_compress, "zips": _zips_compress}[kind])
    assert open(packed, "rb").read() != open(base, "rb").read()
    got, _ = _read_both(j_exr.read_exr, t_exr.read_exr, packed)
    np.testing.assert_array_equal(got[0], t_exr.read_exr(base)[0])


def _ktx_raw(gl_type, gl_fmt, w, h, payload, type_size=1):
    """Minimal uncompressed KTX v1 file (reference header layout,
    astcenccli_image_load_store.cpp:873-905)."""
    magic = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x31, 0x31, 0xBB,
                   0x0D, 0x0A, 0x1A, 0x0A])
    hdr = struct.pack("<13I", 0x04030201, gl_type, type_size, gl_fmt,
                      gl_fmt, gl_fmt, w, h, 0, 0, 1, 1, 0)
    return magic + hdr + struct.pack("<I", len(payload)) + payload


def test_ktx_uncompressed_luminance8(tmp_path):
    lum = np.arange(12, dtype=np.uint8).reshape(3, 4)
    p = str(tmp_path / "l8.ktx")
    open(p, "wb").write(_ktx_raw(0x1401, 0x1909, 4, 3, lum.tobytes()))
    kind, _, dims, data, _ = _read_both(j_ktx.read_ktx, t_ktx.read_ktx, p)[0]
    assert kind == "raw" and dims == (4, 3, 1) and data.dtype == np.uint8
    for c in range(3):
        np.testing.assert_array_equal(data[0, ..., c], lum)
    assert (data[0, ..., 3] == 255).all()


def test_ktx_uncompressed_bgra8_and_rg16(tmp_path):
    rng = np.random.RandomState(1)
    bgra = rng.randint(0, 255, (2, 5, 4), np.uint8)
    p = str(tmp_path / "bgra.ktx")
    open(p, "wb").write(_ktx_raw(0x1401, 0x80E1, 5, 2, bgra.tobytes()))
    data = _read_both(j_ktx.read_ktx, t_ktx.read_ktx, p)[0][3]
    np.testing.assert_array_equal(data[0, ..., 0], bgra[..., 2])
    np.testing.assert_array_equal(data[0, ..., 2], bgra[..., 0])
    rg = rng.randint(0, 65535, (2, 5, 2), np.uint16)
    p2 = str(tmp_path / "rg16.ktx")
    open(p2, "wb").write(_ktx_raw(0x1403, 0x8227, 5, 2, rg.tobytes(), 2))
    data2 = _read_both(j_ktx.read_ktx, t_ktx.read_ktx, p2)[0][3]
    assert data2.dtype == np.float16
    exp = (rg.astype(np.float32) / 65535.0).astype(np.float16)
    np.testing.assert_array_equal(data2[0, ..., 0], exp[..., 0])


def _dds_legacy(w, h, bitcount, masks, flags, payload):
    ddspf = struct.pack("<8I", 32, flags, 0, bitcount, *masks)
    header = struct.pack("<7I44s", 124, 1 | 2 | 4 | 0x1000, h, w,
                         w * bitcount // 8, 1, 1, b"\0" * 44) + ddspf \
        + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    return struct.pack("<I", 0x20534444) + header + payload


def test_dds_legacy_bgra8(tmp_path):
    bgra = np.random.RandomState(2).randint(0, 255, (3, 4, 4), np.uint8)
    p = str(tmp_path / "bgra.dds")
    open(p, "wb").write(_dds_legacy(4, 3, 32, (0xFF0000, 0xFF00, 0xFF,
                                               0xFF000000), 0x41,
                                    bgra.tobytes()))
    data, hdr = _read_both(j_dds.read_dds, t_dds.read_dds, p)[0]
    assert not hdr
    np.testing.assert_array_equal(data[0, ..., 0], bgra[..., 2])


def test_dds_legacy_l8_and_dx10_r16f(tmp_path):
    lum = np.arange(20, dtype=np.uint8).reshape(4, 5)
    p = str(tmp_path / "l8.dds")
    open(p, "wb").write(_dds_legacy(5, 4, 8, (0xFF, 0, 0, 0), 0x20000,
                                    lum.tobytes()))
    data, hdr = _read_both(j_dds.read_dds, t_dds.read_dds, p)[0]
    assert not hdr and (data[0, ..., 3] == 255).all()
    r16 = np.linspace(0, 4, 20, dtype=np.float16).reshape(4, 5)
    ddspf = struct.pack("<8I", 32, 4, 0x30315844, 0, 0, 0, 0, 0)
    header = struct.pack("<7I44s", 124, 1 | 2 | 4 | 0x1000, 4, 5,
                         10, 1, 1, b"\0" * 44) + ddspf \
        + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    p2 = str(tmp_path / "r16f.dds")
    open(p2, "wb").write(struct.pack("<I", 0x20534444) + header
                         + struct.pack("<5I", 54, 3, 0, 1, 0)
                         + r16.tobytes())
    data2, hdr2 = _read_both(j_dds.read_dds, t_dds.read_dds, p2)[0]
    assert hdr2
    np.testing.assert_array_equal(data2[0, ..., 0], r16.astype(np.float32))


# --- .astc files and the image loader ----------------------------------

def test_astc_file_roundtrip(tmp_path):
    blocks = np.random.RandomState(4).randint(0, 256, (2 * 3 * 4, 16),
                                              np.uint8)
    _, pt = _both(tmp_path, "x.astc",
                  lambda p: j_astc.write_astc(p, (5, 4, 3), (9, 11, 10),
                                              blocks),
                  lambda p: t_astc.write_astc(p, (5, 4, 3), (9, 11, 10),
                                              blocks))
    bd, idim, got = _read_both(j_astc.read_astc, t_astc.read_astc, pt)[0]
    assert (bd, idim) == ((5, 4, 3), (9, 11, 10))
    np.testing.assert_array_equal(got, blocks)


@pytest.mark.parametrize("ext", [".png", ".exr", ".hdr", ".ktx", ".dds"])
def test_image_io_roundtrip(tmp_path, ext):
    """save_image then load_image through both packages: the same bytes
    and arrays (uint8 for .png, float for .exr/.hdr; .ktx and .dds load
    what their writers wrote)."""
    rng = np.random.RandomState(13)
    if ext in (".exr", ".hdr"):
        img = (rng.rand(9, 7, 4) * 6).astype(np.float32)
    else:
        img = rng.randint(0, 256, (9, 7, 4), np.uint8)
    if ext == ".ktx":
        def write(mod):
            return lambda p: mod.write_ktx_uncompressed(p, img[None])
        pj, pt = _both(tmp_path, "i" + ext, write(j_ktx), write(t_ktx))
    elif ext == ".dds":
        def write(mod):
            return lambda p: mod.write_dds(p, img[None])
        pj, pt = _both(tmp_path, "i" + ext, write(j_dds), write(t_dds))
    else:
        pj, pt = _both(tmp_path, "i" + ext,
                       lambda p: j_image_io.save_image(p, img),
                       lambda p: t_image_io.save_image(p, img))
    data, is_hdr, ncomp = _read_both(j_image_io.load_image,
                                     t_image_io.load_image, pt)[0]
    assert data.shape[:2] == (9, 7)
    assert is_hdr == (ext in (".exr", ".hdr"))


# --- PIZ, piece by piece --------------------------------------------------

@pytest.mark.parametrize("shape,mx", [((8, 8), 100), ((13, 7), 9000),
                                      ((5, 32), 20000), ((32, 33), 65535)])
def test_exr_wavelet_decode(shape, mx):
    """The inverse 2D wavelet of PIZ (14- and 16-bit arms, odd sizes)."""
    a = np.random.RandomState(sum(shape)).randint(
        0, min(mx, 65535) + 1, shape).astype(np.uint16)
    aj, at = a.copy(), a.copy()
    j_exr._wav_decode_2d(aj, mx)
    t_exr._wav_decode_2d(at, mx)
    _same(aj, at)
    assert not np.array_equal(at, a)


def _huf_stream(rng, n_bytes):
    """A PIZ Huffman stream with a bounded symbol range: its 20-byte
    header (min and max symbol, table length, bit count, room) and seeded
    bytes."""
    im = int(rng.randint(0, 300))
    iM = im + int(rng.randint(1, 400))
    body = rng.randint(0, 256, n_bytes).astype(np.uint8).tobytes()
    nbits = int(rng.randint(0, 8 * n_bytes + 64))
    return struct.pack("<5I", im, iM, n_bytes, nbits, 0) + body


def test_exr_huffman_decode():
    """``_huf_decode`` on 40 seeded streams (short to long tables, streams
    that end early): the same symbols or the same error class."""
    rng = np.random.RandomState(21)
    ok = 0
    for i in range(40):
        data = _huf_stream(rng, int(rng.randint(4, 400)))
        nout = int(rng.randint(1, 600))
        gj, ej = _outcome(j_exr._huf_decode, data, nout)
        gt, et = _outcome(t_exr._huf_decode, data, nout)
        assert ej == et, (i, ej, et)
        if ej is None:
            _same(gj, gt, str(i))
            ok += 1
    assert ok >= 10


def test_exr_piz_decode():
    """``_piz_decode`` on 30 seeded PIZ blocks (bitmap range, Huffman
    stream; HALF and FLOAT channels): the same bytes or the same error
    class."""
    rng = np.random.RandomState(22)
    csizes = {1: 2, 2: 4, 0: 4}
    ok = 0
    for i in range(30):
        lo = int(rng.randint(0, 64))
        hi = lo + int(rng.randint(-1, 40))
        bitmap = (rng.randint(0, 256, max(hi - lo + 1, 0)).astype(np.uint8)
                  .tobytes())
        huf = _huf_stream(rng, int(rng.randint(8, 300)))
        payload = (struct.pack("<HH", lo, hi) + bitmap
                   + struct.pack("<i", len(huf)) + huf)
        channels = [("B", 1), ("G", 1), ("R", 1 + int(rng.randint(0, 2)))]
        w, ny = int(rng.randint(1, 9)), int(rng.randint(1, 6))
        gj, ej = _outcome(j_exr._piz_decode, payload, channels, w, ny,
                          csizes)
        gt, et = _outcome(t_exr._piz_decode, payload, channels, w, ny,
                          csizes)
        assert ej == et, (i, ej, et)
        if ej is None:
            assert gj == gt, i
            ok += 1
    assert ok >= 10


# --- the fuzz corpus ----------------------------------------------------

def _loader(mod_astc, mod_ktx, mod_dds, path):
    if path.endswith(".astc"):
        return mod_astc.read_astc
    if path.endswith(".ktx"):
        return mod_ktx.read_ktx
    return mod_dds.read_dds


@pytest.mark.parametrize("name", sorted(os.listdir(FUZZ)))
def test_fuzz_corpus_same_error(name):
    """Each malformed file of tests/data/fuzz: the same error class (or
    the same result) from both packages' readers."""
    path = os.path.join(FUZZ, name)
    _, err = _read_both(_loader(j_astc, j_ktx, j_dds, path),
                        _loader(t_astc, t_ktx, t_dds, path), path)
    print(f"{name}: {err}")


# --- the metrics --------------------------------------------------------

def _metric_images(kind):
    """Two seeded images of one kind: the reference and a perturbed copy,
    and the component count the CLI would report."""
    rng = np.random.RandomState({"ldr": 31, "hdr": 32, "normal": 33,
                                 "l": 34, "la": 35, "ldr3d": 36}[kind])
    if kind in ("hdr",):
        a = (rng.rand(12, 10, 4) * 20).astype(np.float32)
        a[..., 3] = 1.0
        b = (a * (1 + (rng.rand(*a.shape) - 0.5) * 0.1)).astype(np.float32)
        b[0, 0, :3] = 0.0
        return a, b, 3
    shape = (3, 6, 7, 4) if kind == "ldr3d" else (11, 9, 4)
    a = rng.randint(0, 256, shape).astype(np.uint8)
    if kind == "normal":
        v = rng.randn(11, 9, 3)
        v[..., 2] = np.abs(v[..., 2]) + 0.5
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        a[..., :3] = np.round((v * 0.5 + 0.5) * 255).astype(np.uint8)
        a[..., 3] = a[..., 1]
    if kind == "l":
        a[..., 1] = a[..., 2] = a[..., 0]
        a[..., 3] = 255
    if kind == "la":
        a[..., 1] = a[..., 2] = a[..., 0]
    b = np.clip(a.astype(np.int32) + rng.randint(-6, 7, shape), 0,
                255).astype(np.uint8)
    return a, b, {"ldr": 4, "ldr3d": 4, "normal": 4, "l": 1, "la": 2}[kind]


@pytest.mark.parametrize("kind", ["ldr", "hdr", "normal", "l", "la",
                                  "ldr3d"])
def test_metrics_equal_jax(kind):
    """Every metric of both packages on seeded LDR, HDR, normal-map, one-
    and two-channel and 3D images: equal to the last float64 digit, and
    ``format_error_metrics`` the same string."""
    a, b, ncomp = _metric_images(kind)
    hdr, normal = kind == "hdr", kind == "normal"
    for fn in ("psnr", "alpha_psnr", "luma_psnr", "normal_angular_psnr",
               "log_rmse", "mpsnr"):
        _same(getattr(j_metrics, fn)(a, b), getattr(t_metrics, fn)(a, b),
              fn)
    _same(j_metrics.psnr(a, b, channels=4), t_metrics.psnr(a, b, 4))
    _same(j_metrics.mpsnr(a, b, -4, 6), t_metrics.mpsnr(a, b, -4, 6))
    for lo, hi in ((-10, 10), (-3, 5)):
        mj = j_metrics.compute_error_metrics(a, b, ncomp, hdr=hdr,
                                             normal=normal, fstop_lo=lo,
                                             fstop_hi=hi)
        mt = t_metrics.compute_error_metrics(a, b, ncomp, hdr=hdr,
                                             normal=normal, fstop_lo=lo,
                                             fstop_hi=hi)
        assert sorted(mj) == sorted(mt)
        for k in mj:
            _same(mj[k], mt[k], k)
        sj = j_metrics.format_error_metrics(mj, ncomp, hdr, normal, lo, hi)
        assert sj == t_metrics.format_error_metrics(mt, ncomp, hdr, normal,
                                                    lo, hi)
    print(sj)


def test_metrics_identical_images():
    """999 dB where the images are equal, in both packages."""
    a, _, _ = _metric_images("ldr")
    mj = j_metrics.compute_error_metrics(a, a, 4)
    mt = t_metrics.compute_error_metrics(a, a, 4)
    assert mj == mt and mt["psnr"] == 999.0
    assert t_metrics.psnr(a, a) == j_metrics.psnr(a, a) == 999.0
