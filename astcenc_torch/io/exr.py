"""Minimal OpenEXR scanline I/O (no external dependencies).

Covers the subset the reference CLI exercises through tinyexr
(reference: Source/astcenccli_image_load_store.cpp:122-426): single-part
scanline images, HALF/FLOAT channels, NONE / RLE / ZIPS / ZIP / PIZ
compression (PIZ per the OpenEXR spec: bitmap LUT + Huffman + 2D Haar-ish
integer wavelet). Writer emits uncompressed HALF scanlines.

The port's own copy of ``astcenc_tpu/io/exr.py`` (NumPy only), so that
the port loads nothing of the JAX package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76

_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ = 0, 1, 2, 3, 4


class ExrError(ValueError):
    pass


def _read_nullstr(buf, off):
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin1"), end + 1


def _unpredict_and_interleave(data: bytes) -> bytes:
    """Invert the EXR ZIP predictor: delta-decode then re-interleave.

    Encode-side: split bytes into two halves (even/odd positions), then
    delta-encode (d[i] = t[i] - t[i-1] + 128). Decode runs the inverse:
    t[0] = d[0], t[i] = t[i-1] + d[i] - 128 (mod 256), then interleave.
    """
    deltas = np.frombuffer(data, np.uint8).astype(np.int64)
    t = np.cumsum(np.concatenate([deltas[:1], deltas[1:] - 128]))
    out = (t % 256).astype(np.uint8)
    n = len(out)
    half = (n + 1) // 2
    inter = np.zeros(n, np.uint8)
    inter[0::2] = out[:half]
    inter[1::2] = out[half:]
    return inter.tobytes()


def _rle_decode(data: bytes) -> bytes:
    """OpenEXR RLE: signed count byte; <0 = -n literals, >=0 = n+1 copies
    of the next byte. The output then goes through the same
    predictor/deinterleave as ZIP."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        c = data[i]
        i += 1
        if c > 127:                      # negative int8: literal run
            run = 256 - c
            out += data[i:i + run]
            i += run
        else:                            # repeat run
            out += data[i:i + 1] * (c + 1)
            i += 1
    return bytes(out)


# --------------------------- PIZ decompression ----------------------------
# Per the OpenEXR file-format specification: a 16-bit bitmap-compacted LUT,
# a canonical Huffman coder with 6-bit code lengths (zero-run escapes 59/63
# and an RLE symbol = iM repeating the previous value), and a 2D integer
# wavelet (14-bit lossless path and a mod-2^16 16-bit path).

_HUF_SHORT_ZERORUN = 59
_HUF_LONG_ZERORUN = 63


class _BitReader:
    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def get(self, n):
        while self.nbits < n:
            self.acc = (self.acc << 8) | (self.data[self.pos]
                                          if self.pos < len(self.data) else 0)
            self.pos += 1
            self.nbits += 8
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        return v


def _huf_decode(data: bytes, nout: int) -> np.ndarray:
    im, iM, _tlen, nbits, _room = struct.unpack("<5I", data[:20])
    br = _BitReader(data[20:])

    # Unpack 6-bit code lengths with zero-run escapes
    lengths = np.zeros(iM + 1, np.int64)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == _HUF_LONG_ZERORUN:
            run = br.get(8) + 6
            i += run
        elif l >= _HUF_SHORT_ZERORUN:
            i += l - _HUF_SHORT_ZERORUN + 2
        else:
            lengths[i] = l
            i += 1

    # Canonical code assignment (counts per length, top-down halving)
    n = np.zeros(59, np.int64)
    for l in lengths:
        if l > 0:
            n[l] += 1
    c = 0
    first = np.zeros(59, np.int64)
    for l in range(58, 0, -1):
        nc = (c + n[l]) >> 1
        first[l] = c
        c = nc
    codes = {}
    nxt = first.copy()
    for sym in range(im, iM + 1):
        l = int(lengths[sym])
        if l > 0:
            codes[(l, int(nxt[l]))] = sym
            nxt[l] += 1

    # The bitstream starts at the NEXT BYTE boundary after the code
    # table — the table reader's partially-consumed byte is discarded.
    bits = np.unpackbits(np.frombuffer(br.data, np.uint8)[br.pos:])[:nbits]

    out = np.zeros(nout, np.uint16)
    oi = 0
    bi = 0
    nb = len(bits)
    code = 0
    clen = 0
    blist = bits.tolist()
    get = codes.get
    while oi < nout and bi < nb:
        code = (code << 1) | blist[bi]
        bi += 1
        clen += 1
        sym = get((clen, code))
        if sym is None:
            continue
        code = 0
        clen = 0
        if sym == iM:                     # run-length escape: repeat prev
            run = 0
            for _ in range(8):
                run = (run << 1) | (blist[bi] if bi < nb else 0)
                bi += 1
            prev = out[oi - 1] if oi else 0
            out[oi:oi + run] = prev
            oi += run
        else:
            out[oi] = sym
            oi += 1
    return out


def _wav_decode_2d(a: np.ndarray, mx: int) -> None:
    """In-place inverse 2D integer wavelet on (ny, nx) uint16."""
    ny, nx = a.shape
    w14 = mx < (1 << 14)
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1

    def wdec14(l, h):
        ls = l.astype(np.int16).astype(np.int64)
        hs = h.astype(np.int16).astype(np.int64)
        ai = ls + (hs & 1) + (hs >> 1)
        b = (ai - hs).astype(np.int16).astype(np.uint16)
        return ai.astype(np.int16).astype(np.uint16), b

    def wdec16(l, h):
        m = l.astype(np.int64)
        d = h.astype(np.int64)
        bb = (m - (d >> 1)) & 0xFFFF
        aa = (d + bb - 0x8000) & 0xFFFF
        return aa.astype(np.uint16), bb.astype(np.uint16)

    wdec = wdec14 if w14 else wdec16

    while p >= 1:
        # 2x2 block grid at stride p2, offsets p
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            a00 = a[np.ix_(ys, xs)]
            a01 = a[np.ix_(ys, xs + p)]
            a10 = a[np.ix_(ys + p, xs)]
            a11 = a[np.ix_(ys + p, xs + p)]
            i00, i10 = wdec(a00, a10)
            i01, i11 = wdec(a01, a11)
            o00, o01 = wdec(i00, i01)
            o10, o11 = wdec(i10, i11)
            a[np.ix_(ys, xs)] = o00
            a[np.ix_(ys, xs + p)] = o01
            a[np.ix_(ys + p, xs)] = o10
            a[np.ix_(ys + p, xs + p)] = o11
            # trailing column (nx has a leftover at this level)
            if nx & p:
                x = xs[-1] + p2
                if x + 0 < nx:
                    c0, c1 = wdec(a[np.ix_(ys, [x])], a[np.ix_(ys + p, [x])])
                    a[np.ix_(ys, [x])] = c0
                    a[np.ix_(ys + p, [x])] = c1
        if ny & p:
            y = (ys[-1] + p2) if len(ys) else 0
            if y < ny and len(xs):
                r0, r1 = wdec(a[np.ix_([y], xs)], a[np.ix_([y], xs + p)])
                a[np.ix_([y], xs)] = r0
                a[np.ix_([y], xs + p)] = r1
        p2 = p
        p >>= 1


def _piz_decode(payload: bytes, channels, w: int, ny: int,
                csizes) -> bytes:
    """Decode one PIZ block to the NONE-layout byte stream (per scanline,
    per channel rows)."""
    pos = 0
    minnz, maxnz = struct.unpack("<HH", payload[pos:pos + 4])
    pos += 4
    bitmap = np.zeros(8192, np.uint8)
    if minnz <= maxnz:
        nbm = maxnz - minnz + 1
        bitmap[minnz:maxnz + 1] = np.frombuffer(
            payload[pos:pos + nbm], np.uint8)
        pos += nbm
    bits = np.unpackbits(bitmap[:, None], axis=1,
                         bitorder="little").reshape(-1)
    bits[0] = 1            # zero is always present (never stored in bitmap)
    present = np.nonzero(bits)[0]
    rlut = present.astype(np.uint16)          # k -> value
    if len(rlut) == 0:
        rlut = np.zeros(1, np.uint16)
    maxval = len(present) - 1 if len(present) else 0

    (hlen,) = struct.unpack("<i", payload[pos:pos + 4])
    pos += 4
    nshorts = sum(w * (csizes[pt] // 2) * ny for _, pt in channels)
    data = _huf_decode(payload[pos:pos + hlen], nshorts)

    # Per-channel inverse wavelet
    off = 0
    planes = []
    for _, pt in channels:
        sz = csizes[pt] // 2                  # u16 units per sample
        cnx = w * sz
        chan = data[off:off + cnx * ny].reshape(ny, cnx).copy()
        off += cnx * ny
        _wav_decode_2d(chan, maxval)
        planes.append(chan)

    # Apply reverse LUT
    planes = [rlut[np.minimum(p_, len(rlut) - 1)] for p_ in planes]

    # Reassemble NONE layout: per scanline, per channel row bytes
    out = bytearray()
    for y in range(ny):
        for ci in range(len(channels)):
            out += planes[ci][y].tobytes()
    return bytes(out)


def read_exr(path):
    """Read a single-part scanline EXR. Returns (H, W, 4) float32 RGBA."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8 or struct.unpack("<I", raw[:4])[0] != _MAGIC:
        raise ExrError("not an EXR file")
    version = struct.unpack("<I", raw[4:8])[0]
    if version & 0x200:
        raise ExrError("multi-part EXR not supported")
    if version & 0x800:
        raise ExrError("deep EXR not supported")

    off = 8
    channels = []
    compression = _COMP_NONE
    dw = None
    while True:
        name, off = _read_nullstr(raw, off)
        if not name:
            break
        atype, off = _read_nullstr(raw, off)
        (size,) = struct.unpack("<I", raw[off:off + 4])
        off += 4
        data = raw[off:off + size]
        off += size
        if name == "channels":
            coff = 0
            while data[coff] != 0:
                cname_end = data.index(b"\0", coff)
                cname = data[coff:cname_end].decode("latin1")
                coff = cname_end + 1
                ptype, _plin = struct.unpack("<iB", data[coff:coff + 5])
                coff += 16
                channels.append((cname, ptype))
        elif name == "compression":
            compression = data[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", data)
    if dw is None or not channels:
        raise ExrError("missing required EXR attributes")
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1
    if compression not in (_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP,
                           _COMP_PIZ):
        raise ExrError(f"unsupported EXR compression {compression}")
    lines_per_block = {_COMP_ZIP: 16, _COMP_PIZ: 32}.get(compression, 1)
    nblocks = (h + lines_per_block - 1) // lines_per_block

    # channels are stored sorted by name; each scanline holds each channel's
    # full row consecutively
    offsets = struct.unpack(f"<{nblocks}Q", raw[off:off + 8 * nblocks])

    dtypes = {_PT_HALF: np.float16, _PT_FLOAT: np.float32,
              _PT_UINT: np.uint32}
    csizes = {_PT_HALF: 2, _PT_FLOAT: 4, _PT_UINT: 4}
    planes = {c: np.zeros((h, w), np.float32) for c, _ in channels}

    for bofs in offsets:
        y, size = struct.unpack("<ii", raw[bofs:bofs + 8])
        payload = raw[bofs + 8:bofs + 8 + size]
        ny = min(lines_per_block, dw[3] - y + 1)
        rowbytes = sum(w * csizes[pt] for _, pt in channels)
        if compression in (_COMP_ZIPS, _COMP_ZIP):
            if size < ny * rowbytes:
                payload = _unpredict_and_interleave(zlib.decompress(payload))
        elif compression == _COMP_RLE:
            if size < ny * rowbytes:
                payload = _unpredict_and_interleave(_rle_decode(payload))
        elif compression == _COMP_PIZ:
            payload = _piz_decode(payload, channels, w, ny, csizes)
        arr = np.frombuffer(payload, np.uint8)
        pos = 0
        for line in range(ny):
            yy = y - dw[1] + line
            for cname, ptype in channels:
                nb = w * csizes[ptype]
                row = arr[pos:pos + nb].view(dtypes[ptype])
                planes[cname][yy] = row.astype(np.float32)
                pos += nb

    out = np.zeros((h, w, 4), np.float32)
    out[..., 3] = 1.0
    for i, c in enumerate("RGBA"):
        if c in planes:
            out[..., i] = planes[c]
    if "Y" in planes and "R" not in planes:   # luminance-only
        for i in range(3):
            out[..., i] = planes["Y"]
    ncomp = sum(1 for c in "RGBA" if c in planes) or 1
    return out, ncomp


def _attr(name, atype, data):
    return (name.encode() + b"\0" + atype.encode() + b"\0"
            + struct.pack("<I", len(data)) + data)


def write_exr(path, rgb: np.ndarray, ncomp: int = 3):
    """Write an uncompressed HALF scanline EXR from (H, W, >=3) float data."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    names = ["B", "G", "R"] if ncomp <= 3 else ["A", "B", "G", "R"]
    src = {"R": rgb[..., 0], "G": rgb[..., 1], "B": rgb[..., 2]}
    if ncomp > 3:
        src["A"] = (rgb[..., 3] if rgb.shape[2] > 3
                    else np.ones((h, w), np.float32))

    chl = b""
    for n in names:                     # alphabetical order
        chl += n.encode() + b"\0" + struct.pack("<iBBBBii", _PT_HALF,
                                                0, 0, 0, 0, 1, 1)
    chl += b"\0"

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    hdr = b"".join([
        _attr("channels", "chlist", chl),
        _attr("compression", "compression", bytes([_COMP_NONE])),
        _attr("dataWindow", "box2i", box),
        _attr("displayWindow", "box2i", box),
        _attr("lineOrder", "lineOrder", b"\0"),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\0",
    ])
    head = struct.pack("<II", _MAGIC, 2) + hdr
    table_off = len(head)
    data_off = table_off + 8 * h
    rowbytes = len(names) * w * 2

    # The scanlines are joined once (appending to one bytes object per line
    # costs time quadratic in the image's height).
    offsets = []
    lines = []
    pos = data_off
    for y in range(h):
        offsets.append(pos)
        row = b"".join(src[n][y].astype(np.float16).tobytes() for n in names)
        lines.append(struct.pack("<ii", y, rowbytes) + row)
        pos += len(lines[-1])
    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack(f"<{h}Q", *offsets))
        f.write(b"".join(lines))
