"""The wrappers of the colour pack kernel, of kernel K8 and of the colour
decode kernel on the CPU.

CPU tensors take the plain version and another device raises. The CUDA
path runs here with ``torch.Tensor.is_cuda`` patched to True and the ctypes
launch replaced by a numpy stand-in that reads the raw input buffers at the
addresses the wrapper passes, computes the plain version and writes the
raw output buffers: so the argument order, the flattening and dtype of
every buffer, the output shapes and the launch counts are held, everything
but the kernel itself (``tests/test_torch_cuda.py`` holds that on a card).
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from astcenc_torch import obs, testdata
from astcenc_torch.ops import _build
from astcenc_torch.ops import color_pack as cp
from astcenc_torch.ops import color_pack_hdr as cph
from astcenc_torch.ops import color_unquant as cuq
from astcenc_torch.ops import gather

_CTYPES = {np.float32: ctypes.c_float, np.int32: ctypes.c_int32,
           np.int64: ctypes.c_int64, np.bool_: ctypes.c_bool}


def _buf(addr, dtype, shape):
    """The numpy view of a tensor's memory at a raw address."""
    n = int(np.prod(shape))
    return np.ctypeslib.as_array(
        (_CTYPES[dtype] * n).from_address(addr)).reshape(shape)


class _PackLaunch:
    """Stands in for astc_color_pack: the plain pack on the raw buffers."""

    def __init__(self):
        self.calls = []

    def __call__(self, ep0, ep1, rgbs, rgbo, req, ql, lohi, B, profile, fmt,
                 vals, stream):
        f32 = [torch.from_numpy(_buf(p, np.float32, (B, 4)).copy())
               for p in (ep0, ep1, rgbs)]
        o = (None if rgbo is None
             else torch.from_numpy(_buf(rgbo, np.float32, (B, 4)).copy()))
        r, q = (torch.from_numpy(_buf(p, np.int32, (B,)).copy())
                for p in (req, ql))
        assert np.array_equal(_buf(lohi, np.int32, (2, 17, 256)),
                              np.stack(gather.quant_tables_np()))
        wf, wv = cph.pack_color_endpoints_plain(profile, *f32, o, r, q)
        _buf(fmt, np.int32, (B,))[:] = wf.numpy()
        _buf(vals, np.int32, (B, 8))[:] = wv.numpy()
        self.calls.append({"B": B, "profile": profile, "rgbo": o is not None,
                           "stream": stream})
        return 0


class _RowLaunch:
    """Stands in for astc_row_gather: a numpy gather on the raw buffers."""

    def __init__(self):
        self.calls = []

    def __call__(self, rows, idx, idx64, B, V, K, C, out, stream):
        r = _buf(rows, np.int32, (B, V, C))
        i = _buf(idx, np.int64 if idx64 else np.int32, (B, K))
        i = np.clip(i, 0, V - 1)
        _buf(out, np.int32, (B, K, C))[:] = r[np.arange(B)[:, None], i]
        self.calls.append({"B": B, "V": V, "K": K, "C": C,
                           "idx64": bool(idx64), "stream": stream})
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors that say they are CUDA tensors, and both launches
    replaced by their numpy stand-ins."""
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))
    monkeypatch.setattr(_build, "stream", lambda device_index: 77)
    pack, rows = _PackLaunch(), _RowLaunch()
    monkeypatch.setattr(cp, "_pack_fn", pack)
    monkeypatch.setattr(gather, "_row_fn", rows)
    return pack, rows


@pytest.fixture
def launched():
    """``launched(kernel)``: the launches of ``kernel`` that the program's
    launch counters (``obs``) counted since the last call."""
    obs.collect()
    obs.enable()
    yield lambda kernel: obs.collect().counters.get("launch." + kernel, 0)
    obs.disable()
    obs.collect()


def _batch(seed, n=512):
    return [torch.from_numpy(a) for a in testdata.pack_batch(seed, n)]


@pytest.mark.parametrize("profile", [0, 2, 3])
def test_pack_cpu_tensors_take_plain(launched, profile):
    b = _batch(profile)
    got = cph.pack_color_endpoints(profile, *b)
    want = cph.pack_color_endpoints_plain(profile, *b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = cp.pack_color_endpoints_ldr(b[0], b[1], b[2], b[4], b[5])
    want = cp.pack_color_endpoints_ldr_plain(b[0], b[1], b[2], b[4], b[5])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launched("color_pack") == 0


def test_pack_other_device_raises():
    b = [torch.empty(t.shape, dtype=t.dtype, device="meta")
         for t in _batch(0, 8)]
    with pytest.raises(ValueError, match="unsupported device"):
        cph.pack_color_endpoints(2, *b)
    with pytest.raises(ValueError, match="unsupported device"):
        cp.pack_color_endpoints_ldr(b[0], b[1], b[2], b[4], b[5])


@pytest.mark.parametrize("profile", [0, 2, 3])
def test_pack_kernel_wrapper(fake_card, launched, profile):
    """One launch per pack call, its buffers flat float32 and int32 even
    from strided float64 and int64 inputs, its outputs the plain pack's."""
    pack, _ = fake_card
    b = list(testdata.pack_batch(20 + profile, 600))
    want = cph.pack_color_endpoints_plain(profile,
                                          *map(torch.from_numpy, b))
    ep0 = torch.from_numpy(np.ascontiguousarray(b[0].T)).T    # strided
    rgbs = torch.from_numpy(b[2].astype(np.float64))
    ql = torch.from_numpy(b[5].astype(np.int64))
    args = [ep0, torch.from_numpy(b[1]), rgbs, torch.from_numpy(b[3]),
            torch.from_numpy(b[4]), ql]
    got = cph.pack_color_endpoints(profile, *args)
    assert launched("color_pack") == 1
    assert pack.calls == [{"B": b[0].shape[0], "profile": profile,
                           "rgbo": profile >= 2, "stream": 77}]
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    # The all-plain scope stays plain.
    with _build.plain():
        got = cph.pack_color_endpoints(profile, *args)
    assert launched("color_pack") == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pack_ldr_kernel_wrapper(fake_card, launched):
    """The LDR pack of the plain refinement: one launch, no rgbo buffer."""
    pack, _ = fake_card
    b = [torch.from_numpy(a) for a in testdata.pack_batch(5, 600)]
    want = cp.pack_color_endpoints_ldr_plain(b[0], b[1], b[2], b[4], b[5])
    got = cp.pack_color_endpoints_ldr(b[0], b[1], b[2], b[4], b[5])
    assert launched("color_pack") == 1
    assert pack.calls == [{"B": b[0].shape[0], "profile": 1, "rgbo": False,
                           "stream": 77}]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _rows_case(dtype, C, itype, batch=(3, 5), V=40, K=17, seed=0):
    rng = np.random.default_rng(seed)
    shape = batch + (V,) + ((C,) if C else ())
    if dtype == "int32":
        rows = rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)
    else:
        rows = (rng.standard_normal(shape) * 1e3).astype(np.float32)
        flat = rows.reshape(-1).view(np.uint32)
        flat[rng.choice(flat.size, 40, replace=False)] = np.tile(np.array(
            [0x7FC00000, 0xFFC12345, 0x7F800001, 0x7F800000, 0xFF800000,
             0x80000000, 0x00000001, 0x807FFFFF], np.uint32), 5)
    idx = rng.integers(-10, V + 10, batch + (K,)).astype(itype)
    return torch.from_numpy(rows), torch.from_numpy(idx)


@pytest.mark.parametrize("dtype,C,itype", [
    ("int32", None, "int32"), ("int32", 2, "int64"),
    ("float32", None, "int64"), ("float32", 2, "int32"),
    ("float32", 3, "int64")])
def test_row_lookup_kernel_wrapper(fake_card, launched, dtype, C, itype):
    """K8's wrapper: int32 or int64 indices passed as they are (no
    conversion), the batch dimensions flattened to B, the output in its
    final shape and dtype, bit for bit the plain version's."""
    _, launch = fake_card
    rows, idx = _rows_case(dtype, C, itype)
    got = gather.row_lookup(rows, idx)
    assert launched("row_gather") == 1
    assert launch.calls == [{"B": 15, "V": 40, "K": 17, "C": C or 1,
                             "idx64": itype == "int64", "stream": 77}]
    want = gather.row_lookup_plain(rows, idx)
    assert got.dtype == rows.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", ["float16 rows", "int16 idx", "strided rows",
                                  "batch mismatch", "rows without entries"])
def test_row_lookup_kernel_wrapper_refuses(fake_card, case):
    """What the kernel does not take raises, and nothing launches."""
    _, launch = fake_card
    rows, idx = _rows_case("float32", 2, "int32")
    err = ValueError
    if case == "float16 rows":
        rows, err = rows.to(torch.float16), TypeError
    elif case == "int16 idx":
        idx, err = idx.to(torch.int16), TypeError
    elif case == "strided rows":       # same shape, not contiguous
        rows = rows.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "batch mismatch":
        idx = idx[:, :4]
    else:                              # (3, 5) rows for (3, 5, 17) indices
        rows = rows[..., 0, 0].contiguous()
    with pytest.raises(err):
        gather.row_lookup_cuda(rows, idx)
    assert launch.calls == []


class _UnpackLaunch:
    """Stands in for astc_color_unpack: the plain decode on the raw
    buffers."""

    def __init__(self):
        self.calls = []

    def __call__(self, fmt, vals, B, profile, ep0, ep1, rgb_hdr, alpha_hdr,
                 stream):
        f = torch.from_numpy(_buf(fmt, np.int32, (B,)).copy())
        v = torch.from_numpy(_buf(vals, np.int32, (B, 8)).copy())
        for out, w, shape in zip((ep0, ep1, rgb_hdr, alpha_hdr),
                                 cuq.unpack_color_endpoints_plain(profile, f,
                                                                  v),
                                 ((B, 4), (B, 4), (B,), (B,))):
            _buf(out, w.numpy().dtype.type, shape)[:] = w.numpy()
        self.calls.append({"B": B, "profile": profile, "stream": stream})
        return 0


@pytest.fixture
def fake_unpack(fake_card, monkeypatch):
    """fake_card, and the colour decode's launch replaced by its numpy
    stand-in."""
    launch = _UnpackLaunch()
    monkeypatch.setattr(cuq, "_unpack_fn", launch)
    return launch


def _unpack_case(seed, n=500, pc=4):
    fmt, vals = testdata.unpack_batch(seed, n * pc)
    return (torch.from_numpy(fmt).reshape(n, pc),
            torch.from_numpy(vals).reshape(n, pc, 8))


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("profile", [0, 1, 2, 3])
def test_unpack_cpu_tensors_take_plain(monkeypatch, launched, profile,
                                       plain):
    """CPU tensors take the plain decode, inside the all-plain scope or
    not: no launch, the plain version's outputs."""
    def refuse(*args):
        raise AssertionError("the kernel's wrapper was called")
    monkeypatch.setattr(cuq, "unpack_cuda", refuse)
    fmt, vals = _unpack_case(profile)
    with _build.plain() if plain else contextlib.nullcontext():
        got = cuq.unpack_color_endpoints(profile, fmt, vals)
    want = cuq.unpack_color_endpoints_plain(profile, fmt, vals)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launched("color_unpack") == 0


def test_unpack_other_device_raises():
    fmt = torch.zeros((8, 2), dtype=torch.int32, device="meta")
    vals = torch.zeros((8, 2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuq.unpack_color_endpoints(2, fmt, vals)


@pytest.mark.parametrize("profile", [0, 1, 2, 3])
def test_unpack_kernel_wrapper(fake_unpack, launched, profile):
    """One launch per decode call, the (N, pc) batch flattened to B and
    restored, int32 buffers even from strided int64 values, the outputs
    the plain decode's in shape, dtype and value; none inside the
    all-plain scope."""
    fmt, vals = _unpack_case(30 + profile)
    want = cuq.unpack_color_endpoints_plain(profile, fmt, vals)
    strided = vals.to(torch.int64).transpose(0, 1).contiguous().transpose(
        0, 1)
    got = cuq.unpack_color_endpoints(profile, fmt, strided)
    assert launched("color_unpack") == 1
    assert fake_unpack.calls == [{"B": fmt.numel(), "profile": profile,
                                  "stream": 77}]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    with _build.plain():
        got = cuq.unpack_color_endpoints(profile, fmt, vals)
    assert launched("color_unpack") == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["int64 fmt", "strided vals",
                                  "batch mismatch", "values per pair"])
def test_unpack_kernel_wrapper_refuses(fake_unpack, case):
    """What the kernel does not take raises, and nothing launches."""
    fmt, vals = (t.reshape(-1, *t.shape[2:]) for t in _unpack_case(1))
    err = ValueError
    if case == "int64 fmt":
        fmt, err = fmt.to(torch.int64), TypeError
    elif case == "strided vals":       # same shape, not contiguous
        vals = vals.T.contiguous().T
    elif case == "batch mismatch":
        vals = vals[:-1]
    else:
        vals = vals[:, :6].contiguous()
    with pytest.raises(err):
        cuq.unpack_cuda(2, fmt, vals)
    assert fake_unpack.calls == []
