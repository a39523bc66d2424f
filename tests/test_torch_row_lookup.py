"""The per-row table gather of astcenc_torch (``gather.row_lookup``, the
plain version of kernel K8) and the kernel switch (``_build``), against the
JAX package on the CPU; and the encoder with the ``refine`` family switched
off.

The plain gather is held bit for bit against JAX ``row_lookup`` run through
its Pallas kernel in interpret mode, float32 NaN payloads, +-Inf, -0.0 and
denormals included. ``lut.lookup_rows`` (the JAX package's CPU fallback)
is an oracle only on finite tables: its one-hot contraction turns every
lookup of a row that holds a NaN into NaN. Inputs are seeded with numpy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astcenc_tpu.ops import gather_pallas as jgather
from astcenc_tpu.ops import lut as jlut
from astcenc_torch import api, testdata
from astcenc_torch.codec import compress as tc
from astcenc_torch.ops import _build, gather, msearch, refine

torch.set_num_threads(1)

# NaN payloads (quiet and signalling, both signs), +-Inf, -0.0, denormals.
_SPECIAL_BITS = np.array([0x7FC00000, 0xFFC12345, 0x7F800001, 0x7FBFFFFF,
                          0x7F800000, 0xFF800000, 0x80000000, 0x00000001,
                          0x807FFFFF, 0x00400000], np.uint32)


def _table(rng, shape, dtype: str, specials: bool = True):
    if dtype == "int32":
        return rng.randint(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
            np.int32)
    t = (rng.standard_normal(shape) * 1e3).astype(np.float32)
    if specials:
        flat = t.reshape(-1).view(np.uint32)
        pos = rng.choice(flat.size, 4 * len(_SPECIAL_BITS), replace=False)
        flat[pos] = np.tile(_SPECIAL_BITS, 4)
    return t


def _inputs(seed, dtype, C, V, K, batch, specials=True):
    rng = np.random.RandomState(seed)
    rows = _table(rng, batch + (V,) + ((C,) if C else ()), dtype, specials)
    idx = rng.randint(-20, V + 20, batch + (K,)).astype(np.int32)
    return rows, idx


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


CASES = [
    # dtype, C (None: no channel axis), V, K, leading batch dims
    ("int32", None, 65, 36, (64,)),
    ("float32", None, 300, 200, (16,)),
    ("int32", 2, 65, 36, (4, 24)),
    ("float32", 2, 65, 200, (2, 3, 5)),
    ("float32", None, 65, 36, (3, 7)),
    ("int32", 3, 300, 200, (10,)),
    ("float32", 2, 300, 36, (9,)),
]


@pytest.mark.parametrize("dtype,C,V,K,batch", CASES)
def test_row_lookup_plain_matches_jax_kernel(monkeypatch, dtype, C, V, K,
                                            batch):
    """row_lookup_plain against JAX row_lookup through the Pallas kernel in
    interpret mode, bit for bit; indices outside [0, V) included."""
    monkeypatch.setenv("ASTC_PALLAS_INTERPRET", "1")
    rows, idx = _inputs(len(batch) * 1000 + V + K, dtype, C, V, K, batch)
    want = np.asarray(jgather.row_lookup(jnp.asarray(rows), jnp.asarray(idx)))
    got = gather.row_lookup_plain(torch.from_numpy(rows),
                                  torch.from_numpy(idx)).numpy()
    assert got.dtype == rows.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # The router takes the plain version for CPU tensors.
    np.testing.assert_array_equal(_bits(gather.row_lookup(
        torch.from_numpy(rows), torch.from_numpy(idx)).numpy()), _bits(want))


@pytest.mark.parametrize("dtype,C", [("int32", None), ("float32", 2)])
def test_row_lookup_plain_matches_lut_on_finite_tables(dtype, C):
    """The JAX package's CPU fallback, lut.lookup_rows, on finite tables
    (integers below 2**24, which its float32 contraction holds exactly)."""
    rng = np.random.RandomState(7)
    rows = (rng.randint(-2 ** 24, 2 ** 24, (50, 300) + ((C,) if C else ()))
            .astype(np.int32) if dtype == "int32"
            else _table(rng, (50, 300, C), dtype, specials=False))
    idx = rng.randint(-5, 305, (50, 200)).astype(np.int32)
    want = np.asarray(jlut.lookup_rows(jnp.asarray(rows), jnp.asarray(idx)))
    got = gather.row_lookup_plain(torch.from_numpy(rows),
                                  torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64),
                                  want.astype(np.float64))


@pytest.mark.parametrize("value", [None, "", "refine", "msearch,refine",
                                   " refine , msearch ", "REFINE", ",,",
                                   "refine,", "psearch,gather", "foo,refine"])
def test_kernel_switch_parses_as_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("ASTC_DISABLE_KERNELS", raising=False)
    else:
        monkeypatch.setenv("ASTC_DISABLE_KERNELS", value)
    for name in ("msearch", "refine", "psearch", "gather", "foo", "REFINE"):
        assert ((name not in _build.disabled_kernels())
                == jgather._kernel_enabled(name)), (value, name)
        # The switch honours msearch and refine only.
        assert _build.kernel_on(name) == (
            name not in _build.SWITCHED or jgather._kernel_enabled(name)), \
            (value, name)


class _Calls:
    """Counts calls of module functions, and what the kernel switch
    answered for the families ``msearch`` and ``refine`` at each."""

    def __init__(self, monkeypatch, targets):
        self.n = {}
        self.flags = {}
        for mod, name in targets:
            orig = getattr(mod, name)
            monkeypatch.setattr(mod, name, self._wrap(name, orig))

    def _wrap(self, name, orig):
        def f(*a, **kw):
            self.n[name] = self.n.get(name, 0) + 1
            self.flags.setdefault(name, set()).add(
                (_build.kernel_on("msearch"), _build.kernel_on("refine")))
            return orig(*a, **kw)
        return f


_LDR_TARGETS = [(gather, "row_lookup"), (msearch, "mode_search"),
                (refine, "trial1_refine"), (refine, "trial2_refine"),
                (refine, "_rounds_1plane"), (refine, "_rounds_2plane"),
                (refine, "refine_round_1plane_plain"),
                (refine, "refine_round_2plane_plain"),
                (refine, "trial1_refine_cuda"), (refine, "trial2_refine_cuda")]


def _encode_ldr(monkeypatch, value):
    monkeypatch.setenv("ASTC_DISABLE_KERNELS", value)
    calls = _Calls(monkeypatch, _LDR_TARGETS)
    ctx = api.context_alloc(api.config_init(
        api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0), device="cpu")
    img = testdata.synthetic_image(48, 48, 5, independent_alpha=True)
    return tc.compress_image(ctx, img), calls


@pytest.mark.parametrize("value", ["refine", "msearch,refine"])
def test_refine_off_encode_matches_default(monkeypatch, value):
    """A 48x48 6x6 -medium encode with the refinement kernels switched off:
    inside the encode the switch answers False for ``refine`` (and for
    ``msearch`` where it is named; True by default), each trial goes
    through its router to the rounds driver and the plain rounds, whose
    realign lookups go through gather.row_lookup, and the blocks are the
    default path's."""
    with monkeypatch.context() as m:
        want, on = _encode_ldr(m, "")
    got, off = _encode_ldr(monkeypatch, value)
    # On the CPU both take the driver with the plain rounds; the switch's
    # answer inside compress_image is what the card would route by.
    for calls, answer in ((on, (True, True)),
                          (off, ("msearch" not in value, False))):
        for name in ("trial1_refine", "trial2_refine", "_rounds_1plane",
                     "_rounds_2plane", "refine_round_1plane_plain",
                     "refine_round_2plane_plain", "mode_search"):
            assert calls.flags[name] == {answer}, name
        assert "trial1_refine_cuda" not in calls.n
        assert "trial2_refine_cuda" not in calls.n
    assert off.n["row_lookup"] > 0
    assert off.n["_rounds_1plane"] == off.n["trial1_refine"]
    assert off.n["_rounds_2plane"] == off.n["trial2_refine"]
    np.testing.assert_array_equal(got, want)


def test_refine_off_hdr_encode_matches_default(monkeypatch):
    """A 24x24 -ch encode with refine off runs the rounds driver with the
    plain HDR rounds (their realign lookups through gather.row_lookup),
    the switch answering False for ``refine`` inside it, and gives the
    default path's blocks."""
    targets = [(gather, "row_lookup"), (refine, "_rounds_1plane"),
               (refine, "_rounds_2plane"), (refine, "refine_round_1plane"),
               (refine, "refine_round_2plane"),
               (refine, "refine_round_1plane_plain"),
               (refine, "refine_round_2plane_plain")]
    ctx = api.context_alloc(api.config_init(
        api.Profile.HDR_RGB_LDR_A, 6, 6, 1, api.Quality.MEDIUM, 0),
        device="cpu")
    img = testdata.synthetic_hdr_image(24, 24, 5, independent_alpha=True)
    out = {}
    for value in ("", "refine"):
        with monkeypatch.context() as m:
            m.setenv("ASTC_DISABLE_KERNELS", value)
            calls = _Calls(m, targets)
            out[value] = (tc.compress_image(ctx, img), calls)
    on, off = out[""][1], out["refine"][1]
    for name in ("_rounds_1plane", "_rounds_2plane", "refine_round_1plane",
                 "refine_round_2plane", "refine_round_1plane_plain",
                 "refine_round_2plane_plain"):
        assert on.flags[name] == {(True, True)}
        assert off.flags[name] == {(True, False)}
    assert off.n["row_lookup"] > 0
    np.testing.assert_array_equal(out["refine"][0], out[""][0])
