"""The texel sums of astcenc_torch (ops/texel_sum.py) and the fixed-order
channel sums and square root (ops/softfloat.py) against the CPU's own
PyTorch calls, bit for bit: the plain versions are what the card's
texel-sum kernel computes, so where they equal the CPU's calls the card's
glue takes the CPU's decisions (ROADMAP §C3). Seeded, small, CPU only.
"""

import numpy as np
import pytest
import torch

from astcenc_torch.ops import softfloat as sf
from astcenc_torch.ops import texel_sum as ts


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("T", [16, 36, 64, 144, 216])
def test_texel_sum_plain_matches_cpu(T):
    """masked_sum is the CPU's einsum over texels ("ntp,ntc->npc" and
    "ntp,nt->np"), block_sum its x.sum(1) and prefix_sums its cumsum, bit
    for bit, at the texel counts of 4x4 to 12x12 and 6x6x6 blocks."""
    rng = np.random.default_rng(T)
    N, P = 128, 3
    x = torch.from_numpy(rng.normal(0, 3e4, (N, T, 4)).astype(np.float32))
    x[:N // 4] = torch.from_numpy(rng.integers(0, 256, (N // 4, T, 4)).astype(
        np.float32) * 257.0)
    m = torch.from_numpy(np.eye(P, dtype=np.float32)[
        rng.integers(0, P, (N, T))])
    d = x[..., 0].abs()
    for got, want in (
            (ts.masked_sum(m, x), torch.einsum("ntp,ntc->npc", m, x)),
            (ts.masked_sum(m, x[..., 1]),
             torch.einsum("ntp,nt->np", m, x[..., 1])),
            (ts.block_sum(x), x.sum(1)),
            (ts.prefix_sums(d), torch.cumsum(d, 1))):
        assert got.shape == want.shape
        assert int((_bits(got) != _bits(want)).sum()) == 0


def test_channel_sums_and_sqrt_match_cpu():
    """sum3/sum4 are the CPU's .sum(-1) over three and four channels, and
    sqrt is the correctly rounded float32 root (the float64 root rounded),
    which the CPU's float32 torch.sqrt misses in a few values."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(0, 1e4, (20000, 4)).astype(np.float32))
    assert int((_bits(sf.sum4(v)) != _bits(v.sum(-1))).sum()) == 0
    assert int((_bits(sf.sum3(v)) != _bits(v[:, :3].sum(-1))).sum()) == 0
    a = v.abs().reshape(-1)
    r = sf.sqrt(a)
    exact = np.sqrt(a.numpy().astype(np.float64)).astype(np.float32)
    assert (r.numpy() == exact).all()


def test_texel_sum_router_and_orders():
    """The router takes the plain version for CPU tensors, refuses unknown
    orders; the outer order of a run-length multiple differs from the
    sequential one only in its rounding."""
    rng = np.random.default_rng(5)
    a = torch.ones(8, 64, 1)
    b = torch.from_numpy(rng.uniform(0, 65535, (8, 64, 4)).astype(np.float32))
    seq = ts.texel_sum(a, b, "seq")
    outer = ts.texel_sum(a, b, "outer")
    wide = ts.texel_sum(a, b, "wide")
    ref = b.double().sum(1)[:, None]
    for got in (seq, outer, wide):
        assert torch.allclose(got.double(), ref, rtol=1e-6)
    with pytest.raises(ValueError):
        ts.texel_sum(a, b, "pairwise")
