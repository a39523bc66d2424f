"""The operation model of kernel K4 (partition search, ``csrc/psearch.cu``).

Kept with the benchmark, as ``roofline.py`` keeps K1's, so that the
yardstick does not move with the program. A launch scores S candidate
partitionings of each of N blocks of T texels at P partitions. Per block
and candidate it makes three passes over the texels, each for all P
partitions at once; a block whose alpha varies uses n = 4 channels, any
other n = 3 (the kernel multiplies the fourth by a mask of 0, which is no
work the result needs and is not counted). Counting each add, multiply,
divide, square root, minimum, maximum and comparison once:

- counts and means: per texel 1 + 2n (the count, and each channel's
  masked sum); per partition n + 1 (the divisions and the clamp of the
  count);
- dominant directions, one pass per channel c < n: per texel 3 (the
  masked deviation from the partition's mean and its test), and for a
  texel above its partition's mean 1 + 2n (the count and the masked sum
  of the positive deviations). Which texels lie above depends on the
  data; half of them is counted, the expectation for texels spread evenly
  about the mean. Per partition and channel 6n + 1 (the sum of
  deviations, its squared norm, the comparison with the best);
- line errors: per texel 19n + 4 (the projections on the uncorrelated and
  the same-chroma line, 6n; the two squared weighted distances, 13n; the
  two error sums, and the line's minimum and maximum); per partition
  19n + 10 (both directions normalised, the uncorrelated line's offset,
  the line-length penalties).

The bytes are each input read once, the whole partition table among
them, and each output written once.
"""

from __future__ import annotations

import inspect

from . import roofline


def ops_per_candidate(T: int, P: int, n: int) -> float:
    """Float operations of one block and candidate: T texels, P
    partitions, n channels."""
    per_texel = (1 + 2 * n) + n * (3 + (1 + 2 * n) / 2) + (19 * n + 4)
    per_partition = (n + 1) + n * (6 * n + 1) + (19 * n + 10)
    return T * per_texel + P * per_partition


def ops_k4(N: int, S: int, T: int, P: int, n_alpha: int) -> float:
    """Float operations of one launch whose N blocks include ``n_alpha``
    whose alpha varies."""
    return S * (n_alpha * ops_per_candidate(T, P, 4)
                + (N - n_alpha) * ops_per_candidate(T, P, 3))


class K4Calls:
    """Records every launch of K4 while it is started, by wrapping
    ``astcenc_torch.ops.psearch.line_errors_cuda``: its shapes, bytes and
    partition count, and its blocks' alpha flags (a small (N,) tensor, kept
    by reference). Nothing runs on the device and nothing waits for it
    during the recording; ``bounds_ms`` counts the operations after it."""

    def __init__(self, psearch_module):
        self.mod = psearch_module
        self.orig = None
        self.calls = []

    def start(self) -> None:
        orig = self.mod.line_errors_cuda
        sig = inspect.signature(orig)
        calls = self.calls

        def line_errors_cuda(*args, **kw):
            out = orig(*args, **kw)
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            a = a.arguments
            N, S = a["top"].shape
            if N and S:
                nb = (roofline.nbytes(a["texels"], a["uses_alpha"], a["top"],
                                      a["pot_table"], a["cw_scale"])
                      + roofline.nbytes(*out))
                calls.append((int(N), int(S), int(a["texels"].shape[1]),
                              int(a["P"]), a["uses_alpha"], nb))
            return out

        self.orig = orig
        self.mod.line_errors_cuda = line_errors_cuda

    def stop(self) -> None:
        if self.orig is not None:
            self.mod.line_errors_cuda = self.orig
            self.orig = None

    def bounds_ms(self, peak: dict) -> float:
        return sum(roofline.bound_ms(
            nb, ops_k4(N, S, T, P, int((ua != 0).sum())), peak)
            for N, S, T, P, ua, nb in self.calls)
