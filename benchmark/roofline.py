"""Peaks of the card and the operation model of kernel K1 (mode search).

Frozen copies of ``chip_smoke.py``'s ``_bound``, ``_nbytes`` and
``_ops_k1``, kept with the benchmark so that the yardstick does not move
with the program. A call's bound is the larger of its bytes (each input
tensor read once, each output written once) over the card's memory
bandwidth and its float operations over the card's float32 rate outside
the tensor cores; a kernel's share of its roofline is the sum of its calls'
bounds over the sum of their device time.
"""

from __future__ import annotations

import inspect

import torch

#: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12, "f32_ops_s": 67e12},
}


def peaks(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def bound_ms(nb: int, ops: float, peak: dict) -> float:
    return max(nb / peak["hbm_bytes_s"], ops / peak["f32_ops_s"]) * 1e3


# K1, per block and plane: the decimated ideal weights (16 per texel tap of
# each decimation); the angular sums and extents, 8 per weight and step,
# over the steps the block's search takes (kSteps[min(maxprec, 7, maxwq)]
# for each decimation with an angular level in use); per mode the weight
# quantization (6 per weight) and the weight-set error (11 per texel); per
# mode the format lookup and the top-C selection (8 + C).
_K1_STEPS = (2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32)


def ops_k1(pt, N: int, T: int, maxwq, C: int, two: bool) -> float:
    k = pt.k
    D, W = k.wt_n.shape
    M = k.modes.shape[0]
    planes = 2 if two else 1
    mp = torch.minimum(k.maxprec.clamp(max=7)[None, :],
                       maxwq[:, None].to(k.maxprec.dtype)).clamp(0, 11)
    steps = torch.tensor(_K1_STEPS, device=mp.device)[mp.long()]
    used = (k.levels_used != 0).to(steps.dtype) * k.wcount.to(steps.dtype)
    angular = float((steps * used[None, :]).sum())
    return (planes * (N * 16 * D * T + 8 * angular
                      + N * M * (6 * W + 11 * T)) + N * M * (8 + C))


class K1Calls:
    """Records every call of the port's mode search that launches K1 while
    it is started, by wrapping ``astcenc_torch.ops.msearch.mode_search``:
    its pass tables, shapes and bytes, and its per-block weight quant
    limits (kept by reference). Nothing runs on the device and nothing
    waits for it during the recording; ``bounds_ms`` counts the
    operations after it."""

    def __init__(self, msearch_module):
        self.mod = msearch_module
        self.orig = None
        self.calls = []

    def start(self) -> None:
        orig = self.mod.mode_search
        sig = inspect.signature(orig)
        calls = self.calls

        def mode_search(*args, **kw):
            out = orig(*args, **kw)
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            a = a.arguments
            if a["wei"].is_cuda and a.get("use_kernel", True):
                k = a["pt"].k
                nb = (nbytes(a["wei"], a["wes"], a["mcut"], a["maxwq"],
                             a["comb_err"], a["comb_fmt"], a["wei2"],
                             a["wes2"], a["mcut2"], k.taps, k.wlist, k.wt_n,
                             k.wcount, k.maxprec, k.modes, k.unq, k.sin_t,
                             k.cos_t, k.levels_used) + nbytes(*out.values()))
                N, T = a["wei"].shape
                calls.append((a["pt"], int(N), int(T), a["maxwq"],
                              int(a["C"]), a["wei2"] is not None, nb))
            return out

        self.orig = orig
        self.mod.mode_search = mode_search

    def stop(self) -> None:
        if self.orig is not None:
            self.mod.mode_search = self.orig
            self.orig = None

    def bounds_ms(self, peak: dict) -> float:
        return sum(bound_ms(nb, ops_k1(pt, N, T, maxwq, C, two), peak)
                   for pt, N, T, maxwq, C, two, nb in self.calls)
