"""Texel sums in the CPU's order on every device: the texel-sum kernel and
its plain version.

``out[n, p, c] = sum over t of a[n, t, p] * b[n, t, c]``, each product
rounded to float32 and then added, in one of three fixed orders:

- ``"seq"``: texel 0, then 1, then 2. That is how the CPU's batched
  product (``torch.einsum("ntp,ntc->npc")``) adds the terms of a one-hot
  mask, so ``masked_sum`` gives today's CPU bits;
- ``"outer"``: the CPU's reduction over an outer axis: ``x.sum(1)`` of an
  (N, T, C) tensor on the CPU adds runs of 16 texels in turn and moves
  each run's total up a cascade of 4 levels (ATen's ``multi_row_sum``);
  ``block_sum`` gives those bits;
- ``"wide"``: in turn in float64, rounded once, as the CPU's float32
  ``torch.cumsum`` accumulates (``prefix_sums``).

The encoder's glue takes these sums outside its kernels (partition means
and dominant directions, the encoding-choice line errors, k-means centres,
the block mean, the 2-plane correlation). On the card PyTorch adds them in
another order than on the CPU, and a last-bit difference in such a sum
flips encoder decisions (ROADMAP §C3). So each goes through this module:
on CPU tensors the plain version, which is the definition; on CUDA tensors
one launch of ``csrc/texel_sum.cu`` (one thread per output walking the
texels in order). There is no TPU counterpart: the JAX package leaves
these sums to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from .. import obs
from . import _build

_LEVELS = 4
_ORDERS = ("seq", "outer", "wide")


def _level_power(T: int) -> int:
    """log2 of the run length of the CPU's outer reduction of T terms."""
    return max(4, (max(T, 1) - 1).bit_length() // _LEVELS)


def texel_sum_plain(a, b, order: str = "seq"):
    """The definition: (N, T, P) x (N, T, C) -> (N, P, C), products
    rounded, then added in the order named."""
    N, T, P = a.shape
    C = b.shape[2]

    def term(t):
        return a[:, t, :, None] * b[:, t, None, :]

    if order == "wide":
        wide = torch.zeros((N, P, C), dtype=torch.float64, device=a.device)
        for t in range(T):
            wide = wide + term(t).double()
        return wide.float()
    outer = order == "outer"

    acc = [torch.zeros((N, P, C), dtype=torch.float32, device=a.device)
           for _ in range(_LEVELS)]
    t = 0
    if outer:
        lp = _level_power(T)
        step, mask = 1 << lp, (1 << lp) - 1
        while t + step <= T:
            for _ in range(step):
                acc[0] = acc[0] + term(t)
                t += 1
            for j in range(1, _LEVELS):
                acc[j] = acc[j] + acc[j - 1]
                acc[j - 1] = torch.zeros_like(acc[0])
                if t & (mask << (j * lp)):
                    break
    for t in range(t, T):
        acc[0] = acc[0] + term(t)
    if outer:
        for j in range(1, _LEVELS):
            acc[0] = acc[0] + acc[j]
    return acc[0]


def _lib():
    lib = _build.load("texel_sum")
    if not getattr(lib, "_astc_typed", False):
        lib.astc_texel_sum.restype = ctypes.c_int
        lib.astc_texel_sum.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        lib.astc_error_string.restype = ctypes.c_char_p
        lib.astc_error_string.argtypes = [ctypes.c_int]
        lib._astc_typed = True
    return lib


def texel_sum_cuda(a, b, order: str = "seq"):
    """Launch the texel-sum kernel; same arguments and output as the plain
    version. ``a`` and ``b`` may be strided or broadcast views."""
    N, T, P = a.shape
    C = b.shape[2]
    for name, t in (("a", a), ("b", b)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(b.shape[:2]) != (N, T):
        raise ValueError(f"b: expected shape ({N}, {T}, C), got "
                         f"{tuple(b.shape)}")
    out = torch.empty((N, P, C), dtype=torch.float32, device=a.device)
    lib = _lib()
    if out.numel():
        p = _build.ptr
        rc = lib.astc_texel_sum(
            p(a), p(b), p(out), N, T, P, C, _ORDERS.index(order),
            _level_power(T),
            *a.stride(), *b.stride(),
            ctypes.c_void_p(_build.stream(a.device.index)))
        if rc != 0:
            raise RuntimeError("texel_sum kernel launch failed: "
                               + lib.astc_error_string(rc).decode())
        if obs.on:
            obs.count("launch.texel_sum")
    return out


def texel_sum(a, b, order: str = "seq"):
    """The sum on either device: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if order not in _ORDERS:
        raise ValueError(f"unknown order {order!r}")
    if a.is_cuda:
        return texel_sum_cuda(a, b, order)
    if a.device.type != "cpu":
        raise ValueError(f"unsupported device {a.device}")
    return texel_sum_plain(a, b, order)


def masked_sum(mask, x):
    """Per-partition texel sums in the sequential order: (N, T, P) mask and
    (N, T, C) or (N, T) values -> (N, P, C) or (N, P); the CPU's
    ``torch.einsum("ntp,ntc->npc")`` bit for bit."""
    if x.dim() == 2:
        return texel_sum(mask, x[..., None])[..., 0]
    return texel_sum(mask, x)


def block_sum(x):
    """(N, T, C) -> (N, C), the CPU's ``x.sum(1)`` bit for bit."""
    ones = torch.ones((), dtype=torch.float32, device=x.device)
    return texel_sum(ones.expand(x.shape[0], x.shape[1], 1), x, "outer")[
        :, 0]


def row_sum(x):
    """(N, T) -> (N,): x[:, 0] + x[:, 1] + ..., added in turn."""
    ones = torch.ones((), dtype=torch.float32, device=x.device)
    return texel_sum(ones.expand(x.shape[0], x.shape[1], 1), x[..., None])[
        :, 0, 0]


def prefix_sums(x):
    """(N, T) -> (N, T): out[:, t] = x[:, 0] + ... + x[:, t], the CPU's
    ``torch.cumsum(x, 1)`` bit for bit (each later term enters as a
    product with 0, which adds nothing to finite sums)."""
    N, T = x.shape
    upper = torch.ones((T, T), dtype=torch.float32, device=x.device).triu()
    return texel_sum(upper.expand(N, T, T), x[..., None], "wide")[..., 0]
