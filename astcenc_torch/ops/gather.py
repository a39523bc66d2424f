"""Colour quantizer lookup: kernel K9 and its plain version.

K9 replaces the TPU kernel
``astcenc_tpu/ops/gather_pallas.py::_master_kernel`` (:170, launched by
``_master_lookup_tpu`` :206 from ``master_lookup`` :224): for each row b
and value k it returns ``lo[q[b], v[b, k]] | hi[q[b], v[b, k]] << 8`` from
the (17, 256) colour quant tables (``quant_tables_np``), with
q clamped to [0, 16] and v to [0, 255]. The colour packers
(``color_pack``, ``color_pack_hdr``) send every table lookup of one call
site through one call.

On the card (``csrc/quant_lookup.cu``) one thread handles one (row, value)
element, after its thread block has staged both tables, packed to 16 bits,
in shared memory. The TPU kernel's one-hot MXU row selection and 128-lane
slab gathers have no counterpart: a gather is native here. The kernel
reads q and v and writes the result once, so it is bound by device memory
bytes; at the packers' sizes (tens of thousands of elements) it is bound by
launch latency instead.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..tables import ise, quant
from . import _build

#: Launches of the CUDA kernel (the plain version does not count).
launches = 0


@functools.cache
def quant_tables_np():
    """(lo (17, 256), hi (17, 256)) int32 colour quant tables: for each
    quant level from QUANT_6 and each value, the quantized values just
    below and above it."""
    lo = np.zeros((17, 256), np.int32)
    hi = np.zeros((17, 256), np.int32)
    for q in range(ise.QUANT_6, 21):
        t = quant.color_quant_tables(q)
        lo[q - ise.QUANT_6] = t["unquant_to_uquant_lo"]
        hi[q - ise.QUANT_6] = t["unquant_to_uquant_hi"]
    return lo, hi


_lohi: dict = {}


def _tables(device):
    """The (2, 17, 256) int32 lo and hi tables on ``device``, cached."""
    key = str(device)
    if key not in _lohi:
        _lohi[key] = torch.from_numpy(np.stack(quant_tables_np())).to(device)
    return _lohi[key]


def quant_lookup_plain(qidx, vals):
    """Plain version: a gather from the packed tables at row q[b], column
    v[b, k]. qidx (B,), vals (B, K) int -> (B, K) int32 lo | hi << 8."""
    lo, hi = _tables(qidx.device)
    q = torch.clamp(qidx, 0, lo.shape[0] - 1).to(torch.int64)
    v = torch.clamp(vals, 0, lo.shape[1] - 1).to(torch.int64)
    idx = q[:, None] * lo.shape[1] + v
    return torch.take(lo, idx) | (torch.take(hi, idx) << 8)


def _lib():
    lib = _build.load("quant_lookup")
    if not getattr(lib, "_astc_typed", False):
        fn = lib.astc_quant_lookup
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 2)
        lib.astc_error_string.restype = ctypes.c_char_p
        lib.astc_error_string.argtypes = [ctypes.c_int]
        lib._astc_typed = True
    return lib


def quant_lookup_cuda(qidx, vals):
    """Launch kernel K9; same arguments and output as the plain version."""
    global launches
    B, K = vals.shape
    dev = vals.device
    i32 = torch.int32
    _build.check(qidx, "qidx", i32, (B,))
    _build.check(vals, "vals", i32, (B, K))
    out = torch.empty((B, K), dtype=i32, device=dev)
    if B * K:
        lib = _lib()
        p = _build.ptr
        rc = lib.astc_quant_lookup(
            p(qidx), p(vals), p(_tables(dev)), B, K, p(out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError("quant_lookup kernel launch failed: "
                               + lib.astc_error_string(rc).decode())
        launches += 1
    return out


def quant_lookup(qidx, vals, use_kernel: bool = True):
    """Packed colour quant lookup: kernel K9 for CUDA tensors, the plain
    version for CPU tensors (or anywhere with ``use_kernel=False``)."""
    if vals.is_cuda and use_kernel:
        return quant_lookup_cuda(qidx.to(torch.int32).contiguous(),
                                 vals.to(torch.int32).contiguous())
    if not vals.is_cuda and vals.device.type != "cpu":
        raise ValueError(f"unsupported device {vals.device}")
    return quant_lookup_plain(qidx, vals)
