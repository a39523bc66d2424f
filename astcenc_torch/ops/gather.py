"""Table gathers: kernel K9 (colour quantizer lookup), kernel K8 (per-row
table gather), their plain versions, and the kernel switch.

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

K8 replaces ``gather_pallas.py::_kernel`` (:120, launched by
``_row_lookup_2d`` :141/:147 from ``row_lookup`` :251):
``out[b, k(, c)] = rows[b, clip(idx[b, k], 0, V - 1)(, c)]`` for int32 or
float32 tables, float32 moved as its 32-bit pattern. The realign of the
non-fused trial path looks its prev/next rows up through it. On the card
(``csrc/row_gather.cu``) one thread handles one (row, index) pair and
copies all C words of the entry, so both prev/next channels take one
launch where the TPU launched once per channel, and the 128-lane slab loop
has no counterpart. It reads each index and entry once and writes each
word once: bound by device memory bytes, though at the realign's sizes a
call costs many times its bytes (launch latency and the wrapper's host
time; PERF.md has the measurements).

``kernel_enabled`` is the counterpart of ``gather_pallas._kernel_enabled``
(:49): ``ASTC_DISABLE_KERNELS="msearch,refine"`` switches those kernel
families off, as in the JAX package, which honours exactly these two
(``codec/trial.py`` reads them); other names are ignored.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ..tables import ise, quant
from . import _build

#: Launches of the CUDA kernels (the plain versions do not count): K9
#: and K8.
launches = 0
launches_rows = 0


def disabled_kernels() -> frozenset:
    """The kernel families ``ASTC_DISABLE_KERNELS`` switches off now: its
    comma-separated names, whitespace stripped, empty names dropped."""
    dis = os.environ.get("ASTC_DISABLE_KERNELS", "")
    return frozenset(s.strip() for s in dis.split(",") if s.strip())


def kernel_enabled(name: str) -> bool:
    """Whether ``ASTC_DISABLE_KERNELS`` leaves the family ``name`` on
    (``gather_pallas._kernel_enabled``)."""
    return name not in disabled_kernels()


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


# --- K8: per-row table gather ------------------------------------------------

def _words(rows, idx):
    """rows (..., V[, C]) and idx (..., K) -> rows as (B, V, C) int32 words
    (float32 by its bit pattern), idx as (B, K) and the output shape."""
    has_c = rows.dim() == idx.dim() + 1
    batch = tuple(idx.shape[:-1])
    B = int(np.prod(batch, dtype=np.int64))
    V, K = rows.shape[len(batch)], idx.shape[-1]
    C = rows.shape[-1] if has_c else 1
    r = rows.reshape(B, V, C)
    if r.dtype != torch.int32:
        r = r.to(torch.float32).view(torch.int32)
    return r, idx.reshape(B, K), batch + (K,) + ((C,) if has_c else ())


def _unwords(out, dtype, shape):
    if dtype != torch.int32:
        out = out.view(torch.float32).to(dtype)
    return out.reshape(shape)


def row_lookup_plain(rows, idx):
    """Plain version of ``row_lookup``: a ``torch.gather`` after the clip,
    float32 tables viewed as int32."""
    r, i, shape = _words(rows, idx)
    V, C = r.shape[1], r.shape[2]
    i = i.clamp(0, V - 1).to(torch.int64)
    out = torch.gather(r, 1, i[..., None].expand(-1, -1, C))
    return _unwords(out, rows.dtype, shape)


def _row_lib():
    lib = _build.load("row_gather")
    if not getattr(lib, "_astc_typed", False):
        fn = lib.astc_row_gather
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 2)
        lib.astc_error_string.restype = ctypes.c_char_p
        lib.astc_error_string.argtypes = [ctypes.c_int]
        lib._astc_typed = True
    return lib


def row_lookup_cuda(rows, idx):
    """Launch kernel K8; same arguments and output as the plain version."""
    global launches_rows
    r, i, shape = _words(rows, idx)
    B, V, C = r.shape
    K = i.shape[1]
    if i.dtype != torch.int32:
        i = i.clamp(0, V - 1).to(torch.int32)
    r, i = r.contiguous(), i.contiguous()
    _build.check(r, "rows", torch.int32, (B, V, C))
    _build.check(i, "idx", torch.int32, (B, K))
    out = torch.empty((B, K, C), dtype=torch.int32, device=r.device)
    if B * K * C:
        lib = _row_lib()
        p = _build.ptr
        rc = lib.astc_row_gather(
            p(r), p(i), B, V, K, C, p(out),
            ctypes.c_void_p(torch.cuda.current_stream(r.device).cuda_stream))
        if rc != 0:
            raise RuntimeError("row_gather kernel launch failed: "
                               + lib.astc_error_string(rc).decode())
        launches_rows += 1
    return _unwords(out, rows.dtype, shape)


def row_lookup(rows, idx, use_kernel: bool = True):
    """out[..., k(, c)] = rows[..., clip(idx[..., k], 0, V - 1)(, c)]
    (``gather_pallas.row_lookup``): rows (..., V) or (..., V, C), int32 or
    float32 (moved bit for bit); idx (..., K); the output has the rows'
    dtype. Kernel K8 for CUDA tensors, the plain version for CPU tensors
    (or anywhere with ``use_kernel=False``)."""
    if rows.is_cuda and use_kernel:
        return row_lookup_cuda(rows, idx)
    if not rows.is_cuda and rows.device.type != "cpu":
        raise ValueError(f"unsupported device {rows.device}")
    return row_lookup_plain(rows, idx)
