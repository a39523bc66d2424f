"""Table gathers: the colour quant tables and their lookup, kernel K8 (per-row
table gather) with its plain version, and the kernel switch.

``quant_lookup_plain`` is the lookup of the TPU kernel
``astcenc_tpu/ops/gather_pallas.py::_master_kernel`` (:170, launched by
``_master_lookup_tpu`` :206 from ``master_lookup`` :224): for each row b
and value k it returns ``lo[q[b], v[b, k]] | hi[q[b], v[b, k]] << 8`` from
the (17, 256) colour quant tables (``quant_tables_np``), with q clamped to
[0, 16] and v to [0, 255]. The plain colour packers (``color_pack``,
``color_pack_hdr``) look their values up through it. On the card the
lookup is a shared-memory read inside the colour pack kernel
(``csrc/color_pack.cu``), which runs a whole pack call in one launch.

K8 replaces ``gather_pallas.py::_kernel`` (:120, launched by
``_row_lookup_2d`` :141/:147 from ``row_lookup`` :251):
``out[b, k(, c)] = rows[b, clip(idx[b, k], 0, V - 1)(, c)]`` for int32 or
float32 tables, float32 moved as its 32-bit pattern. The realign of the
non-fused trial path looks its prev/next rows up through it. On the card
(``csrc/row_gather.cu``) one thread handles one (row, index) pair and
copies all C words of the entry (one 8-byte move for the prev/next pair),
so both prev/next channels take one launch where the TPU launched once per
channel, and the 128-lane slab loop has no counterpart. It reads each
index and entry once and writes each word once: bound by device memory
bytes, though at the realign's sizes a call costs many times its bytes.
The wrapper therefore does as little as it can on the host: the kernel
takes int32 or int64 indices and clamps them itself, the checks read
attributes only, and the output is allocated in its final shape.

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

from .. import obs
from ..tables import ise, quant
from . import _build


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


def quant_tables(device):
    """The (2, 17, 256) int32 lo and hi tables on ``device``, cached."""
    key = str(device)
    if key not in _lohi:
        _lohi[key] = torch.from_numpy(np.stack(quant_tables_np())).to(device)
    return _lohi[key]


def quant_lookup_plain(qidx, vals):
    """Plain version: a gather from the packed tables at row q[b], column
    v[b, k]. qidx (B,), vals (B, K) int -> (B, K) int32 lo | hi << 8."""
    lo, hi = quant_tables(qidx.device)
    q = torch.clamp(qidx, 0, lo.shape[0] - 1).to(torch.int64)
    v = torch.clamp(vals, 0, lo.shape[1] - 1).to(torch.int64)
    idx = q[:, None] * lo.shape[1] + v
    return torch.take(lo, idx) | (torch.take(hi, idx) << 8)


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


_row_fn = None


def _bind_rows():
    """astc_row_gather of the built library, its argument types set once."""
    global _row_fn
    lib = _build.load("row_gather")
    fn = lib.astc_row_gather
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2)
    lib.astc_error_string.restype = ctypes.c_char_p
    lib.astc_error_string.argtypes = [ctypes.c_int]
    _row_fn = fn
    return fn


_ROW_DTYPES = (torch.int32, torch.float32)
_IDX_DTYPES = (torch.int32, torch.int64)


def _refuse(rows, idx):
    """Raise the error that says why K8 does not take rows and idx."""
    if not (rows.is_cuda and idx.is_cuda):
        raise ValueError("row_lookup_cuda: rows and idx must be CUDA tensors")
    if rows.dtype not in _ROW_DTYPES or idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"row_lookup_cuda: rows {rows.dtype} (int32 or "
                        f"float32), idx {idx.dtype} (int32 or int64)")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_lookup_cuda: rows and idx must be contiguous")
    if rows.get_device() != idx.get_device():
        raise ValueError("row_lookup_cuda: rows and idx on two devices")
    raise ValueError(f"row_lookup_cuda: rows {tuple(rows.shape)} do not "
                     f"match idx {tuple(idx.shape)}")


def row_lookup_cuda(rows, idx):
    """Launch kernel K8; same arguments and output as the plain version.
    rows (..., V[, C]) int32 or float32 and idx (..., K) int32 or int64,
    contiguous, on one CUDA device; raises on anything else. The call is
    host-bound (PERF.md), so the checks are one expression of attribute
    reads, and the output is allocated once, in its final shape."""
    nb = idx.dim() - 1
    tail = rows.shape[nb + 1:]
    if not (rows.is_cuda and idx.is_cuda and rows.dtype in _ROW_DTYPES
            and idx.dtype in _IDX_DTYPES and rows.dim() in (nb + 1, nb + 2)
            and rows.is_contiguous() and idx.is_contiguous()
            and rows.shape[:nb] == idx.shape[:nb]
            and rows.get_device() == idx.get_device()):
        _refuse(rows, idx)
    out = rows.new_empty(idx.shape + tail)
    K = idx.shape[-1]
    if out.numel():
        fn = _row_fn or _bind_rows()
        rc = fn(rows.data_ptr(), idx.data_ptr(), idx.dtype == torch.int64,
                idx.numel() // K, rows.shape[nb], K, tail[0] if tail else 1,
                out.data_ptr(), _build.stream(rows.get_device()))
        if rc != 0:
            raise RuntimeError("row_gather kernel launch failed: "
                               + _build.load("row_gather").astc_error_string(
                                   rc).decode())
        if obs.on:
            obs.count("launch.row_gather")
    return out


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
