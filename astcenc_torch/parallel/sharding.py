"""Multi-device encode: the block axis split across torch devices.

The PyTorch analog of ``astcenc_tpu/parallel/sharding.py:19-86``. The codec
is embarrassingly parallel over blocks: the reference's work-stealing
scheduler (Source/astcenc_internal_entry.h:97-324) becomes one shard of the
(N, ...) block axis per device, with no communication between shards. Each
shard runs the port's own encode or decode on its device, with that
device's copies of the tables, and the host concatenates the results. The
host drives the shards one after another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import api
from ..codec import compress as compress_mod
from ..ops import gather


def make_mesh(devices=None) -> list:
    """The devices to split over, as ``torch.device``s: every CUDA device
    by default (raises without one); a device may be listed more than
    once."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass the "
                               "devices, for example ['cpu', 'cpu'])")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    return devs


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _shards(array: np.ndarray, ndev: int, pad_row: np.ndarray):
    """``array`` padded with ``pad_row`` to a multiple of ``ndev`` rows (at
    least ``ndev``), split into ``ndev`` equal shards."""
    n = array.shape[0]
    npad = pad_to_multiple(max(n, ndev), ndev)
    if npad != n:
        pad = np.broadcast_to(pad_row, (npad - n,) + array.shape[1:])
        array = np.concatenate([array, pad], axis=0)
    return np.split(array, ndev)


def _on(ctx, device):
    """``ctx`` with its tensors on ``device`` (the tables are shared by
    every context of the same block size descriptor, one copy a device)."""
    return dataclasses.replace(ctx, device=device)


def compress_blocks_sharded(ctx, texels, devices=None) -> np.ndarray:
    """Compress (N, T, 4) float32 texel blocks (``compress.image_to_blocks``'
    output) split across ``devices`` (``make_mesh``). N is padded with
    copies of the first block to a multiple of the device count, as the JAX
    package pads. Returns the (N, 16) uint8 blocks, which do not depend on
    the split."""
    devs = make_mesh(devices)
    texels = np.ascontiguousarray(np.asarray(texels, np.float32))
    n = texels.shape[0]
    disabled = gather.disabled_kernels()
    outs = []
    for dev, part in zip(devs, _shards(texels, len(devs), texels[:1])):
        dctx = _on(ctx, dev)
        for lo in range(0, part.shape[0], compress_mod.CHUNK):
            tex = torch.from_numpy(part[lo:lo + compress_mod.CHUNK]).to(dev)
            outs.append(compress_mod.compress_blocks(
                dctx, tex, disabled=disabled).cpu())
    return torch.cat(outs).numpy()[:n]


def decompress_blocks_sharded(ctx, blocks, devices=None,
                              decode_unorm8: bool = False) -> np.ndarray:
    """Decode (N, 16) blocks split across ``devices`` (zero blocks pad N
    to a multiple of the device count). Returns (N, T, 4) float32 texels."""
    devs = make_mesh(devices)
    blocks = np.ascontiguousarray(np.asarray(blocks, np.uint8))
    n = blocks.shape[0]
    outs = [api.decompress_blocks(_on(ctx, dev), part, decode_unorm8).cpu()
            for dev, part in zip(devs, _shards(blocks, len(devs),
                                               np.zeros(16, np.uint8)))]
    return torch.cat(outs).numpy()[:n]
