"""Public API, mirroring the reference's astcenc.h surface.

    config = config_init(profile, block_x, block_y, block_z, quality, flags)
    ctx = context_alloc(config, device="cuda")
    blocks = compress_image(ctx, image)          # (N, 16) uint8
    texels = decompress_image(ctx, blocks, dim_x, dim_y)

and the reference's helpers: compress_cancel, compress_reset,
get_error_string and get_block_info.

Port of ``astcenc_tpu/api.py``. The context carries the torch device; its
derived tables (decode tables, encoder tables, the trial pass tables, the
partition tables and their device copies) are shared by every context with
the same block size descriptor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .tables import bsd as _bsd
from . import config as _config
from .codec import decode_tables as _decode_tables
from ._host import decode_tables_to_torch
from .codec import block_info as _block_info
from .codec import compress as compress_mod
from .codec import decompress
from .codec import partition_search
from .codec import trial

ASTCConfig = _config.ASTCConfig
ConfigError = _config.ConfigError
Error = _config.Error
Flags = _config.Flags
Profile = _config.Profile
Quality = _config.Quality
Swizzle = _config.Swizzle
config_init = _config.config_init
error_string = _config.error_string

__all__ = [
    "Profile", "Quality", "Flags", "Swizzle", "ASTCConfig", "Error",
    "ConfigError", "config_init", "context_alloc", "compress_image",
    "decompress_blocks", "decompress_image", "Context", "compress_cancel",
    "compress_reset", "get_error_string", "get_block_info",
]

# Derived tables keyed by BSD identity (build_bsd is cached by its
# parameters, so equal configs share one BSD and one entry here).
_derived_cache: dict = {}


def _derived(bsd) -> dict:
    ent = _derived_cache.get(id(bsd))
    if ent is None or ent["bsd"] is not bsd:
        ent = {"bsd": bsd, "dt": _decode_tables.build_decode_tables(bsd)}
        _derived_cache[id(bsd)] = ent
    return ent


@dataclasses.dataclass
class Context:
    """Compression/decompression context: config, block size descriptor,
    the device its tensors live on, and the cancel flag that
    compress_cancel sets and compress_image clears at its start."""

    config: ASTCConfig
    bsd: object
    device: torch.device
    cancel_requested: bool = False

    @property
    def block_dims(self):
        return (self.config.block_x, self.config.block_y,
                self.config.block_z)

    @property
    def dtables(self):
        """Decode tables (host NumPy)."""
        return _derived(self.bsd)["dt"]

    def torch_decode_tables(self):
        ent = _derived(self.bsd)
        key = ("dt", str(self.device))
        if key not in ent:
            ent[key] = decode_tables_to_torch(ent["dt"], self.device)
        return ent[key]

    def encoder_tables(self):
        ent = _derived(self.bsd)
        if "et" not in ent:
            ent["et"] = trial.build_encoder_tables(self.bsd)
        return ent["et"]

    def pass_tables(self, kind: str = "full", pc: int = 1):
        """A trial pass's tables on this context's device: kind "always"
        (the mode-0 pass), "full" (1 plane, pc 1-4) or "two" (2 planes)."""
        ent = _derived(self.bsd)
        key = ("pt", kind, int(pc), str(self.device))
        if key not in ent:
            ent[key] = trial.pass_tables(self.encoder_tables(), kind,
                                         int(pc), self.device)
        return ent[key]

    def partition_tables(self, pc: int):
        """The BSD's partitionings of ``pc`` partitions on this context's
        device (``partition_search.device_tables``)."""
        ent = _derived(self.bsd)
        key = ("part", int(pc), str(self.device))
        if key not in ent:
            ent[key] = partition_search.device_tables(self.bsd, int(pc),
                                                      self.device)
        return ent[key]


def context_alloc(config: ASTCConfig, thread_count: int = 0, *,
                  device="cuda") -> Context:
    """Build a context (reference: astcenc_context_alloc,
    astcenc_entry.cpp:726) for tensors on ``device``: the card unless the
    caller asks for the CPU. A CUDA device on a host without one raises;
    nothing falls back to the CPU. ``thread_count`` is taken and ignored,
    as in the JAX package: the batched encode replaces the caller's
    thread pool."""
    del thread_count
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("context_alloc: no CUDA device (pass "
                           "device='cpu' to run on the CPU)")
    _config.validate_config(config)
    decompress_only = bool(config.flags & Flags.DECOMPRESS_ONLY)
    self_decompress = bool(config.flags & Flags.SELF_DECOMPRESS_ONLY)
    can_omit = self_decompress and not decompress_only
    # The dB quality limit becomes a per-texel MSE threshold in the
    # 0..65535 texel domain (reference: astcenc_entry.cpp:809-821).
    config = dataclasses.replace(config)
    if not decompress_only:
        if int(config.profile) in (int(Profile.LDR), int(Profile.LDR_SRGB)):
            config.tune_db_limit = float(
                np.float32(0.1) ** np.float32(config.tune_db_limit * 0.1)
                * np.float32(65535.0) * np.float32(65535.0))
        else:
            config.tune_db_limit = 0.0
    bsd = _bsd.build_bsd(
        config.block_x, config.block_y, config.block_z,
        can_omit_modes=can_omit,
        mode_cutoff=config.tune_block_mode_limit / 100.0,
        partition_count_cutoff=config.tune_partition_count_limit)
    return Context(config=config, bsd=bsd, device=device)


def compress_image(ctx: Context, image: np.ndarray, swizzle=(0, 1, 2, 3),
                   progress_callback=None, tracer=None) -> np.ndarray:
    """Compress an image array to (N, 16) uint8 blocks, raster order.
    ``tracer``, if given, collects the block/pass/candidate diagnostic tree
    (``codec.trace.Tracer``; the reference's ASTCENC_DIAGNOSTICS -dtrace
    build)."""
    return compress_mod.compress_image(ctx, image, swizzle,
                                       progress_callback=progress_callback,
                                       tracer=tracer)


def compress_reset(ctx: Context) -> None:
    """Re-arm a context between images (reference: astcenc_compress_reset,
    astcenc_entry.cpp:1231-1248, which re-arms its work-stealing
    scheduler). The chunked pipeline keeps no state between images and
    compress_image clears the cancel flag itself, so there is nothing to
    re-arm: this does nothing, as in the JAX package (``api.py:205``)."""


def compress_cancel(ctx: Context) -> None:
    """Ask an encode in flight on ``ctx`` to stop (reference:
    astcenc_compress_cancel, astcenc_entry.cpp:1251-1271): compress_image
    checks the flag before each chunk, and the blocks of the chunks it did
    not start come back as zero bytes. Call it from the progress callback
    or another thread."""
    ctx.cancel_requested = True


def get_error_string(status) -> str | None:
    """The stable string of an error code (reference:
    astcenc_get_error_string, astcenc_entry.cpp:1519-1558): takes an
    Error, an int or a raised ConfigError (its ``.code``); None outside the
    enum, as the reference returns nullptr."""
    if isinstance(status, ConfigError):
        status = status.code
    return error_string(status)


def get_block_info(ctx: Context, block) -> dict:
    """The encoding metadata of one 16-byte physical block (reference:
    astcenc_get_block_info, astcenc_entry.cpp:1401-1517), parsed on the
    host: ``codec/block_info.py``."""
    return _block_info.get_block_info(ctx, block)


def decompress_blocks(ctx: Context, blocks, decode_unorm8: bool = False):
    """Decode raw (N, 16) blocks to (N, T, 4) float32 texels (a tensor on
    ctx.device)."""
    pcb = torch.as_tensor(np.array(blocks, dtype=np.uint8, order="C")
                          if not torch.is_tensor(blocks) else blocks)
    return decompress.decompress_symbolic_batch(
        ctx.torch_decode_tables(), pcb.to(ctx.device),
        int(ctx.config.profile), bool(decode_unorm8))


def _apply_store_swizzle(img, swizzle):
    if tuple(swizzle) == (0, 1, 2, 3):
        return img
    chans = {i: img[..., i] for i in range(4)}
    chans[4] = torch.zeros_like(img[..., 0])
    chans[5] = torch.ones_like(img[..., 0])
    if 6 in swizzle:
        # Normal-map Z reconstruction (reference: astcenc_image.cpp:420-429)
        xn = img[..., 0] * 2.0 - 1.0
        yn = img[..., 3] * 2.0 - 1.0
        zn = torch.clamp(1.0 - xn * xn - yn * yn, min=0.0)
        # float32 sqrt, correctly rounded on every device
        root = torch.sqrt(zn.double()).float()
        chans[6] = torch.clamp(root * 0.5 + 0.5, max=1.0)
    return torch.stack([chans[s] for s in swizzle], dim=-1)


def decompress_image(ctx: Context, blocks, dim_x: int, dim_y: int,
                     dim_z: int = 1, out_type: str = "u8",
                     swizzle=(0, 1, 2, 3)) -> np.ndarray:
    """Decode blocks to a (dim_z, dim_y, dim_x, 4) image array: uint8,
    float16 or float32, with an output component swizzle (reference:
    astcenc_decompress_image, astcenc_entry.cpp:1274, and
    store_image_block, astcenc_image.cpp:345).
    """
    bx, by, bz = ctx.block_dims
    nx, ny, nz = -(-dim_x // bx), -(-dim_y // by), -(-dim_z // bz)
    n = nx * ny * nz
    if blocks.shape[0] < n:
        raise ValueError(f"expected {n} blocks, got {blocks.shape[0]}")
    tex = decompress_blocks(ctx, blocks[:n], out_type == "u8")
    img = tex.reshape(nz, ny, nx, bz, by, bx, 4).permute(
        0, 3, 1, 4, 2, 5, 6).reshape(nz * bz, ny * by, nx * bx, 4)
    img = _apply_store_swizzle(img[:dim_z, :dim_y, :dim_x], swizzle)
    if out_type == "u8":
        nan = torch.isnan(img[..., 0:1])
        u8 = torch.floor(torch.nan_to_num(torch.clamp(img, 0.0, 1.0) * 255.0)
                         + 0.5).to(torch.uint8)
        # NaN error texels decode to magenta (astcenc_image.cpp:437-446).
        magenta = torch.tensor([255, 0, 255, 255], dtype=torch.uint8,
                               device=img.device)
        return torch.where(nan, magenta, u8).cpu().numpy()
    if out_type == "f16":
        return img.to(torch.float16).cpu().numpy()
    return img.cpu().numpy()
