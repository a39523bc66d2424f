"""Batched block compression driver, 1-partition 1-plane slice.

Port of the stage-1 path of ``astcenc_tpu/codec/compress.py``:
make_block_state, _lowest_correlation, _stage1_1plane (:290-411),
_finalize_pack (:622-646) and compress_image (:1001-1123). Every block of
a chunk goes through the mode-0 pass and the full 1-plane pass; blocks
that hit the quality target are frozen, as the reference's early exits
would stop them (astcenc_compress_symbolic.cpp:1283-1318).

The later stages (1 partition 2 planes, then 2-4 partitions) are not
ported yet. The driver refuses configurations that would need them
rather than skip them: a partition count limit above 1, or any unfinished
block that the 2-plane correlation gate leaves eligible.
"""

from __future__ import annotations

import numpy as np
import torch

from .._host import config as host_config
from . import physical, trial

TUNE_MIN_SEARCH_MODE0 = 0.85
# Blocks per chunk: bounds the plain versions' (chunk, modes, weights,
# angular steps) intermediates on the device.
CHUNK = 16384

Flags = host_config.Flags
Profile = host_config.Profile


def make_block_state(texels, profile: int = 1):
    """Per-block state dict from (N, T, 4) float32 texels."""
    data_min = texels.amin(1)
    data_max = texels.amax(1)
    gray = ((texels[..., 0] == texels[..., 1])
            & (texels[..., 0] == texels[..., 2])).all(1)
    default_alpha = 30720.0 if profile == 3 else 65535.0
    alpha1 = (data_min[:, 3] == default_alpha) & (
        data_max[:, 3] == default_alpha)
    return {
        "texels": texels, "data_min": data_min, "data_max": data_max,
        "data_mean": texels.mean(1), "grayscale": gray,
        "uses_alpha": data_min[:, 3] != data_max[:, 3],
        "is_luminance": gray & alpha1, "is_luminancealpha": gray & ~alpha1,
        "default_alpha": default_alpha,
    }


def _lowest_correlation(texels, channel_weight):
    """prepare_block_statistics (reference :1047-1159): the smallest
    |correlation| between two channels of each block."""
    cw = torch.tensor(channel_weight, dtype=torch.float32,
                      device=texels.device)
    weight = cw.sum() / 4.0
    T = texels.shape[1]
    rpt = 1.0 / torch.clamp(weight * T, min=1e-7)
    s = texels.sum(1) * weight
    var = torch.einsum("ntc,ntd->ncd", texels, texels) * weight
    var = var - s[:, :, None] * s[:, None, :] * rpt
    d = torch.sqrt(torch.clamp(torch.diagonal(var, dim1=1, dim2=2), min=0.0))
    denom = d[:, :, None] * d[:, None, :]
    corr = var / torch.where(denom > 0, denom, 1.0)
    corr = torch.where(torch.isnan(corr) | (denom == 0), 1.0, corr)
    iu = torch.triu_indices(4, 4, offset=1, device=texels.device)
    return corr[:, iu[0], iu[1]].abs().amin(1)


def check_supported(cfg) -> None:
    """Refuse what this slice of the port does not do yet."""
    if int(cfg.profile) not in (int(Profile.LDR), int(Profile.LDR_SRGB)):
        raise NotImplementedError("HDR profiles are not ported yet")
    if cfg.tune_partition_count_limit > 1:
        raise NotImplementedError(
            "multi-partition search (stage 2b) is not ported yet: set "
            "tune_partition_count_limit = 1")
    for flag in (Flags.USE_ALPHA_WEIGHT, Flags.MAP_RGBM):
        if cfg.flags & flag:
            raise NotImplementedError(f"{flag.name} is not ported yet")
    if cfg.block_z > 1:
        raise NotImplementedError("3D block encoding is not ported yet")
    if int(getattr(cfg, "a_scale_radius", 0)) != 0:
        raise NotImplementedError("alpha-scale RDO is not ported yet")


def stage1_1plane(ctx, texels, use_kernels: bool = True):
    """Block state, constant detection and the 1-partition 1-plane passes
    (compress.py:290-411). Returns (scb, aux); aux holds what finalize and
    the 2-plane guard read."""
    cfg = ctx.config
    et = ctx.encoder_tables()
    profile = int(cfg.profile)
    u8_mask = (profile == int(Profile.LDR_SRGB)
               or bool(cfg.flags & Flags.USE_DECODE_UNORM8))
    dev = texels.device
    N, T, _ = texels.shape
    st = make_block_state(texels, profile)
    is_const = (st["data_min"] == st["data_max"]).all(1)
    const_color = torch.floor(torch.clamp(texels[:, 0] / 65535.0, 0.0, 1.0)
                              * 65535.0 + 0.5).to(torch.int32)

    cw = trial.effective_cw(cfg)
    ews = float(sum(cw)) * T
    l_scale = torch.where(st["is_luminance"], 1.0 / 1.5, 1.0)
    la_scale = torch.where(st["is_luminancealpha"], 1.0 / 1.05, 1.0)
    error_threshold = cfg.tune_db_limit * ews * l_scale * la_scale
    overshoot = 1.0 / cfg.tune_mse_overshoot

    scb = trial.empty_scb(N, T, dev)
    scb["finished"] = is_const
    pindex = torch.zeros((N,), dtype=torch.int32, device=dev)
    start_trial = 1
    if (cfg.tune_search_mode0_enable >= TUNE_MIN_SEARCH_MODE0
            and ctx.bsd.dim[2] == 1):
        start_trial = 0
    errorval_mult = (overshoot, 1.0)
    # Both passes search the full weight-quant range. The reference also
    # records each winner's weight quant and the best error here, which
    # only the later stages (not ported yet) read.
    full_limit = torch.full((N,), trial.QUANT_32, dtype=torch.int32,
                            device=dev)
    for i in range(start_trial, 2):
        thr1 = error_threshold * errorval_mult[i] * overshoot
        recs = trial.trial1_records(st, ctx.pass_tables(i == 0), cfg,
                                    profile, u8_mask, full_limit,
                                    ~scb["finished"], use_kernels=use_kernels)
        scb, errv = trial.apply_records_1plane(scb, recs, thr1, 1, pindex)
        scb["finished"] = scb["finished"] | (
            errv < error_threshold * errorval_mult[i])

    if et.m2_quant.shape[0] > 0:
        skip2p = (_lowest_correlation(texels, cw)
                  > cfg.tune_2plane_early_out_limit_correlation)
    else:
        skip2p = torch.ones((N,), dtype=torch.bool, device=dev)
    aux = {"is_const": is_const, "const_color": const_color,
           "skip2p": skip2p}
    return scb, aux


def finalize_pack(dt, et, scb, aux):
    """Fallback/constant-block selection + physical pack
    (compress.py:622-646), LDR profiles."""
    is_const = aux["is_const"]
    scb = dict(scb)
    fallback = scb["block_type_error"] & ~is_const
    scb["const_u16"] = is_const | fallback
    scb["const_f16"] = torch.zeros_like(is_const)
    scb["constant_color"] = aux["const_color"]
    err_lane = scb["block_type_error"]
    scb["block_mode"] = torch.where(err_lane, int(et.m1_mode_index[0]),
                                    scb["block_mode"])
    scb["quant_mode"] = torch.where(err_lane, 4, scb["quant_mode"])
    scb["partition_count"] = torch.where(err_lane, 1,
                                         scb["partition_count"])
    return physical.symbolic_to_physical_batch(dt, scb)


def compress_blocks(ctx, texels, use_kernels: bool = True):
    """Compress one chunk of (N, T, 4) float32 texels on ctx.device to
    (N, 16) uint8 blocks."""
    scb, aux = stage1_1plane(ctx, texels, use_kernels=use_kernels)
    eligible = ~scb["finished"] & ~aux["skip2p"]
    if bool(eligible.any()):
        raise NotImplementedError(
            f"{int(eligible.sum())} blocks are eligible for the 2-plane "
            "stage, which is not ported yet (set "
            "tune_2plane_early_out_limit_correlation = 0)")
    return finalize_pack(ctx.torch_decode_tables(), ctx.encoder_tables(),
                         scb, aux)


def blockify(data: np.ndarray, block_dims) -> np.ndarray:
    """(Z, H, W, 4) float32 -> (N, T, 4) edge-clamped blocks in raster
    order (compress.py:1068-1075)."""
    bx, by, bz = block_dims
    Z, H, W, _ = data.shape
    nx, ny, nz = -(-W // bx), -(-H // by), -(-Z // bz)
    idx_x = np.minimum(np.arange(nx * bx), W - 1)
    idx_y = np.minimum(np.arange(ny * by), H - 1)
    idx_z = np.minimum(np.arange(nz * bz), Z - 1)
    padded = data[np.ix_(idx_z, idx_y, idx_x)]
    blocks = padded.reshape(nz, bz, ny, by, nx, bx, 4)
    return np.ascontiguousarray(blocks.transpose(0, 2, 4, 1, 3, 5, 6).reshape(
        nz * ny * nx, bz * by * bx, 4))


def _encode_unorm_sanitized(f: np.ndarray) -> np.ndarray:
    """Unorm-encode float input to [0, 65535]; NaN maps to 0."""
    return np.fmin(np.fmax(f * 65535.0, 0.0), 65535.0)


def _apply_load_swizzle(image, swizzle):
    if tuple(swizzle) == (0, 1, 2, 3):
        return image
    one = 255 if image.dtype == np.uint8 else 1.0
    chans = {0: image[..., 0], 1: image[..., 1], 2: image[..., 2],
             3: image[..., 3], 4: np.zeros_like(image[..., 0]),
             5: np.full_like(image[..., 0], one)}
    return np.stack([chans[s] for s in swizzle], axis=-1)


def image_to_blocks(ctx, image, swizzle=(0, 1, 2, 3)) -> np.ndarray:
    """Host side of compress_image: channel fill, swizzle, UNORM16 scale,
    blockify. Returns (N, T, 4) float32."""
    image = np.asarray(image)
    if image.ndim == 3:
        image = image[None]
    C = image.shape[-1]
    if C < 4:
        pad = np.zeros(image.shape[:-1] + (4 - C,), image.dtype)
        if C == 3:
            pad[...] = 255 if image.dtype == np.uint8 else 1.0
        image = np.concatenate([image, pad], axis=-1)
    image = _apply_load_swizzle(image, swizzle)
    if image.dtype == np.uint8:
        data = image.astype(np.float32) * (65535.0 / 255.0)
    else:
        data = _encode_unorm_sanitized(image.astype(np.float32))
    return blockify(data.astype(np.float32), ctx.block_dims)


def compress_image(ctx, image, swizzle=(0, 1, 2, 3), progress_callback=None,
                   use_kernels: bool = True):
    """Compress an image array to (N, 16) uint8 blocks in raster order.

    ``use_kernels=False`` runs the plain PyTorch versions of the kernels on
    any device (for comparison on the card); the public API never sets it.
    """
    check_supported(ctx.config)
    blocks = image_to_blocks(ctx, image, swizzle)
    n = blocks.shape[0]
    outs = []
    for lo in range(0, n, CHUNK):
        tex = torch.from_numpy(blocks[lo:lo + CHUNK]).to(ctx.device)
        outs.append(compress_blocks(ctx, tex, use_kernels=use_kernels).cpu())
        if progress_callback is not None:
            progress_callback(min(100.0, 100.0 * min(lo + CHUNK, n) / n))
    return torch.cat(outs).numpy()
