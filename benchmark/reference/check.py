"""The comparison that decides a run's ``correct``.

The plain reference judges each answer the window produced, one texture's
blocks, by what it says: it decodes the blocks with the frozen decoder of
``reference/astc`` under the configuration's profile and measures the
decoded texture against the source texture that the benchmark made. It
imports nothing of the program and takes nothing the program made but the
blocks it judges.

For each distinct answer it reads:

- the blocks that are illegal under the profile: reserved or malformed
  encodings (the decoder's error colour) and, under an LDR profile, blocks
  with an HDR endpoint format;
- the texture's error in the domain of astcenc's own metric (LDR: RGBA
  over 0..1 from the 8-bit decode; HDR: RGBA tone-mapped at the f-stops
  -10..+10, as mPSNR does), summed per block, beside the error of the
  block's constant colour (its mean, as a void-extent block would store
  it). ``texture_err_ratio`` is the texture's error over its
  constant-colour error; ``block_err_ratio`` is the same for the worst
  block, with one 8-bit level of error per texel and channel added below
  the line so that smooth blocks do not divide by nearly nothing.

``psnr`` and ``mpsnr`` are astcenc's "PSNR (LDR-RGBA)" and "mPSNR (RGB)"
(its CLI's ``compute_error_metrics`` with four input components),
computed on the device from the same sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .astc import color_unquant as cuq
from .astc import decode as dec
from .astc import tables

PROFILES = {"LDR_SRGB": 0, "LDR": 1, "HDR_RGB_LDR_A": 2, "HDR": 3}
FSTOPS = range(-10, 11)
_F16_MAX = 65504.0


def _block_sums(x: torch.Tensor, bx: int, by: int) -> torch.Tensor:
    """(h, w) per-texel values -> (ny, nx) sums over each bx x by block;
    texels past the image's edge count as zero."""
    h, w = x.shape
    ny, nx = -(-h // by), -(-w // bx)
    pad = torch.zeros((ny * by, nx * bx), dtype=x.dtype, device=x.device)
    pad[:h, :w] = x
    return pad.reshape(ny, by, nx, bx).sum((1, 3))


def _block_mean(x: torch.Tensor, bx: int, by: int) -> torch.Tensor:
    """(h, w, C) -> the same shape, each texel replaced by its block's
    mean over the block's texels inside the image."""
    h, w, c = x.shape
    count = _block_sums(torch.ones((h, w), dtype=x.dtype, device=x.device),
                        bx, by)
    means = torch.stack([_block_sums(x[..., i], bx, by) for i in range(c)],
                        -1) / count[..., None]
    full = means.repeat_interleave(by, 0).repeat_interleave(bx, 1)
    return full[:h, :w]


def _tonemap(x: torch.Tensor, fstop: int) -> torch.Tensor:
    """astcenc's mPSNR operator: the value at ``fstop``, to the power
    1/2.2, over 0..255."""
    v = torch.pow(torch.clamp(x * (2.0 ** fstop), min=0.0), 1.0 / 2.2)
    return torch.clamp(v * 255.0, 0.0, 255.0)


class Reference:
    """The reference for one configuration (its profile and block size)
    on ``device``."""

    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        self.profile = PROFILES[config["profile"]]
        self.bx, self.by = int(config["block"][0]), int(config["block"][1])
        if len(config["block"]) > 2 and int(config["block"][2]) != 1:
            raise ValueError("the reference decodes 2D blocks only")
        self.hdr = self.profile >= PROFILES["HDR_RGB_LDR_A"]
        self.tables = tables.to_device(tables.build(self.bx, self.by),
                                       self.device)

    def decode(self, blocks: np.ndarray, height: int, width: int):
        """Decode raster-order blocks to an (h, w, 4) float64 texture (LDR:
        the 8-bit decode over 255, the error colour magenta; HDR: linear,
        NaN at error texels), and count the illegal blocks."""
        pcb = torch.from_numpy(np.ascontiguousarray(blocks, np.uint8)
                               ).to(self.device)
        u8 = not self.hdr
        tex = dec.decompress_symbolic_batch(self.tables, pcb, self.profile,
                                            u8)
        bad = torch.isnan(tex).any(2).any(1)
        if not self.hdr:
            fmt = dec.endpoint_formats(self.tables, pcb)
            bad = bad | cuq.is_format(fmt, cuq.HDR_FORMATS).any(1)
        illegal = int(bad.sum())
        ny, nx = -(-height // self.by), -(-width // self.bx)
        if pcb.shape[0] != ny * nx:
            raise ValueError(f"expected {ny * nx} blocks, got {pcb.shape[0]}")
        img = tex.reshape(ny, nx, self.by, self.bx, 4).permute(
            0, 2, 1, 3, 4).reshape(ny * self.by, nx * self.bx, 4)
        img = img[:height, :width]
        if u8:
            # The 8-bit decode (the magenta error colour at error texels),
            # read back over 255 in float32 as astcenc's metrics read it.
            nan = torch.isnan(img[..., :1])
            q = torch.floor(torch.nan_to_num(img.clamp(0.0, 1.0)) * 255.0
                            + 0.5)
            magenta = torch.tensor([255.0, 0.0, 255.0, 255.0],
                                   dtype=torch.float32, device=self.device)
            img = torch.where(nan, magenta, q) / 255.0
        return img.to(torch.float64), illegal

    def source(self, image: np.ndarray) -> torch.Tensor:
        """The source texture in the metric's domain: uint8 over 255 (in
        float32, as astcenc's metrics read it), or float clamped to the
        float16 range."""
        src = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        if src.dtype == torch.uint8:
            return (src.to(torch.float32) / 255.0).to(torch.float64)
        return src.to(torch.float64).clamp(0.0, _F16_MAX)

    def errors(self, src: torch.Tensor, img: torch.Tensor) -> dict:
        """The per-block error sums of a decoded texture against its source
        and the readings built from them."""
        h, w, _ = src.shape
        bx, by = self.bx, self.by
        pixels = float(h * w)
        if not self.hdr:
            # One 8-bit level of error per texel and channel.
            unit = 4.0 / 255.0 ** 2
            e = ((img - src) ** 2).sum(-1)
            dc = ((_block_mean(src, bx, by) - src) ** 2).sum(-1)
        else:
            img = torch.nan_to_num(img, nan=0.0).clamp(0.0, _F16_MAX)
            mean = _block_mean(src, bx, by)
            e = torch.zeros((h, w), dtype=torch.float64, device=self.device)
            dc = torch.zeros_like(e)
            for f in FSTOPS:
                t = _tonemap(src, f)
                e += ((_tonemap(img, f) - t) ** 2).sum(-1)
                dc += ((_tonemap(mean, f) - t) ** 2).sum(-1)
            unit = 4.0 * len(FSTOPS)
        eb = _block_sums(e, bx, by)
        db = _block_sums(dc, bx, by)
        nb = _block_sums(torch.ones_like(e), bx, by)
        err, base = float(eb.sum()), float(db.sum())
        out = {
            "texture_err_ratio": err / base if base > 0 else math.inf,
            "block_err_ratio": float((eb / (db + unit * nb)).max()),
        }
        if self.hdr:
            num = pixels * 3.0 * len(FSTOPS) * 255.0 ** 2
            out["mpsnr"] = 999.0 if err == 0 else 10.0 * math.log10(num / err)
        else:
            out["psnr"] = (999.0 if err == 0
                           else 10.0 * math.log10(pixels * 4.0 / err))
        return out


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, lines): each number compared beside its limit; a number
    fails when it is above its limit, or is not a number."""
    ok = True
    checks = {}
    for name, limit in limits.items():
        value = readings.get(name)
        good = (value is not None and not math.isnan(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
