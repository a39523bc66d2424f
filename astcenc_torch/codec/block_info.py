"""Single-block introspection (host-side).

The batched analog of astcenc_get_block_info (reference:
astcenc_entry.cpp:1401-1517): parses one physical block into the flat
metadata record used by diagnostic tooling (-dimage style debug output).
Host NumPy, reusing the table layer's ISE codec.

Port of ``astcenc_tpu/codec/block_info.py``: the same parse, with the
decoded float endpoints taken by the port's ``ops/color_unquant.py`` and
``ops/softfloat.py`` on CPU tensors. The dict, its keys, types and values
equal the JAX package's (tests/test_torch_api.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import color_unquant as cuq
from ..ops import softfloat as sf
from ..tables import ise, quant


def _read_bits(data: np.ndarray, off: int, n: int) -> int:
    v = 0
    for b in range(n):
        bit = (int(data[(off + b) >> 3]) >> ((off + b) & 7)) & 1
        v |= bit << b
    return v


def get_block_info(ctx, pcb: np.ndarray) -> dict:
    """Parse one 16-byte physical block into decode metadata."""
    bsd = ctx.bsd
    pcb = np.asarray(pcb, np.uint8).reshape(16)

    info = {
        "block_is_error": False,
        "block_is_constant": False,
        "block_is_hdr": False,
        "block_is_dual_plane": False,
        "partition_count": 0,
        "partition_index": 0,
        "dual_plane_component": -1,
        "color_endpoint_modes": [],
        "color_quant_level": None,
        "weight_quant_level": None,
        "weight_x": 0, "weight_y": 0, "weight_z": 0,
        "weight_values_plane1": None,
        "weight_values_plane2": None,
        "partition_assignment": None,
    }

    block_mode = _read_bits(pcb, 0, 11)
    if (block_mode & 0x1FF) == 0x1FC:
        info["block_is_constant"] = True
        info["block_is_hdr"] = bool(block_mode & 0x200)
        info["constant_color"] = [
            int(pcb[8 + 2 * i]) | (int(pcb[9 + 2 * i]) << 8)
            for i in range(4)]
        return info

    pk = int(bsd.block_mode_packed_index[block_mode])
    if pk == 0xFFFF:
        info["block_is_error"] = True
        return info

    wq = int(bsd.bm_quant_mode[pk])
    dual = bool(bsd.bm_is_dual_plane[pk])
    dm = int(bsd.bm_decimation_mode[pk])
    wdims = bsd.dm_weight_dims[dm]
    wcount = int(bsd.dm_weight_count[dm])
    real_count = wcount * (2 if dual else 1)

    pc = _read_bits(pcb, 11, 2) + 1

    info.update(block_is_dual_plane=dual, partition_count=pc,
                weight_quant_level=ise.QUANT_LEVELS[wq],
                weight_x=int(wdims[0]), weight_y=int(wdims[1]),
                weight_z=int(wdims[2]))

    # Weight stream (bit-reversed at the top of the block)
    bits = np.unpackbits(pcb[::-1])  # already reversed byte+bit order
    rev = np.packbits(bits).tobytes()
    wsyms = ise.decode_ise(wq, real_count, np.frombuffer(rev, np.uint8))
    uuq = quant.weight_quant_tables(wq)["unscramble_unquant"]
    w = uuq[np.asarray(wsyms)]
    if dual:
        info["weight_values_plane1"] = w[0::2].tolist()
        info["weight_values_plane2"] = w[1::2].tolist()
    else:
        info["weight_values_plane1"] = w.tolist()

    wbits = int(bsd.bm_weight_bits[pk])

    # ---- Color endpoint modes (reference: symbolic_physical.cpp:380-460)
    if pc > 1:
        pidx = _read_bits(pcb, 13, 10)
        info["partition_index"] = pidx
        parts = bsd.partitionings[pc]
        row = int(parts["packed_index"][pidx])
        if row != 0xFFFF:
            info["partition_assignment"] = (
                parts["partition_of_texel"][row].tolist())
        ehs = 3 * pc - 4
        below = 128 - wbits - ehs
        encoded_type = (_read_bits(pcb, 23, 6)
                        | (_read_bits(pcb, below, ehs) << 6))
        baseclass = encoded_type & 0x3
        if baseclass == 0:
            fmts = [(encoded_type >> 2) & 0xF] * pc
            ehs = 0
        else:
            bclass = baseclass - 1
            fmts = []
            for p in range(pc):
                hi2 = ((encoded_type >> (2 + p)) & 1) + bclass
                lo2 = (encoded_type >> (2 + pc + 2 * p)) & 3
                fmts.append((hi2 << 2) | lo2)
        base_off = 29
    else:
        fmts = [_read_bits(pcb, 13, 4)]
        ehs = 0
        base_off = 17
    info["color_endpoint_modes"] = fmts
    info["partition_assignment"] = (info["partition_assignment"]
                                    or [0] * bsd.texel_count)

    # ---- Color quant level + values (reference: entry.cpp:1445-1516)
    icount = sum(((f >> 2) + 1) * 2 for f in fmts)
    color_bits_arr = [0, 111, 99, 99, 99]
    color_bits = color_bits_arr[pc] - wbits - ehs - (2 if dual else 0)
    color_bits = max(0, min(127, color_bits))
    cquant = int(quant.quant_mode_table()[min(icount >> 1, 9), color_bits])
    info["color_quant_level"] = (ise.QUANT_LEVELS[cquant]
                                 if cquant >= 0 else 0)

    if dual:
        info["dual_plane_component"] = _read_bits(
            pcb, 128 - wbits - ehs - 2, 2)

    if cquant >= 4 and icount <= 18:
        csyms = ise.decode_ise(cquant, icount, pcb, bit_offset=base_off)
        s2v = quant.color_quant_tables(cquant)["scrambled_pquant_to_uquant"]
        cvals = [int(s2v[s]) for s in csyms]
        color_values = []
        pos = 0
        for f in fmts:
            n = ((f >> 2) + 1) * 2
            color_values.append(cvals[pos:pos + n] + [0] * (8 - n))
            pos += n
        info["color_values"] = [cv[:((fmts[i] >> 2) + 1) * 2]
                                for i, cv in enumerate(color_values)]

        # Decoded float endpoints per partition (reference: :1466-1494)
        fmt_a = torch.tensor([fmts + [0] * (4 - pc)], dtype=torch.int32)
        val_a = torch.tensor([color_values + [[0] * 8] * (4 - pc)],
                             dtype=torch.int32)
        profile = int(ctx.config.profile)
        ep0, ep1, rgb_hdr, a_hdr = cuq.unpack_color_endpoints(
            profile, fmt_a, val_a)
        hdr_mask = torch.stack([rgb_hdr, rgb_hdr, rgb_hdr, a_hdr], -1)
        eps = []
        for ep in (ep0, ep1):
            f16 = torch.where(hdr_mask, sf.lns_to_sf16(ep),
                              sf.unorm16_to_sf16(ep))
            eps.append(sf.float16_to_float(f16).numpy()[0])
        info["color_endpoints"] = [
            [eps[0][p].tolist(), eps[1][p].tolist()] for p in range(pc)]
        info["block_is_hdr"] = bool(rgb_hdr[0, :pc].any()
                                    or a_hdr[0, :pc].any())

    return info
