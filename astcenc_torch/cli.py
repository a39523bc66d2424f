"""astcenc-compatible command line front-end.

Accepts the reference CLI's mode/flag grammar
(reference: Source/astcenccli_toplevel.cpp:121-138, 464-1227) so the
reference's functional test recipes port directly:

    python -m astcenc_torch -cl in.ktx out.astc 6x6 -medium
    python -m astcenc_torch -dl in.astc out.ktx
    python -m astcenc_torch -tl in.ktx out.exr 6x6 -fast -repeats 3

The port's copy of ``astcenc_tpu/cli.py``. The grammar has no device flag:
the codec runs on the card, and ``main(argv, device="cpu")`` runs it on the
CPU. PNG, TGA, BMP and JPEG files go through Pillow where it is installed;
.ktx, .dds, .exr and .hdr need only NumPy.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import api
from .config import Flags, Profile, Quality
from .io import astc_file, dds, image_io, ktx
from .utils import metrics

_MODES = {
    # operation: c=compress d=decompress t=test(roundtrip); profile suffix
    "-cl": ("c", Profile.LDR), "-cs": ("c", Profile.LDR_SRGB),
    "-ch": ("c", Profile.HDR_RGB_LDR_A), "-cH": ("c", Profile.HDR),
    "-dl": ("d", Profile.LDR), "-ds": ("d", Profile.LDR_SRGB),
    "-dh": ("d", Profile.HDR_RGB_LDR_A), "-dH": ("d", Profile.HDR),
    "-tl": ("t", Profile.LDR), "-ts": ("t", Profile.LDR_SRGB),
    "-th": ("t", Profile.HDR_RGB_LDR_A), "-tH": ("t", Profile.HDR),
}

_PRESETS = {
    "-fastest": Quality.FASTEST, "-fast": Quality.FAST,
    "-medium": Quality.MEDIUM, "-thorough": Quality.THOROUGH,
    "-verythorough": Quality.VERYTHOROUGH, "-exhaustive": Quality.EXHAUSTIVE,
}

_SWZ = {"r": 0, "g": 1, "b": 2, "a": 3, "0": 4, "1": 5, "z": 6}


class CliError(SystemExit):
    def __init__(self, msg):
        print(f"ERROR: {msg}", file=sys.stderr)
        super().__init__(1)


def _parse_block(s: str):
    parts = s.lower().split("x")
    if len(parts) == 2:
        return int(parts[0]), int(parts[1]), 1
    if len(parts) == 3:
        return int(parts[0]), int(parts[1]), int(parts[2])
    raise CliError(f"invalid block size {s}")


def _parse_swizzle(s: str):
    if len(s) != 4 or any(c not in _SWZ for c in s):
        raise CliError(f"invalid swizzle {s}")
    return tuple(_SWZ[c] for c in s)


def main(argv=None, *, device="cuda"):
    """Run one CLI command; ``device`` is the torch device of the codec
    (the card unless the caller asks for the CPU)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "-help", "--help"):
        _usage()
        return 0
    if argv[0] in ("-v", "-version", "--version"):
        from . import __version__
        print(f"astcenc-torch v{__version__}")
        return 0

    mode = argv[0]
    if mode not in _MODES:
        raise CliError(f"unknown operation {mode}")
    op, profile = _MODES[mode]

    if len(argv) < 3:
        raise CliError("missing input/output paths")
    in_path, out_path = argv[1], argv[2]
    rest = argv[3:]

    opts = _parse_options(rest, need_block=op in ("c", "t"))

    try:
        if op == "d":
            return _do_decompress(profile, in_path, out_path, opts, device)
        if op == "c":
            return _do_compress(profile, in_path, out_path, opts, device)
        return _do_roundtrip(profile, in_path, out_path, opts, device)
    except (ValueError, OSError, NotImplementedError) as e:
        # IO/format failures print as clean errors like the reference CLI
        # (astcenccli_toplevel.cpp error paths), not tracebacks.
        raise CliError(str(e))


def _parse_options(rest, need_block):
    opts = {
        "block": None, "quality": None, "flags": 0, "swz_encode": (0, 1, 2, 3),
        "swz_decode": (0, 1, 2, 3), "silent": False, "yflip": False,
        "jobs": 0, "repeats": 1, "overrides": {}, "dblimit": None,
        "a_radius": 0, "dtrace": None, "dimage": None, "zdim": 1,
        "mpsnr": (-10, 10), "preprocess": None,
    }
    i = 0
    if need_block:
        if not rest or rest[0].startswith("-"):
            raise CliError("missing block size")
        opts["block"] = _parse_block(rest[0])
        if not rest[1:] or rest[1] not in _PRESETS:
            raise CliError("missing quality preset")
        opts["quality"] = _PRESETS[rest[1]]
        i = 2

    ov = opts["overrides"]
    while i < len(rest):
        a = rest[i]

        def arg(n=1):
            nonlocal i
            if i + n >= len(rest) + 0 and i + n > len(rest) - 1 + 1:
                pass
            if i + n > len(rest) - 1:
                raise CliError(f"{a} requires an argument")
            return rest[i + n]

        if a == "-silent":
            opts["silent"] = True
        elif a == "-yflip":
            opts["yflip"] = True
        elif a == "-j":
            opts["jobs"] = int(arg()); i += 1
        elif a == "-repeats":
            opts["repeats"] = int(arg()); i += 1
        elif a == "-normal":
            opts["flags"] |= Flags.MAP_NORMAL
            opts["swz_encode"] = (0, 0, 0, 1)  # rrrg
            opts["swz_decode"] = (0, 3, 6, 5)  # raz1
        elif a == "-rgbm":
            opts["flags"] |= Flags.MAP_RGBM
            ov["rgbm_m_scale"] = float(arg()); i += 1
        elif a == "-perceptual":
            opts["flags"] |= Flags.USE_PERCEPTUAL
        elif a in ("-pp-normalize", "-pp-premultiply"):
            # Image preprocess passes (reference:
            # astcenccli_toplevel.cpp:626-649): at most one may be used.
            if opts["preprocess"] is not None:
                raise CliError("Only a single image preprocess can be used")
            opts["preprocess"] = a[4:]
        elif a == "-decode_unorm8":
            opts["flags"] |= Flags.USE_DECODE_UNORM8
        elif a == "-esw":
            opts["swz_encode"] = _parse_swizzle(arg()); i += 1
        elif a == "-dsw":
            opts["swz_decode"] = _parse_swizzle(arg()); i += 1
        elif a == "-ssw":
            # Error-significance weighting: cw_X = 1 if channel named,
            # else 0 (reference: astcenccli_toplevel.cpp:792-843).
            pat = arg()
            if not pat or len(pat) > 4 or any(c not in "rgba" for c in pat):
                raise CliError(f"-ssw pattern '{pat}' is not valid")
            for c, k in (("r", "cw_r_weight"), ("g", "cw_g_weight"),
                         ("b", "cw_b_weight"), ("a", "cw_a_weight")):
                ov[k] = 1.0 if c in pat else 0.0
            i += 1
        elif a == "-cw":
            ov["cw_r_weight"] = float(arg(1))
            ov["cw_g_weight"] = float(arg(2))
            ov["cw_b_weight"] = float(arg(3))
            ov["cw_a_weight"] = float(arg(4))
            i += 4
        elif a == "-a":
            opts["a_radius"] = int(arg())
            opts["flags"] |= Flags.USE_ALPHA_WEIGHT
            i += 1
        elif a == "-blockmodelimit":
            ov["tune_block_mode_limit"] = int(arg()); i += 1
        elif a == "-partitioncountlimit":
            ov["tune_partition_count_limit"] = int(arg()); i += 1
        elif a == "-2partitionindexlimit":
            ov["tune_2partition_index_limit"] = int(arg()); i += 1
        elif a == "-3partitionindexlimit":
            ov["tune_3partition_index_limit"] = int(arg()); i += 1
        elif a == "-4partitionindexlimit":
            ov["tune_4partition_index_limit"] = int(arg()); i += 1
        elif a == "-2partitioncandidatelimit":
            ov["tune_2partitioning_candidate_limit"] = int(arg()); i += 1
        elif a == "-3partitioncandidatelimit":
            ov["tune_3partitioning_candidate_limit"] = int(arg()); i += 1
        elif a == "-4partitioncandidatelimit":
            ov["tune_4partitioning_candidate_limit"] = int(arg()); i += 1
        elif a == "-2partitionlimitfactor":
            ov["tune_2partition_early_out_limit_factor"] = float(arg()); i += 1
        elif a == "-3partitionlimitfactor":
            ov["tune_3partition_early_out_limit_factor"] = float(arg()); i += 1
        elif a == "-2planelimitcorrelation":
            ov["tune_2plane_early_out_limit_correlation"] = float(arg()); i += 1
        elif a == "-refinementlimit":
            ov["tune_refinement_limit"] = int(arg()); i += 1
        elif a == "-candidatelimit":
            ov["tune_candidate_limit"] = int(arg()); i += 1
        elif a == "-dblimit":
            opts["dblimit"] = float(arg()); i += 1
        elif a == "-dtrace":
            opts["dtrace"] = arg(); i += 1
        elif a == "-dimage":
            # Boolean in the reference CLI (astcenccli_toplevel.cpp:1195);
            # output names derive from the compressed file's stem.
            opts["dimage"] = True
        elif a == "-zdim":
            opts["zdim"] = int(arg())
            if opts["zdim"] < 1:
                raise CliError(f"-zdim size '{arg()}' is invalid")
            i += 1
        elif a == "-mpsnr":
            opts["mpsnr"] = (int(arg(1)), int(arg(2))); i += 2
        else:
            raise CliError(f"unknown option {a}")
        i += 1
    return opts


def _make_context(profile, block, quality, opts, device="cuda"):
    if opts.get("zdim", 1) > 1 and block[2] == 1:
        raise CliError("-zdim with 3D input data for a 2D output format")
    cfg = api.config_init(profile, block[0], block[1], block[2],
                          quality, opts["flags"])
    for k, v in opts["overrides"].items():
        setattr(cfg, k, v)
    if opts["dblimit"] is not None and profile in (Profile.LDR,
                                                   Profile.LDR_SRGB):
        cfg.tune_db_limit = opts["dblimit"]
    cfg.a_scale_radius = opts["a_radius"]
    return api.context_alloc(cfg, device=device)


def _load_for_encode(path, opts):
    zdim = opts.get("zdim", 1)
    if zdim > 1:
        # 3D array input: slices named base_<i>.ext
        # (reference: astcenccli_toplevel.cpp:300-460 load_uncomp_file).
        base, ext = os.path.splitext(path)
        if not ext:
            raise CliError(
                f"Image pattern does not contain file extension: {path}")
        slices = []
        is_hdr = ncomp = None
        for zi in range(zdim):
            d, h, c = image_io.load_image(f"{base}_{zi}{ext}")
            if opts["yflip"]:
                d = d[::-1]
            if zi == 0:
                is_hdr, ncomp = h, c
            elif (h, c) != (is_hdr, ncomp):
                raise CliError(f"Image array[0] and [{zi}] are different"
                               " formats")
            elif d.shape != slices[0].shape:
                raise CliError(f"Image array[0] and [{zi}] are different"
                               " dimensions")
            slices.append(d)
        return np.stack(slices, axis=0), is_hdr, ncomp
    data, is_hdr, ncomp = image_io.load_image(path)
    if opts["yflip"]:
        data = data[::-1]
    return data, is_hdr, ncomp


def _srgb_to_linear(a):
    """Per-component sRGB EOTF (reference: astcenccli_toplevel.cpp:1459)."""
    return np.where(a <= 0.04045, a * (1.0 / 12.92),
                    np.power(np.maximum((a + 0.055) * (1.0 / 1.055), 0.0),
                             2.4)).astype(np.float32)


def _linear_to_srgb(a):
    """Per-component sRGB OETF (reference: astcenccli_toplevel.cpp:1477)."""
    return np.where(a <= 0.0031308, a * 12.92,
                    1.055 * np.power(np.maximum(a, 0.0), 1.0 / 2.4)
                    - 0.055).astype(np.float32)


def _apply_preprocess(data, kind, profile):
    """Image preprocess passes: -pp-normalize re-normalizes RGB as a unit
    vector; -pp-premultiply multiplies RGB by alpha in linear space
    (reference: image_preprocess_normalize / image_preprocess_premultiply,
    astcenccli_toplevel.cpp:1418-1540). Returns float32 data in [0, 1]
    (the reference always emits an F32 image here)."""
    f = (data.astype(np.float32) / 255.0 if data.dtype == np.uint8
         else data.astype(np.float32))
    if f.shape[-1] < 4:
        pad = np.ones(f.shape[:-1] + (4 - f.shape[-1],), np.float32)
        if f.shape[-1] < 3:
            pad[..., :3 - f.shape[-1]] = 0.0
        f = np.concatenate([f, pad], axis=-1)
    if kind == "normalize":
        v = f[..., :3] * 2.0 - 1.0
        norm = np.sqrt(np.sum(v * v, axis=-1, keepdims=True))
        v = v / norm                      # zero vectors -> NaN, clamped later
        f = np.concatenate([(v + 1.0) * 0.5, f[..., 3:4]], axis=-1)
    else:  # premultiply
        rgb = f[..., :3]
        if profile == Profile.LDR_SRGB:
            rgb = _linear_to_srgb(_srgb_to_linear(rgb) * f[..., 3:4])
        else:
            rgb = rgb * f[..., 3:4]
        f = np.concatenate([rgb, f[..., 3:4]], axis=-1)
    return f


def _compress_repeat(ctx, data, opts, tracer=None):
    """Compress with -repeats timing semantics: best-of-N coding time
    (reference: astcenccli_toplevel.cpp:2185-2218)."""
    best = float("inf")
    blocks = None
    for _ in range(max(1, opts["repeats"])):
        t0 = time.perf_counter()
        blocks = api.compress_image(ctx, data, opts["swz_encode"],
                                    tracer=tracer)
        api.compress_reset(ctx)
        best = min(best, time.perf_counter() - t0)
        tracer = None          # capture only the first iteration
    return blocks, best


def _print_performance(n_texels, coding_time, decode_time=None,
                       total_time=None):
    """Reference "Performance metrics" block
    (astcenccli_toplevel.cpp:2351-2378)."""
    print("Performance metrics")
    print("===================\n")
    if total_time is not None:
        print(f"    Total time:                {total_time:8.4f} s")
    if coding_time is not None:
        rate = n_texels / (max(coding_time, 1e-9) * 1e6)
        print(f"    Coding time:               {coding_time:8.4f} s")
        print(f"    Coding rate:               {rate:8.4f} MT/s")
    if decode_time is not None:
        rate = n_texels / (max(decode_time, 1e-9) * 1e6)
        print(f"    Decoding time:             {decode_time:8.4f} s")
        print(f"    Decoding rate:             {rate:8.4f} MT/s")


def _do_compress(profile, in_path, out_path, opts, device="cuda"):
    tstart = time.perf_counter()
    data, _, _ = _load_for_encode(in_path, opts)
    if opts.get("preprocess"):
        data = _apply_preprocess(data, opts["preprocess"], profile)
    ctx = _make_context(profile, opts["block"], opts["quality"], opts,
                        device)
    tracer = None
    if opts.get("dtrace"):
        from .codec.trace import Tracer
        tracer = Tracer()
    blocks, tcode = _compress_repeat(ctx, data, opts, tracer=tracer)
    if tracer is not None:
        tracer.write(opts["dtrace"])
    if data.ndim == 4:
        z, h, w = data.shape[:3]
    else:
        h, w = data.shape[:2]
        z = 1
    ext = os.path.splitext(out_path)[1].lower()
    if ext == ".ktx":
        ktx.write_ktx_compressed(out_path, ctx.block_dims, (w, h, z), blocks,
                                 srgb=(profile == Profile.LDR_SRGB))
    else:
        astc_file.write_astc(out_path, ctx.block_dims, (w, h, z), blocks)
    if opts.get("dimage"):
        _write_diagnostics(ctx, blocks, (w, h, z), opts,
                           os.path.splitext(out_path)[0])
    if not opts["silent"]:
        _print_performance(w * h * z, tcode,
                           total_time=time.perf_counter() - tstart)
    return 0


def _write_diagnostics(ctx, blocks, dims, opts, stem):
    """Emit the reference's per-block diagnostic image set
    (reference: print_diagnostic_images, astcenccli_toplevel.cpp:1581-1898):
    <stem>_diag_{partitioning, weight_plane2, weight_density, weight_quant,
    color_quant, cem_index, cem_components, cem_style, cem_hdr}.png.
    """
    from . import api as api_mod

    w, h, z = dims
    bx, by, bz = ctx.block_dims
    nx, ny = (w + bx - 1) // bx, (h + by - 1) // by
    infos = [api_mod.get_block_info(ctx, blocks[i])
             for i in range(min(len(blocks), nx * ny))]

    palette = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0],
                        [0, 0, 255], [255, 255, 255]], np.uint8)

    def emit(name, block_fn):
        img = np.zeros((ny * by, nx * bx, 3), np.uint8)
        for i, bi in enumerate(infos):
            byy, bxx = (i // nx) * by, (i % nx) * bx
            img[byy:byy + by, bxx:bxx + bx] = block_fn(bi)
        image_io.save_image(f"{stem}_diag_{name}.png", img[:h, :w], ncomp=3)

    def f_partition(bi):
        if bi["block_is_constant"] or bi.get("partition_assignment") is None:
            return palette[0]
        a = np.array(bi["partition_assignment"]).reshape(bz, by, bx)[0]
        return palette[a + 1]

    def f_plane2(bi):
        c = (bi["dual_plane_component"] + 1
             if bi["block_is_dual_plane"] else 0)
        return np.broadcast_to(palette[c], (by, bx, 3))

    def f_density(bi):
        d = 0.0
        if not bi["block_is_constant"]:
            d = (bi["weight_x"] * bi["weight_y"]) / float(bx * by)
        v = int(255.0 * d)
        return np.full((by, bx, 3), v, np.uint8)

    def f_wquant(bi):
        q = 0 if bi["block_is_constant"] else bi["weight_quant_level"] - 1
        return np.full((by, bx, 3), q, np.uint8)

    def f_cquant(bi):
        q = (0 if bi["block_is_constant"] or not bi.get("color_quant_level")
             else bi["color_quant_level"] - 1)
        return np.full((by, bx, 3), q, np.uint8)

    def f_cem(bi):
        if bi["block_is_constant"] or not bi["color_endpoint_modes"]:
            return np.zeros((by, bx, 3), np.uint8)
        a = (np.array(bi["partition_assignment"]).reshape(bz, by, bx)[0]
             if bi.get("partition_assignment") is not None
             else np.zeros((by, bx), np.int32))
        cems = np.asarray(bi["color_endpoint_modes"]
                          + [0] * (4 - len(bi["color_endpoint_modes"])))
        v = (cems[a] * 16).astype(np.uint8)
        return np.stack([v, v, v], axis=-1)

    def _cem_per_texel(bi, lut):
        """Per-texel value from each texel's partition's CEM via lut."""
        if bi["block_is_constant"] or not bi["color_endpoint_modes"]:
            return None
        a = (np.array(bi["partition_assignment"]).reshape(bz, by, bx)[0]
             if bi.get("partition_assignment") is not None
             else np.zeros((by, bx), np.int32))
        cems = np.asarray(bi["color_endpoint_modes"]
                          + [0] * (4 - len(bi["color_endpoint_modes"])))
        return lut[cems[a]]

    # CEM component count classes (astcenccli_toplevel.cpp:1736-1787)
    _ncomp_of_cem = np.array(
        [1, 1, 1, 1, 2, 2, 3, 3, 3, 3, 4, 3, 4, 4, 4, 4], np.int32)

    def f_cem_components(bi):
        cls = _cem_per_texel(bi, _ncomp_of_cem)
        if cls is None:
            return np.zeros((by, bx, 3), np.uint8)
        return palette[cls]

    # CEM style: 1=direct, 2=offset, 3=scale (:1789-1848)
    _style_of_cem = np.array(
        [1, 1, 1, 1, 1, 2, 3, 3, 1, 2, 3, 1, 1, 2, 1, 1], np.int32)

    def f_cem_style(bi):
        cls = _cem_per_texel(bi, _style_of_cem)
        if cls is None:
            return np.zeros((by, bx, 3), np.uint8)
        return palette[cls]

    # CEM LDR (128) vs HDR (155) endpoint classes (:1851-1889)
    _hdr_of_cem = np.array(
        [128, 128, 155, 155, 128, 128, 128, 155,
         128, 128, 128, 155, 128, 128, 155, 155], np.int32)

    def f_cem_hdr(bi):
        v = _cem_per_texel(bi, _hdr_of_cem)
        if v is None:
            return np.zeros((by, bx, 3), np.uint8)
        return np.stack([v, v, v], axis=-1).astype(np.uint8)

    emit("partitioning", f_partition)
    emit("weight_plane2", f_plane2)
    emit("weight_density", f_density)
    emit("weight_quant", f_wquant)
    emit("color_quant", f_cquant)
    emit("cem_index", f_cem)
    emit("cem_components", f_cem_components)
    emit("cem_style", f_cem_style)
    emit("cem_hdr", f_cem_hdr)


def _load_compressed(in_path):
    ext = os.path.splitext(in_path)[1].lower()
    if ext == ".ktx":
        kind, bd, idim, payload, _ = ktx.read_ktx(in_path)
        if kind != "astc":
            raise CliError("KTX file is not ASTC compressed")
        return bd, idim, payload
    return astc_file.read_astc(in_path)


def _save_decoded(out_path, data, out_type):
    ext = os.path.splitext(out_path)[1].lower()
    if ext == ".ktx":
        if out_type == "u8":
            ktx.write_ktx_uncompressed(out_path, data.astype(np.uint8))
        else:
            ktx.write_ktx_uncompressed(out_path, data.astype(np.float16))
    elif ext == ".dds":
        dds.write_dds(out_path, data if out_type == "u8"
                      else data.astype(np.float16))
    else:
        if data.ndim == 4:
            data = data[0]
        image_io.save_image(out_path, data)


def _do_decompress(profile, in_path, out_path, opts, device="cuda"):
    bd, idim, blocks = _load_compressed(in_path)
    ctx = api.context_alloc(api.config_init(
        profile, bd[0], bd[1], bd[2], Quality.MEDIUM,
        opts["flags"] | Flags.DECOMPRESS_ONLY), device=device)
    ext = os.path.splitext(out_path)[1].lower()
    ldr = profile in (Profile.LDR, Profile.LDR_SRGB)
    out_type = "u8" if (ldr or ext in (".png", ".tga", ".bmp", ".jpg",
                                       ".jpeg")) else "f32"
    img = api.decompress_image(ctx, blocks, idim[0], idim[1], idim[2],
                               out_type=out_type, swizzle=opts["swz_decode"])
    if opts["yflip"]:
        img = img[:, ::-1]
    if ext in (".ktx", ".dds"):
        _save_decoded(out_path, img, out_type)
    else:
        image_io.save_image(out_path, img[0] if out_type == "u8"
                            else img[0].astype(np.float32))
    return 0


def _do_roundtrip(profile, in_path, out_path, opts, device="cuda"):
    tstart = time.perf_counter()
    data, is_hdr, ncomp = _load_for_encode(in_path, opts)
    if opts.get("preprocess"):
        data = _apply_preprocess(data, opts["preprocess"], profile)
    ctx = _make_context(profile, opts["block"], opts["quality"], opts,
                        device)
    blocks, tcode = _compress_repeat(ctx, data, opts)
    if data.ndim == 4:
        z, h, w = data.shape[:3]
    else:
        h, w = data.shape[:2]
        z = 1
    out_type = "u8" if profile in (Profile.LDR, Profile.LDR_SRGB) else "f32"
    tdec = float("inf")
    img = None
    for _ in range(max(1, opts["repeats"])):
        t0 = time.perf_counter()
        img = api.decompress_image(ctx, np.asarray(blocks), w, h, z,
                                   out_type=out_type,
                                   swizzle=opts["swz_decode"])
        tdec = min(tdec, time.perf_counter() - t0)
    out0 = img[0] if not opts["yflip"] else img[0][::-1]
    image_io.save_image(out_path, out0)

    if not opts["silent"]:
        # Compare stage (reference: astcenccli_toplevel.cpp:2288-2296 →
        # compute_error_metrics, astcenccli_error_metrics.cpp:110-413).
        ref = (data.astype(np.float32) / 255.0
               if data.dtype == np.uint8 else data)
        dec = np.asarray(img if img.ndim == 4 else img[None])
        if dec.dtype == np.uint8:
            dec = dec.astype(np.float32) / 255.0
        if ref.ndim == 3:
            ref = ref[None]
        hdr = profile in (Profile.HDR_RGB_LDR_A, Profile.HDR)
        normal = bool(opts["flags"] & Flags.MAP_NORMAL)
        lo, hi = opts["mpsnr"]
        m = metrics.compute_error_metrics(ref, dec, ncomp or 4, hdr=hdr,
                                          normal=normal, fstop_lo=lo,
                                          fstop_hi=hi)
        print(metrics.format_error_metrics(m, ncomp or 4, hdr, normal,
                                           lo, hi))
        _print_performance(w * h * z, tcode, decode_time=tdec,
                           total_time=time.perf_counter() - tstart)
    return 0


def _usage():
    print("astcenc-torch: ASTC codec on PyTorch and CUDA\n"
          "usage: -cl/-cs/-ch/-cH <in> <out.astc> <WxH> <-preset> [opts]\n"
          "       -dl/-ds/-dh/-dH <in.astc> <out>\n"
          "       -tl/-ts/-th/-tH <in> <out> <WxH> <-preset> [opts]")


if __name__ == "__main__":
    sys.exit(main())
