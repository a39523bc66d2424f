"""Configuration: profiles, flags, quality presets, validation.

Mirrors astcenc_config_init / validate_config behavior including the
3-tier preset tables with linear interpolation between preset rows
(reference: Source/astcenc_entry.cpp:40-135, 504-723, 434-501). The preset
numbers define the quality/speed contract for every config in BASELINE.json
and are reproduced exactly.
"""

from __future__ import annotations

import dataclasses
import enum
import math

from .tables.percentile import is_legal_2d_block_size, is_legal_3d_block_size


class Profile(enum.IntEnum):
    LDR_SRGB = 0
    LDR = 1
    HDR_RGB_LDR_A = 2
    HDR = 3


class Quality:
    """Preset quality levels (reference: astcenc.h ASTCENC_PRE_*)."""
    FASTEST = 0.0
    FAST = 10.0
    MEDIUM = 60.0
    THOROUGH = 98.0
    VERYTHOROUGH = 99.0
    EXHAUSTIVE = 100.0


PRESET_MAX = Quality.EXHAUSTIVE


class Flags(enum.IntFlag):
    MAP_NORMAL = 1 << 0
    USE_DECODE_UNORM8 = 1 << 1
    USE_ALPHA_WEIGHT = 1 << 2
    USE_PERCEPTUAL = 1 << 3
    DECOMPRESS_ONLY = 1 << 4
    SELF_DECOMPRESS_ONLY = 1 << 5
    MAP_RGBM = 1 << 6


class Swizzle(enum.IntEnum):
    R = 0
    G = 1
    B = 2
    A = 3
    ZERO = 4
    ONE = 5
    Z = 6


@dataclasses.dataclass
class ASTCConfig:
    """Compression settings (reference: astcenc.h:427-605 astcenc_config)."""

    profile: Profile
    flags: int
    block_x: int
    block_y: int
    block_z: int

    cw_r_weight: float = 1.0
    cw_g_weight: float = 1.0
    cw_b_weight: float = 1.0
    cw_a_weight: float = 1.0

    a_scale_radius: int = 0
    rgbm_m_scale: float = 0.0

    tune_partition_count_limit: int = 4
    tune_2partition_index_limit: int = 1024
    tune_3partition_index_limit: int = 1024
    tune_4partition_index_limit: int = 1024
    tune_block_mode_limit: int = 100
    tune_refinement_limit: int = 4
    tune_candidate_limit: int = 8
    tune_2partitioning_candidate_limit: int = 8
    tune_3partitioning_candidate_limit: int = 8
    tune_4partitioning_candidate_limit: int = 8
    tune_db_limit: float = 0.0
    tune_mse_overshoot: float = 10.0
    tune_2partition_early_out_limit_factor: float = 2.0
    tune_3partition_early_out_limit_factor: float = 2.0
    tune_2plane_early_out_limit_correlation: float = 0.99
    tune_search_mode0_enable: float = 0.0

    quality: float = 60.0  # kept for introspection


# Preset rows: (quality, partition_count, 2p_idx, 3p_idx, 4p_idx, block_mode,
#  refine, cand, 2p_cand, 3p_cand, 4p_cand, db_a, db_b, mse_overshoot,
#  2p_factor, 3p_factor, 2plane_corr, mode0)
# (reference: astcenc_entry.cpp:65-135)
_PRESETS_HIGH = (
    (0.0, 2, 10, 6, 4, 43, 2, 2, 2, 2, 2, 85.2, 63.2, 3.5, 1.00, 1.00, 0.85, 0.0),
    (10.0, 3, 18, 10, 8, 55, 3, 3, 2, 2, 2, 85.2, 63.2, 3.5, 1.00, 1.00, 0.90, 0.0),
    (60.0, 4, 34, 28, 16, 77, 3, 3, 2, 2, 2, 95.0, 70.0, 2.5, 1.10, 1.05, 0.95, 0.0),
    (98.0, 4, 82, 60, 30, 94, 4, 4, 3, 2, 2, 105.0, 77.0, 10.0, 1.35, 1.15, 0.97, 0.0),
    (99.0, 4, 256, 128, 64, 98, 4, 6, 8, 6, 4, 200.0, 200.0, 10.0, 1.60, 1.40, 0.98, 0.0),
    (100.0, 4, 512, 512, 512, 100, 4, 8, 8, 8, 8, 200.0, 200.0, 10.0, 2.00, 2.00, 0.99, 0.0),
)
_PRESETS_MID = (
    (0.0, 2, 10, 6, 4, 43, 2, 2, 2, 2, 2, 85.2, 63.2, 3.5, 1.00, 1.00, 0.80, 1.0),
    (10.0, 3, 18, 12, 10, 55, 3, 3, 2, 2, 2, 85.2, 63.2, 3.5, 1.00, 1.00, 0.85, 1.0),
    (60.0, 3, 34, 28, 16, 77, 3, 3, 2, 2, 2, 95.0, 70.0, 3.0, 1.10, 1.05, 0.90, 1.0),
    (98.0, 4, 82, 60, 30, 94, 4, 4, 3, 2, 2, 105.0, 77.0, 10.0, 1.40, 1.20, 0.95, 0.0),
    (99.0, 4, 256, 128, 64, 98, 4, 6, 8, 6, 3, 200.0, 200.0, 10.0, 1.60, 1.40, 0.98, 0.0),
    (100.0, 4, 256, 256, 256, 100, 4, 8, 8, 8, 8, 200.0, 200.0, 10.0, 2.00, 2.00, 0.99, 0.0),
)
_PRESETS_LOW = (
    (0.0, 2, 10, 6, 4, 40, 2, 2, 2, 2, 2, 85.0, 63.0, 3.5, 1.00, 1.00, 0.80, 1.0),
    (10.0, 2, 18, 12, 10, 55, 3, 3, 2, 2, 2, 85.0, 63.0, 3.5, 1.00, 1.00, 0.85, 1.0),
    (60.0, 3, 34, 28, 16, 77, 3, 3, 2, 2, 2, 95.0, 70.0, 3.5, 1.10, 1.05, 0.90, 1.0),
    (98.0, 4, 82, 60, 30, 93, 4, 4, 3, 2, 2, 105.0, 77.0, 10.0, 1.30, 1.20, 0.97, 1.0),
    (99.0, 4, 256, 128, 64, 98, 4, 6, 8, 5, 2, 200.0, 200.0, 10.0, 1.60, 1.40, 0.98, 1.0),
    (100.0, 4, 256, 256, 256, 100, 4, 8, 8, 8, 8, 200.0, 200.0, 10.0, 2.00, 2.00, 0.99, 1.0),
)

_INT_FIELDS = 10  # fields 1..10 are integers (rtn rounding on interpolation)


class Error(enum.IntEnum):
    """Stable API error codes (reference: astcenc_error, astcenc.h:207-236)."""

    SUCCESS = 0
    ERR_OUT_OF_MEM = 1
    ERR_BAD_CPU_FLOAT = 2
    ERR_BAD_PARAM = 3
    ERR_BAD_BLOCK_SIZE = 4
    ERR_BAD_PROFILE = 5
    ERR_BAD_QUALITY = 6
    ERR_BAD_SWIZZLE = 7
    ERR_BAD_FLAGS = 8
    ERR_BAD_CONTEXT = 9
    ERR_NOT_IMPLEMENTED = 10
    ERR_BAD_DECODE_MODE = 11
    ERR_DTRACE_FAILURE = 12


_ERROR_STRINGS = {
    Error.SUCCESS: "ASTCENC_SUCCESS",
    Error.ERR_OUT_OF_MEM: "ASTCENC_ERR_OUT_OF_MEM",
    Error.ERR_BAD_CPU_FLOAT: "ASTCENC_ERR_BAD_CPU_FLOAT",
    Error.ERR_BAD_PARAM: "ASTCENC_ERR_BAD_PARAM",
    Error.ERR_BAD_BLOCK_SIZE: "ASTCENC_ERR_BAD_BLOCK_SIZE",
    Error.ERR_BAD_PROFILE: "ASTCENC_ERR_BAD_PROFILE",
    Error.ERR_BAD_QUALITY: "ASTCENC_ERR_BAD_QUALITY",
    Error.ERR_BAD_SWIZZLE: "ASTCENC_ERR_BAD_SWIZZLE",
    Error.ERR_BAD_FLAGS: "ASTCENC_ERR_BAD_FLAGS",
    Error.ERR_BAD_CONTEXT: "ASTCENC_ERR_BAD_CONTEXT",
    Error.ERR_NOT_IMPLEMENTED: "ASTCENC_ERR_NOT_IMPLEMENTED",
    Error.ERR_BAD_DECODE_MODE: "ASTCENC_ERR_BAD_DECODE_MODE",
    Error.ERR_DTRACE_FAILURE: "ASTCENC_ERR_DTRACE_FAILURE",
}


def error_string(status) -> str | None:
    """String form of an error code (reference: astcenc_get_error_string,
    astcenc_entry.cpp:1519-1558); None for out-of-enum values, matching the
    reference's nullptr."""
    try:
        return _ERROR_STRINGS[Error(int(status))]
    except (ValueError, KeyError):
        return None


class ConfigError(ValueError):
    """Config/parameter validation failure carrying a stable error code."""

    def __init__(self, message: str, code: Error = Error.ERR_BAD_PARAM):
        super().__init__(message)
        self.code = Error(code)


def _flt2int_rtn(v: float) -> int:
    return int(math.floor(v + 0.5))


def config_init(profile: Profile, block_x: int, block_y: int,
                block_z: int = 1, quality: float = Quality.MEDIUM,
                flags: int = 0) -> ASTCConfig:
    """Populate a config from a preset (reference: astcenc_config_init)."""
    block_z = max(block_z, 1)
    _validate_block_size(block_x, block_y, block_z)

    if quality < 0.0 or quality > 100.0:
        raise ConfigError("quality out of range", Error.ERR_BAD_QUALITY)

    texels = block_x * block_y * block_z
    ltexels = math.log(texels) / math.log(10.0)

    if texels < 25:
        presets = _PRESETS_HIGH
    elif texels < 64:
        presets = _PRESETS_MID
    else:
        presets = _PRESETS_LOW

    end = 0
    while end < len(presets) and presets[end][0] < quality:
        end += 1
    end = min(end, len(presets) - 1)
    start = 0 if end == 0 else end - 1

    a = presets[start]
    b = presets[end]
    if start == end:
        row = list(a)
    else:
        rng = b[0] - a[0]
        wa = (b[0] - quality) / rng
        wb = (quality - a[0]) / rng
        row = []
        for i in range(len(a)):
            v = a[i] * wa + b[i] * wb
            row.append(_flt2int_rtn(v) if 1 <= i <= _INT_FIELDS else v)

    db_limit = max(row[11] - 35 * ltexels, row[12] - 19 * ltexels)

    cfg = ASTCConfig(
        profile=Profile(profile), flags=int(flags),
        block_x=block_x, block_y=block_y, block_z=block_z,
        tune_partition_count_limit=int(row[1]),
        tune_2partition_index_limit=int(row[2]),
        tune_3partition_index_limit=int(row[3]),
        tune_4partition_index_limit=int(row[4]),
        tune_block_mode_limit=int(row[5]),
        tune_refinement_limit=int(row[6]),
        tune_candidate_limit=int(row[7]),
        tune_2partitioning_candidate_limit=int(row[8]),
        tune_3partitioning_candidate_limit=int(row[9]),
        tune_4partitioning_candidate_limit=int(row[10]),
        tune_db_limit=db_limit,
        tune_mse_overshoot=row[13],
        tune_2partition_early_out_limit_factor=row[14],
        tune_3partition_early_out_limit_factor=row[15],
        tune_2plane_early_out_limit_correlation=row[16],
        tune_search_mode0_enable=row[17],
        quality=quality,
    )

    if profile in (Profile.HDR, Profile.HDR_RGB_LDR_A):
        cfg.tune_db_limit = 999.0
        cfg.tune_search_mode0_enable = 0.0
    elif profile not in (Profile.LDR, Profile.LDR_SRGB):
        raise ConfigError("bad profile", Error.ERR_BAD_PROFILE)

    _validate_flags(profile, flags)

    if flags & Flags.MAP_NORMAL:
        cfg.tune_partition_count_limit = min(cfg.tune_partition_count_limit + 1, 4)
        cfg.cw_g_weight = 0.0
        cfg.cw_b_weight = 0.0
        cfg.tune_2partition_early_out_limit_factor *= 1.5
        cfg.tune_3partition_early_out_limit_factor *= 1.5
        cfg.tune_2plane_early_out_limit_correlation = 0.99
        cfg.tune_db_limit *= 1.03
    elif flags & Flags.MAP_RGBM:
        cfg.rgbm_m_scale = 5.0
        cfg.cw_a_weight = 2.0 * cfg.rgbm_m_scale
    elif flags & Flags.USE_PERCEPTUAL:
        cfg.cw_r_weight = 0.30 * 2.25
        cfg.cw_g_weight = 0.59 * 2.25
        cfg.cw_b_weight = 0.11 * 2.25

    return cfg


def _validate_block_size(x, y, z):
    if z <= 1:
        if not is_legal_2d_block_size(x, y):
            raise ConfigError(f"illegal block size {x}x{y}", Error.ERR_BAD_BLOCK_SIZE)
    else:
        if not is_legal_3d_block_size(x, y, z):
            raise ConfigError(f"illegal block size {x}x{y}x{z}", Error.ERR_BAD_BLOCK_SIZE)


def _validate_flags(profile, flags):
    all_flags = 0
    for f in Flags:
        all_flags |= f
    if flags & ~all_flags:
        raise ConfigError("unknown flags", Error.ERR_BAD_FLAGS)
    exclusive = (Flags.MAP_NORMAL | Flags.MAP_RGBM)
    if bin(int(flags) & int(exclusive)).count("1") > 1:
        raise ConfigError("mutually exclusive map flags", Error.ERR_BAD_FLAGS)


def validate_config(config: ASTCConfig) -> None:
    """Clamp/validate tuning parameters (reference: validate_config,
    astcenc_entry.cpp:434-501)."""
    c = config
    c.tune_partition_count_limit = min(max(c.tune_partition_count_limit, 1), 4)
    c.tune_2partition_index_limit = min(max(c.tune_2partition_index_limit, 1), 1024)
    c.tune_3partition_index_limit = min(max(c.tune_3partition_index_limit, 1), 1024)
    c.tune_4partition_index_limit = min(max(c.tune_4partition_index_limit, 1), 1024)
    c.tune_block_mode_limit = min(max(c.tune_block_mode_limit, 1), 100)
    c.tune_refinement_limit = max(c.tune_refinement_limit, 1)
    c.tune_candidate_limit = min(max(c.tune_candidate_limit, 1), 8)
    c.tune_2partitioning_candidate_limit = min(max(c.tune_2partitioning_candidate_limit, 1), 8)
    c.tune_3partitioning_candidate_limit = min(max(c.tune_3partitioning_candidate_limit, 1), 8)
    c.tune_4partitioning_candidate_limit = min(max(c.tune_4partitioning_candidate_limit, 1), 8)
    c.tune_db_limit = max(c.tune_db_limit, 0.0)
    c.tune_mse_overshoot = max(c.tune_mse_overshoot, 1.0)
    c.tune_2partition_early_out_limit_factor = max(
        c.tune_2partition_early_out_limit_factor, 0.0)
    c.tune_3partition_early_out_limit_factor = max(
        c.tune_3partition_early_out_limit_factor, 0.0)
    c.tune_2plane_early_out_limit_correlation = max(
        c.tune_2plane_early_out_limit_correlation, 0.0)
    if bool(c.flags & Flags.MAP_RGBM) and c.rgbm_m_scale < 1.0:
        raise ConfigError("rgbm_m_scale must be >= 1 with MAP_RGBM")
