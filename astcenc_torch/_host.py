"""Device copies of the host NumPy table dataclasses."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch


def _to_torch(tab, device) -> types.SimpleNamespace:
    """Copy a NumPy table dataclass to device tensors.

    Integer arrays become int32 (int64 arrays are range-checked first),
    float arrays float32, bool arrays bool; scalars and tuples stay as they
    are.
    """
    out = {}
    for f in dataclasses.fields(tab):
        v = getattr(tab, f.name)
        if isinstance(v, np.ndarray):
            if v.dtype == np.bool_:
                v = torch.from_numpy(v.copy())
            elif np.issubdtype(v.dtype, np.integer):
                if v.size and (v.max() > 2**31 - 1 or v.min() < -2**31):
                    raise ValueError(f"{f.name} does not fit int32")
                v = torch.from_numpy(v.astype(np.int32))
            else:
                v = torch.from_numpy(v.astype(np.float32))
            v = v.to(device)
        out[f.name] = v
    return types.SimpleNamespace(**out)


def decode_tables_to_torch(dt, device) -> types.SimpleNamespace:
    """DecodeTables (NumPy) -> namespace of device tensors."""
    return _to_torch(dt, device)


def encoder_tables_to_torch(et, device) -> types.SimpleNamespace:
    """EncoderTables (NumPy) -> namespace of device tensors."""
    return _to_torch(et, device)
