"""Host-side NumPy tables of the JAX package, loaded without jax.

Any import of ``astcenc_tpu.*`` runs ``astcenc_tpu/__init__.py``, which
imports jax. The table builders themselves (``tables/*``, ``config.py``,
``codec/decode_tables.py``) are pure NumPy, so this module registers a
synthetic package whose ``__path__`` is the ``astcenc_tpu`` directory and
imports them through it: the files stay one source, bit-exact against the
reference, and ``astcenc_tpu/__init__.py`` never runs.

It also turns the NumPy table dataclasses into device tensors.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import sys
import types

import numpy as np
import torch

_PKG = __name__ + "_ref"          # "astcenc_torch._host_ref"
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "astcenc_tpu")


def _register():
    mod = sys.modules.get(_PKG)
    if mod is None:
        if not os.path.isfile(os.path.join(_SRC, "config.py")):
            raise ImportError(f"host table sources not found under {_SRC}")
        mod = types.ModuleType(_PKG)
        mod.__path__ = [_SRC]
        mod.__package__ = _PKG
        sys.modules[_PKG] = mod
    return mod


_register()
config = importlib.import_module(_PKG + ".config")
ise = importlib.import_module(_PKG + ".tables.ise")
quant = importlib.import_module(_PKG + ".tables.quant")
bsd = importlib.import_module(_PKG + ".tables.bsd")
decode_tables = importlib.import_module(_PKG + ".codec.decode_tables")


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
