"""astcenc_torch host tables: the NumPy tables reached through
astcenc_torch._host, and their device copies, equal the JAX package's,
value for value; and the port imports without jax."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from astcenc_tpu import api as japi
from astcenc_tpu.codec import trial as jtrial
from astcenc_torch import _host
from astcenc_torch import api as tapi

torch.set_num_threads(1)

CONFIGS = [(6, 6, 60.0, 1), (4, 4, 0.0, 4)]


def _pair(bx, by, quality, pcl):
    jcfg = japi.config_init(japi.Profile.LDR, bx, by, 1, quality, 0)
    tcfg = tapi.config_init(tapi.Profile.LDR, bx, by, 1, quality, 0)
    jcfg.tune_partition_count_limit = pcl
    tcfg.tune_partition_count_limit = pcl
    return japi.context_alloc(jcfg), tapi.context_alloc(tcfg)


def _assert_same(a, b, name):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert np.asarray(a).dtype.kind == np.asarray(b).dtype.kind, name
    else:
        assert a == b, name


@pytest.mark.parametrize("bx,by,quality,pcl", CONFIGS)
def test_encoder_tables_match(bx, by, quality, pcl):
    jctx, tctx = _pair(bx, by, quality, pcl)
    want = jtrial.build_encoder_tables(jctx.bsd)
    got = tctx.encoder_tables()
    for f in want.__dataclass_fields__:
        _assert_same(getattr(want, f), getattr(got, f), f)
    dev = _host.encoder_tables_to_torch(got, "cpu")
    for f in want.__dataclass_fields__:
        v = getattr(want, f)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(dev, f).numpy(), v,
                                          err_msg=f)


@pytest.mark.parametrize("bx,by,quality,pcl", CONFIGS)
def test_decode_tables_match(bx, by, quality, pcl):
    jctx, tctx = _pair(bx, by, quality, pcl)
    want = jctx.dtables
    got = tctx.dtables
    dev = tctx.torch_decode_tables()
    for f in want.__dataclass_fields__:
        v = getattr(want, f)
        _assert_same(v, getattr(got, f), f)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(dev, f).numpy(), v,
                                          err_msg=f)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import astcenc_torch, astcenc_torch.api as api\n"
        "import astcenc_torch.codec.compress, astcenc_torch.ops.msearch\n"
        "import astcenc_torch.ops.refine\n"
        "cfg = api.config_init(api.Profile.LDR, 6, 6, 1, "
        "api.Quality.MEDIUM, 0)\n"
        "ctx = api.context_alloc(cfg)\n"
        "assert ctx.encoder_tables().m1_quant.shape[0] > 0\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('astcenc_tpu') for m in sys.modules "
        "if sys.modules[m] is not None)\n"
        "print('ok')\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
