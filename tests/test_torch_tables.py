"""astcenc_torch host tables: the port's own copies of the NumPy table
builders, and their device copies, equal the JAX package's, value for
value; and the port imports nothing of jax or of the JAX package."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from astcenc_tpu import api as japi
from astcenc_tpu.codec import trial as jtrial
from astcenc_torch import _host
from astcenc_torch import api as tapi
from astcenc_torch import testdata

torch.set_num_threads(1)

CONFIGS = [(6, 6, 60.0, 1), (4, 4, 0.0, 4)]


def _pair(bx, by, quality, pcl):
    jcfg = japi.config_init(japi.Profile.LDR, bx, by, 1, quality, 0)
    tcfg = tapi.config_init(tapi.Profile.LDR, bx, by, 1, quality, 0)
    jcfg.tune_partition_count_limit = pcl
    tcfg.tune_partition_count_limit = pcl
    return japi.context_alloc(jcfg), tapi.context_alloc(tcfg, device="cpu")


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


def _assert_same_tree(a, b, name):
    if isinstance(a, dict):
        assert set(a) == set(b), name
        for k in a:
            _assert_same_tree(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{name}[{i}]")
    else:
        _assert_same(a, b, name)


@pytest.mark.parametrize("bx,by,quality,pcl", CONFIGS)
def test_block_size_descriptor_matches(bx, by, quality, pcl):
    """Every field of the block size descriptor, the partitionings that
    stage 2b searches (texel maps, coverage bitmaps, seeds, k-means texels)
    included."""
    jctx, tctx = _pair(bx, by, quality, pcl)
    for f in jctx.bsd.__dataclass_fields__:
        _assert_same_tree(getattr(jctx.bsd, f), getattr(tctx.bsd, f), f)
    assert tctx.bsd.partitionings[2]["count_selected"] > 0


def test_context_defaults_to_the_card():
    """context_alloc without a device asks for the card: on a host without
    one it raises rather than falling back to the CPU."""
    cfg = tapi.config_init(tapi.Profile.LDR, 6, 6, 1, tapi.Quality.MEDIUM, 0)
    if torch.cuda.is_available():
        assert tapi.context_alloc(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.context_alloc(cfg)
    assert tapi.context_alloc(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [{"args": (4,)},
                                {"kwargs": {"thread_count": 4}}])
def test_context_alloc_takes_thread_count(kw):
    """``context_alloc(config, thread_count=0, *, device)`` as the JAX
    package's ``context_alloc(config, thread_count=0)``: the thread count,
    second or by name, is taken and ignored (not read as a device), and the
    context encodes a 16x16 image as one made without it."""
    cfg = tapi.config_init(tapi.Profile.LDR, 4, 4, 1, tapi.Quality.FASTEST,
                           0)
    ctx = tapi.context_alloc(cfg, *kw.get("args", ()),
                             **kw.get("kwargs", {}), device="cpu")
    assert ctx.device == torch.device("cpu")
    img = testdata.synthetic_image(16, 16, 7)
    blocks = tapi.compress_image(ctx, img)
    assert blocks.shape == (16, 16)
    np.testing.assert_array_equal(blocks, tapi.compress_image(
        tapi.context_alloc(cfg, device="cpu"), img))
    with pytest.raises(TypeError):
        tapi.context_alloc(cfg, 4, "cpu")


def test_port_imports_without_jax():
    """Importing the port, its API, its CLI, its test data and every
    module of codec/, io/, ops/, parallel/ and utils/ (and building tables)
    loads jax under no name and no module whose file lies under
    astcenc_tpu/. ``astcenc_torch.__main__`` runs the CLI, so it is not
    imported."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = os.path.join(root, "astcenc_tpu") + os.sep
    code = (
        "import importlib, os, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import astcenc_torch, astcenc_torch.api as api\n"
        "import astcenc_torch.codec, astcenc_torch.ops, astcenc_torch.utils\n"
        "import astcenc_torch.io, astcenc_torch.parallel\n"
        "import astcenc_torch.cli, astcenc_torch.codec.trace\n"
        "import astcenc_torch.testdata\n"
        "for pkg in (astcenc_torch.codec, astcenc_torch.ops, "
        "astcenc_torch.utils, astcenc_torch.io, astcenc_torch.parallel):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        importlib.import_module(pkg.__name__ + '.' + m.name)\n"
        "cfg = api.config_init(api.Profile.LDR, 6, 6, 1, "
        "api.Quality.MEDIUM, 0)\n"
        "ctx = api.context_alloc(cfg, device='cpu')\n"
        "assert ctx.encoder_tables().m1_quant.shape[0] > 0\n"
        "assert ctx.dtables is not None\n"
        f"ref = {ref!r}\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and ("
        "m == 'jax' or m.startswith('jax.') or os.path.abspath("
        "getattr(v, '__file__', None) or '').startswith(ref))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
