"""astcenc_torch kernels K1 and K2 against their plain PyTorch versions on
a CUDA card. Needs a card (the kernels have no CPU build) and no jax, so it
also runs where jax is missing:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from astcenc_torch import api
from astcenc_torch.codec import compress as tc
from astcenc_torch.codec import trial
from astcenc_torch.ops import msearch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _slice_cfg():
    cfg = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
    cfg.tune_partition_count_limit = 1
    cfg.tune_2plane_early_out_limit_correlation = 0.0
    return cfg


def test_msearch_kernel_matches_plain(cuda_device):
    """tests/test_pallas.py::_check_agreement bounds on random inputs."""
    ctx = api.context_alloc(_slice_cfg(), device=cuda_device)
    pt = ctx.pass_tables(False)
    rng = np.random.RandomState(9)
    N = 4096
    args = [rng.rand(N, 36).astype(np.float32),
            rng.rand(N, 36).astype(np.float32) * 1e8,
            rng.rand(N).astype(np.float32) * 2.0,
            rng.randint(5, 12, (N,)).astype(np.int32),
            rng.rand(N, 21, 4).astype(np.float32) * 1e9,
            rng.randint(0, 16, (N, 21, 4)).astype(np.int32)]
    args = [torch.from_numpy(a).to(cuda_device) for a in args]
    got = msearch.mode_search_cuda(pt, *args, 3)
    want = msearch.mode_search_plain(pt, *args, 3)
    g = {k: v.cpu().numpy() for k, v in got.items()}
    w = {k: v.cpu().numpy() for k, v in want.items()}
    same = g["mode"] == w["mode"]
    assert same.mean() > 0.96
    rel = np.abs(g["err"][same] - w["err"][same]) / np.maximum(
        np.abs(w["err"][same]), 1.0)
    assert np.median(rel) < 1e-5 and np.percentile(rel, 95) < 1e-3
    for k in ("dm", "wq", "valid"):
        np.testing.assert_array_equal(g[k][same], w[k][same], err_msg=k)
    for k in ("cq", "cqm", "fmt"):
        assert (g[k][same] == w[k][same]).mean() > 0.99, k
    assert (g["uq"][same] == w["uq"][same]).mean() > 0.995


def test_trial_records_kernels_match_plain(cuda_device):
    """tests/test_pallas.py:322-339 bounds on the trial records."""
    ctx = api.context_alloc(_slice_cfg(), device=cuda_device)
    rng = np.random.RandomState(5)
    N = 4096
    tex = np.floor(rng.rand(N, 36, 4) * 255.0).astype(np.float32) * 257.0
    tex[:1024, :, 3] = 65535.0
    st = tc.make_block_state(torch.from_numpy(tex).to(cuda_device), 1)
    ql = torch.full((N,), 11, dtype=torch.int32, device=cuda_device)
    ext = torch.ones(N, dtype=torch.bool, device=cuda_device)
    rk, rx = ({k: v.cpu().numpy() for k, v in trial.trial1_records(
        st, ctx.pass_tables(False), ctx.config, 1, False, ql, ext,
        use_kernels=k).items()} for k in (True, False))
    live = rx["err"] < 1e29
    np.testing.assert_allclose(rk["err"][live], rx["err"][live], rtol=3e-4)
    wk, wx = rk["err"].argmin(1), rx["err"].argmin(1)
    assert (wk == wx).mean() > 0.9
    same = wk == wx
    for k in ("fmt", "vals", "mode", "useq", "w64"):
        a, b = rk[k][same], rx[k][same]
        idx = wk[same].reshape((-1, 1) + (1,) * (a.ndim - 2))
        assert (np.take_along_axis(a, idx, 1)
                == np.take_along_axis(b, idx, 1)).mean() > 0.97, k


def test_encode_kernels_match_plain(cuda_device):
    """A 96x96 encode through the kernels and through the plain versions."""
    from astcenc_torch import testdata
    ctx = api.context_alloc(_slice_cfg(), device=cuda_device)
    img = testdata.synthetic_image(96, 96, 3)
    got = api.compress_image(ctx, img)
    want = tc.compress_image(ctx, img, use_kernels=False)
    assert (got == want).all(1).mean() >= 0.9
