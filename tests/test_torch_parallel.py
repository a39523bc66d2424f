"""The port's multi-device encode (``astcenc_torch.parallel.sharding``) on
the CPU: the block axis split over a device list, here the CPU listed
twice or three times (the oracle of tests/test_parallel.py::
test_sharded_matches_single_device: the split changes no block)."""

import numpy as np
import pytest
import torch

from astcenc_torch import api as tapi
from astcenc_torch.codec import compress as tcomp
from astcenc_torch.parallel import sharding

torch.set_num_threads(2)


def _ctx():
    cfg = tapi.config_init(tapi.Profile.LDR, 4, 4, 1, tapi.Quality.FASTEST,
                           0)
    return tapi.context_alloc(cfg, device="cpu")


@pytest.mark.parametrize("n,devices", [(64, ["cpu", "cpu"]),
                                       (63, ["cpu", "cpu"]),
                                       (5, ["cpu"] * 3)])
def test_sharded_matches_single_device(n, devices):
    """4x4 -fastest on N seeded blocks (texels in 0..65535, as
    tests/test_parallel.py makes them): the sharded blocks and their
    sharded decode equal the single-device ones bit for bit, also where N
    is not a multiple of the device count (padding)."""
    ctx = _ctx()
    rng = np.random.RandomState(11)
    texels = (rng.rand(64, 16, 4).astype(np.float32) * 65535.0)[:n]
    single = tcomp.compress_blocks(ctx, torch.from_numpy(texels)).numpy()
    sharded = sharding.compress_blocks_sharded(ctx, texels, devices)
    assert sharded.shape == (n, 16) and sharded.dtype == np.uint8
    np.testing.assert_array_equal(single, sharded)
    dec = tapi.decompress_blocks(ctx, single).numpy()
    dec_sharded = sharding.decompress_blocks_sharded(ctx, single, devices)
    np.testing.assert_array_equal(dec, dec_sharded)
    np.testing.assert_array_equal(
        tapi.decompress_blocks(ctx, single, True).numpy(),
        sharding.decompress_blocks_sharded(ctx, single, devices, True))


def test_make_mesh():
    """The default mesh is every CUDA device and raises without one; a
    given list may repeat a device. ``pad_to_multiple`` as JAX's."""
    if torch.cuda.is_available():
        assert len(sharding.make_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh()
    assert sharding.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        sharding.make_mesh([])
    assert [sharding.pad_to_multiple(n, 4) for n in (0, 1, 4, 5, 8)] == \
        [0, 4, 4, 8, 8]
