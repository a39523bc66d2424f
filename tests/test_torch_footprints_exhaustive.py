"""The -exhaustive configurations of tests/test_torch_footprints.py: 4x4
(HIGH preset row: 512 partitionings a count), 6x6, 8x8 and 12x12 (LOW row:
T = 144, W up to 64; 8 candidates, 4 rounds) on 9-block images, the port's
CPU encode against JAX's committed blocks. A file of their own, so that
``--dist loadfile`` runs them on another worker than the other footprints.
"""

import pytest

from test_torch_footprints import EXHAUSTIVE, check_fixture


@pytest.mark.parametrize("name", EXHAUSTIVE)
def test_exhaustive_matches_jax(name):
    check_fixture(name)
