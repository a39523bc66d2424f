"""Format data tables (context-build time, host NumPy).

The port's own copies of the JAX package's table builders
(``astcenc_tpu/tables``): block modes, decimation grids, partitions,
percentiles, BISE and quantization tables. They are pure NumPy and kept
value for value equal to the reference (``tests/test_torch_tables.py``).
"""

from . import block_mode, bsd, decimation, ise, partition, percentile, quant  # noqa: F401
from .bsd import BlockSizeDescriptor, build_bsd  # noqa: F401
