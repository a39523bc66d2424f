"""The JAX package's partition averages and directions, jitted against
eager, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_jit_vs_eager.py

``astcenc_tpu.ops.ideal.avgs_and_dirs`` on the seeded 2-partition blocks of
``tests/test_torch_cuda.py::test_encoding_choice_errors_against_cpu``
(4,096 blocks of 36 texels, RGB): run eagerly and under ``jax.jit``, the
number of direction values whose float32 bits differ, and the same count
between the eager run and the port's CPU version. XLA picks its own
summation order when it compiles, so the reference has no one order the
port could copy; the port is held to JAX's committed blocks instead.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch
    from astcenc_tpu.ops import ideal as jideal
    from astcenc_torch.ops import ideal as tideal
    rng = np.random.default_rng(67)
    N, P, T = 4096, 2, 36
    tex = rng.uniform(0, 65535, (N, T, 4)).astype(np.float32)
    tex[:N // 2] = np.sort(tex[:N // 2], 1)
    pmask = np.eye(P, dtype=np.float32)[rng.integers(0, P, (N, T))]
    cm = (1, 1, 1, 0)
    _, eager = jideal.avgs_and_dirs(jnp.asarray(tex), jnp.asarray(pmask), cm)
    _, jitted = jax.jit(jideal.avgs_and_dirs, static_argnums=2)(
        jnp.asarray(tex), jnp.asarray(pmask), cm)
    _, port = tideal.avgs_and_dirs(torch.from_numpy(tex),
                                   torch.from_numpy(pmask), cm)
    e = np.asarray(eager).view(np.int32)
    print(json.dumps({
        "values": int(e.size),
        "jit_vs_eager_differ": int((np.asarray(jitted).view(np.int32)
                                    != e).sum()),
        "port_cpu_vs_eager_differ": int((port.numpy().view(np.int32)
                                         != e).sum()),
        "jax": jax.__version__, "device": "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
