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

A second line does the same for ``astcenc_tpu.ops.recompute.
recompute_ideal_colors_2planes`` on the round-0 refit arguments of the RGBM
block that the port encodes otherwise than JAX (block 6 of the fixture
``4x4_medium_rgbm``, ``tests/test_torch_features.py::
test_rgbm_block6_is_jax_jit_rounding``): the float32 values that differ
jitted against eager, and the port's CPU refit against eager.
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
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    import test_torch_features as features
    from astcenc_tpu.ops import recompute as jrecompute
    _, (args, port), _, _ = features._c5_port_round0()
    jargs = [jnp.asarray(a.numpy()) if torch.is_tensor(a) else a
             for a in args]
    eager = jrecompute.recompute_ideal_colors_2planes(*jargs)
    jitted = jax.jit(jrecompute.recompute_ideal_colors_2planes,
                     static_argnums=4)(*jargs)

    def differ(a, b):
        return int(sum((np.asarray(a[k]).view(np.int32)
                        != np.asarray(b[k]).view(np.int32)).sum()
                       for k in ("ep0", "ep1", "rgbs")))
    print(json.dumps({
        "rgbm_block6_refit_values": 3 * int(port["ep0"].numel()),
        "jit_vs_eager_differ": differ(jitted, eager),
        "port_cpu_vs_eager_differ": differ(
            {k: v.numpy() for k, v in port.items()}, eager)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
