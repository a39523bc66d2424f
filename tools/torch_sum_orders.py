"""PyTorch's reductions on a CUDA card against the same calls on the CPU.

    python3 tools/torch_sum_orders.py

For each call that the encoder's glue used to sum over texels or channels
(ROADMAP §C3), on seeded float32 inputs of a 6x6 block batch (4,096 blocks
of 36 texels), prints one JSON line: how many output values the card
computes otherwise than the CPU, bit for bit. A call whose count is 0 on
these inputs may still differ on others; the port's glue no longer relies
on any of them (``ops/texel_sum.py``, ``softfloat.sum3``/``sum4``/``sqrt``).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sum_orders: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    rng = np.random.default_rng(3)
    N, T = 4096, 36
    x = rng.normal(0, 3e4, (N, T, 4)).astype(np.float32)
    xu = rng.uniform(0, 65535, (N, T, 4)).astype(np.float32)
    m = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (N, T))]
    cw = torch.tensor([1.0, 2.0, 3.0, 4.0])
    calls = (
        ("einsum ntp,ntc->npc (one-hot mask)",
         lambda m, x: torch.einsum("ntp,ntc->npc", m, x), (m, x)),
        ("einsum ntp,nt->np (one-hot mask)",
         lambda m, x: torch.einsum("ntp,nt->np", m, x[..., 0]), (m, x)),
        ("einsum ntc,ntd->ncd (Gram)",
         lambda x: torch.einsum("ntc,ntd->ncd", x, x), (xu,)),
        ("sum(1) over texels", lambda x: x.sum(1), (xu,)),
        ("mean(1) over texels", lambda x: x.mean(1), (xu,)),
        ("sum(-1) over 4 channels", lambda x: x.sum(-1), (x,)),
        ("sum(-1) over 3 channels", lambda x: x[..., :3].sum(-1), (x,)),
        ("sum(-1) over 4 weighted squares",
         lambda x: (x * x * cw.to(x.device)).sum(-1), (x,)),
        ("sum(-1) over 36 texels", lambda x: x[..., 0].sum(-1), (xu,)),
        ("cumsum over 36 texels",
         lambda x: torch.cumsum(x[..., 0] * x[..., 0], -1), (xu,)),
        ("sqrt", lambda x: torch.sqrt(x.abs()), (x,)),
        ("division by a tensor", lambda x: x[..., 0] / x[..., 1], (x,)),
        ("amin(1)", lambda x: x.amin(1), (x,)),
    )
    for name, fn, args in calls:
        cpu = fn(*(torch.from_numpy(a) for a in args))
        card = fn(*(torch.from_numpy(a).to(dev) for a in args)).cpu()
        diff = int((cpu.contiguous().view(torch.int32)
                    != card.contiguous().view(torch.int32)).sum())
        print(json.dumps({"call": name, "values": cpu.numel(),
                          "differ": diff, "card": smi,
                          "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
