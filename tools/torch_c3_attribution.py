"""Which of the encoder glue's summing sites moves which blocks when the
card adds in the CPU's order (ROADMAP §C3), on one CUDA card.

    python3 tools/torch_c3_attribution.py [--size 2048] [--parent DIR]

Encodes ``chip_smoke.py``'s main-path texture (6x6 LDR -medium) and its
HDR texture (-ch) on the card, each once with every summing site of the
glue in the card's own PyTorch order (``torch.einsum``, ``.sum(-1)``,
``.sum(1)``, ``.mean(1)``, ``torch.cumsum`` and the float32
``torch.sqrt``: the port as it was before the sites went through
``ops/texel_sum.py`` and ``softfloat.sum3``/``sum4``/``sqrt``), once as the
port sums now (the CPU's order), and once per group of sites with that
group alone in the CPU's order. Groups: the ideal fit (``ops/ideal.py``),
the encoding-choice errors (``formats.encoding_choice_errors``), the block
mean, the 2-plane correlation gate and k-means. For each path it prints
how many blocks the whole change moves and how many each group moves
alone. With ``--parent`` (a directory holding ``old_ldr.npy`` and
``old_ch.npy``, the parent tree's blocks from
``tools/torch_compare_trees.py``) it also counts how many blocks of the
card-order encode differ from the parent's (0 if the card order here is
the parent's).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import types

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _HERE)


@contextlib.contextmanager
def _swapped(module, **attrs):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _groups():
    """Per group, a function that puts its sites in the card's order for
    the duration of a ``with``."""
    import torch
    from astcenc_torch.codec import compress, partition_search
    from astcenc_torch.ops import formats, ideal
    from astcenc_torch.ops import softfloat as sf

    def card_masked(mask, x):
        if x.dim() == 2:
            return torch.einsum("ntp,nt->np", mask, x)
        return torch.einsum("ntp,ntc->npc", mask, x)

    card_sf = types.SimpleNamespace(
        sum3=lambda v: v[..., :3].sum(-1), sum4=lambda v: v.sum(-1),
        sqrt=torch.sqrt, div=sf.div)
    card_ts = types.SimpleNamespace(
        masked_sum=card_masked, block_sum=lambda x: x.sum(1),
        texel_sum=lambda a, b: torch.einsum("ntp,ntc->npc", a, b),
        row_sum=lambda x: x.sum(-1),
        prefix_sums=lambda x: torch.cumsum(x, -1))
    eci, mbs, corr = (formats.encoding_choice_errors,
                      compress.make_block_state, compress._lowest_correlation)

    def eci_card(*a, **kw):
        with _swapped(formats, masked_sum=card_masked, sf=card_sf):
            return eci(*a, **kw)

    def mbs_card(texels, *a, **kw):
        st = mbs(texels, *a, **kw)
        st["data_mean"] = texels.mean(1)
        return st

    def corr_card(*a, **kw):
        with _swapped(compress, ts=card_ts, sf=card_sf):
            return corr(*a, **kw)

    return {
        "ideal_fit": lambda: _swapped(ideal, masked_sum=card_masked,
                                      sf=card_sf),
        "encoding_choice": lambda: _swapped(
            formats, encoding_choice_errors=eci_card),
        "block_mean": lambda: _swapped(compress, make_block_state=mbs_card),
        "correlation": lambda: _swapped(compress,
                                        _lowest_correlation=corr_card),
        "kmeans": lambda: _swapped(partition_search, ts=card_ts, sf=card_sf),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--parent", help="directory of the parent's blocks")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_c3_attribution: no CUDA device", file=sys.stderr)
        return 1
    from astcenc_torch import api, testdata
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    groups = _groups()
    n = args.size
    for name, prof, img in (
            ("ldr", api.Profile.LDR,
             testdata.synthetic_image(n, n, 0, independent_alpha=True)),
            ("ch", api.Profile.HDR_RGB_LDR_A,
             testdata.synthetic_hdr_image(n, n, 0, independent_alpha=True))):
        ctx = api.context_alloc(api.config_init(
            prof, 6, 6, 1, api.Quality.MEDIUM, 0), device="cuda")

        def encode(cpu_order):
            """Blocks with the groups in ``cpu_order`` in the CPU's order
            and every other group in the card's."""
            with contextlib.ExitStack() as stack:
                for g, card in groups.items():
                    if g not in cpu_order:
                        stack.enter_context(card())
                return api.compress_image(ctx, img)

        card = encode(())
        now = encode(tuple(groups))
        moved = ~(card == now).all(1)
        rec = {"path": name, "size": n, "blocks": int(len(now)),
               "moved_by_all": int(moved.sum())}
        union = np.zeros_like(moved)
        for g in groups:
            alone = ~(encode((g,)) == card).all(1)
            rec[f"moved_by_{g}"] = int(alone.sum())
            union |= alone
        rec["moved_only_together"] = int((moved & ~union).sum())
        if args.parent:
            old = np.load(os.path.join(args.parent, f"old_{name}.npy"))
            rec["card_order_vs_parent"] = int((~(old == card).all(1)).sum())
            rec["now_vs_parent"] = int((~(old == now).all(1)).sum())
        rec["card"] = smi
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
