"""Blocks of two checkouts of astcenc_torch compared on one CUDA card.

    python3 tools/torch_compare_trees.py OLD_TREE [--size 2048] [--out DIR]
        [--profile]

Encodes ``chip_smoke.py``'s main-path texture (a synthetic 2048x2048 RGBA8
image, seed 0, the right half with an alpha of its own, 6x6 LDR -medium)
and its HDR-path texture (the float16 counterpart at -ch) once with the
checkout OLD_TREE and once with this one, each in a process of its own
(both packages are named ``astcenc_torch``), and prints per path the
number of blocks that differ, how the kinds of those blocks (partitions,
planes) moved, and the decoded quality (PSNR, mPSNR) of both encodes. The
blocks are kept as ``.npy`` files in ``--out`` (default
``chiprun_out/compare_trees``). With ``--profile`` each process then
encodes the HDR texture four times more, three timed (the kernels'
launches counted in each) and one under ``chip_smoke._profile`` of its own
tree (the whole texture: device time by kernel, device operations, idle
share), and prints the times, launches and profile as a JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENCODE = r'''
import json, sys, time, numpy as np, torch
tree, size, out, prof = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, tree)
from astcenc_torch import api, testdata
ldr = api.config_init(api.Profile.LDR, 6, 6, 1, api.Quality.MEDIUM, 0)
hdr = api.config_init(api.Profile.HDR_RGB_LDR_A, 6, 6, 1, api.Quality.MEDIUM,
                      0)
for name, cfg, img in (
        ("ldr", ldr, testdata.synthetic_image(size, size, 0,
                                              independent_alpha=True)),
        ("ch", hdr, testdata.synthetic_hdr_image(size, size, 0,
                                                 independent_alpha=True))):
    ctx = api.context_alloc(cfg, device="cuda")
    blocks = api.compress_image(ctx, img)
    torch.cuda.synchronize()
    np.save(f"{out}_{name}.npy", blocks)
if prof == "1":
    import chip_smoke
    try:
        from astcenc_torch import obs  # noqa: F401 (launches in its counters)
        mods = ()
    except ImportError:                # a tree with module launch counters
        from astcenc_torch.ops import (color_pack, gather, msearch, psearch,
                                       refine, texel_sum)
        mods = (msearch, refine, psearch, gather, color_pack, texel_sum)
    enc_s = []
    for k in range(3):
        chip_smoke._reset(*mods)
        t0 = time.perf_counter()
        api.compress_image(ctx, img)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
    print(json.dumps({"tree": tree, "path": name, "size": size,
                      "encode_s": enc_s,
                      "launches": chip_smoke._counts(*mods),
                      "profile": chip_smoke._profile(
                          lambda: api.compress_image(ctx, img)),
                      "card": chip_smoke._smi()}), flush=True)
'''


def _kinds(decompress, ctx, blocks):
    """Per block: 'constant' or 'pc<p>_<planes>plane'."""
    import numpy as np
    import torch
    const, pc, planes = decompress.block_types(
        ctx.torch_decode_tables(), torch.from_numpy(blocks).to(ctx.device))
    const, pc, planes = (t.cpu().numpy() for t in (const, pc, planes))
    return np.where(const, "constant", np.char.add(np.char.add(
        np.char.add("pc", pc.astype(str)), "_"),
        np.char.add(planes.astype(str), "plane")))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_tree", help="the other checkout")
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--out", default=os.path.join(_HERE, "chiprun_out",
                                                  "compare_trees"))
    ap.add_argument("--profile", action="store_true",
                    help="also time and profile each tree's HDR encode")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_compare_trees: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    trees = {"old": os.path.abspath(args.old_tree), "new": _HERE}
    for tag, tree in trees.items():
        subprocess.run([sys.executable, "-c", _ENCODE, tree, str(args.size),
                        os.path.join(args.out, tag),
                        "1" if args.profile else "0"], check=True)
    sys.path.insert(0, _HERE)
    from astcenc_torch import api, testdata
    from astcenc_torch.codec import decompress
    from astcenc_torch.utils import metrics
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    n = args.size
    for name, prof in (("ldr", api.Profile.LDR),
                       ("ch", api.Profile.HDR_RGB_LDR_A)):
        ctx = api.context_alloc(api.config_init(
            prof, 6, 6, 1, api.Quality.MEDIUM, 0), device="cuda")
        old, new = (np.load(os.path.join(args.out, f"{t}_{name}.npy"))
                    for t in ("old", "new"))
        moved = ~(old == new).all(1)
        ko, kn = _kinds(decompress, ctx, old), _kinds(decompress, ctx, new)
        pairs = {}
        for a, b in zip(ko[moved], kn[moved]):
            pairs[f"{a}->{b}"] = pairs.get(f"{a}->{b}", 0) + 1
        if name == "ldr":
            img = testdata.synthetic_image(n, n, 0, independent_alpha=True)
            q = {t: float(10 * np.log10(255.0 ** 2 / np.mean((
                api.decompress_image(ctx, b, n, n)[0].astype(np.float64)
                - img) ** 2))) for t, b in (("old", old), ("new", new))}
        else:
            img = testdata.synthetic_hdr_image(n, n, 0,
                                               independent_alpha=True)
            q = {t: float(metrics.mpsnr(api.decompress_image(
                ctx, b, n, n, out_type="f32")[0], img.astype(np.float32)))
                for t, b in (("old", old), ("new", new))}
        print(json.dumps({"path": name, "size": n, "blocks": int(len(old)),
                          "moved": int(moved.sum()),
                          "moved_indices": np.flatnonzero(moved)[
                              :50].tolist(),
                          "kinds_moved": pairs, "quality_db": q,
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
