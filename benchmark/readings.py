"""The readings that the correctness check's limits are set from.

    python benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--modes program,control,stale,half,altered,preset-fast] [--seconds 1]

Runs the cell once per seed in one process, at the cell's own load (its
clients, textures and sizes), with no warm-up and a short window in which
every client encodes at least its share of the set, so that every texture
is answered: the program as the configuration states it, or its control
(the program under the configuration's ``control_profile``), or the
program with a fault planted (``faults.py``), or the program at another
preset (``preset-<name>``: what a change that drops search or refinement
would read), for each mode named. Prints
one JSON line per mode and seed with each number the check compares, then
one line per mode with the largest and smallest reading of each number
over the seeds. Needs the card(s) the
cell asks for; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seeds, seconds: float, control: bool = False,
             fault: str | None = None, device: str = "cuda",
             preset: str | None = None) -> list:
    """Each seed's check numbers, ``correct`` and quality."""
    from benchmark import faults, harness
    cell = dataclasses.replace(
        cell, traffic=dict(cell.traffic, warmup_encodes=0))
    program = faults.control_config(cell.config) if control else None
    if preset:
        program = dict(cell.config, preset=preset)
    n = int(cell.traffic["set_size"])
    share = math.ceil(n / int(cell.traffic["clients"]))
    out = []
    for seed in seeds:
        ctx = (faults.planted(fault) if fault else contextlib.nullcontext())
        with ctx:
            r = harness.run_cell(cell, seed, seconds, False, device=device,
                                 program_config=program, min_encodes=share,
                                 log=lambda m: None)
        row = {"seed": seed, "correct": r["correct"],
               **{k: v["value"] for k, v in r["checks"].items()}}
        for k in ("psnr_db", "mpsnr_db", "mse_ppm"):
            if k in r["metrics"]:
                row[k] = r["metrics"][k]["value"]
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--modes", default="program",
                    help="comma-separated: program, control, or a fault")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from benchmark import faults, harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    modes = args.modes.split(",")
    for mode in modes:
        if (mode not in ("program", "control") + faults.FAULTS
                and not mode.startswith("preset-")):
            raise SystemExit(f"unknown mode {mode!r}")
    for mode in modes:
        preset = mode[len("preset-"):] if mode.startswith("preset-") else None
        rows = readings(cell, seeds, args.seconds, mode == "control",
                        mode if mode in faults.FAULTS else None,
                        preset=preset)
        for row in rows:
            print(json.dumps({"mode": mode, **row}), flush=True)
        keys = [k for k in rows[0] if k not in ("seed", "correct")]
        summary = {k: {"max": max(r[k] for r in rows),
                       "min": min(r[k] for r in rows)} for k in keys}
        print(json.dumps({"mode": mode, "workload": cell.name,
                          "seeds": seeds,
                          "correct": [r["correct"] for r in rows],
                          "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
