"""stage2b_blocks_pct (layer codec glue): the share of the traced stretch's
blocks that entered stage 2b at 2 partitions (the multi-partition
trials), from the program's counters: 100 x ``blocks.stage2b.pc2`` /
``blocks.stage1``."""

from benchmark import program_trace


def probe(port):
    return program_trace.Probe()


def read(run):
    rec = program_trace.recorded(run, "stage2b_blocks_pct")
    if rec is None or not rec.counters.get("blocks.stage1"):
        return None
    c = rec.counters
    return 100.0 * c.get("blocks.stage2b.pc2", 0) / c["blocks.stage1"]
