"""stage2b_pc4_blocks_pct (layer codec glue): the share of the traced
stretch's blocks that entered stage 2b at 4 partitions, from the
program's counters: 100 x ``blocks.stage2b.pc4`` / ``blocks.stage1``. The
preset rows that allow 4 partitions (-thorough and up) reach it; -medium's
MID row stops at 3."""

from benchmark import program_trace


def probe(port):
    return program_trace.Probe()


def read(run):
    rec = program_trace.recorded(run, "stage2b_pc4_blocks_pct")
    if rec is None or not rec.counters.get("blocks.stage1"):
        return None
    c = rec.counters
    return 100.0 * c.get("blocks.stage2b.pc4", 0) / c["blocks.stage1"]
