"""psearch_partitionings_per_block (layer codec glue): the candidate
partitionings whose line errors the partition search scored, per block of
the traced stretch, from the program's counters: the sum over p of
``psearch.partitionings.pc<p>`` over ``blocks.stage1``. The width of the
search the preset row asks for (S of 34 and 28 at -medium's 2 and 3
partitions, 82, 60 and 30 at -thorough's 2, 3 and 4) times the share of
blocks that reach each count. A program without the counter reads
nothing."""

from benchmark import program_trace


def probe(port):
    return program_trace.Probe()


def read(run):
    rec = program_trace.recorded(run, "psearch_partitionings_per_block")
    if rec is None or not rec.counters.get("blocks.stage1"):
        return None
    c = rec.counters
    if not any(k.startswith("psearch.partitionings.pc") for k in c):
        return None
    return (program_trace.counter_sum(c, "psearch.partitionings.pc")
            / c["blocks.stage1"])
