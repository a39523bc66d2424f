"""sync_wait_ms_per_mtexel (layer codec glue): the host's time inside the
program's ``sync`` spans in the traced stretch (each a wait on the card,
the blocking copies' transfer included), per million texels."""

from benchmark import program_trace


def probe(port):
    return program_trace.Probe()


def read(run):
    rec = program_trace.recorded(run, "sync_wait_ms_per_mtexel")
    if rec is None:
        return None
    ns = sum(e - s for s, e in program_trace.intervals(rec, ("sync",)))
    return ns / 1e6 / run.trace.mtexels
