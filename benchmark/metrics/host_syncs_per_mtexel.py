"""host_syncs_per_mtexel (layer codec glue): the points in the traced
stretch at which the host waited on the card (a ``nonzero``, a scalar
read, a blocking copy either way), per million texels, from the program's
counters (``sync.<site>``)."""

from benchmark import program_trace


def probe(port):
    return program_trace.Probe()


def read(run):
    rec = program_trace.recorded(run, "host_syncs_per_mtexel")
    if rec is None:
        return None
    return program_trace.counter_sum(rec.counters, "sync.") / run.trace.mtexels
