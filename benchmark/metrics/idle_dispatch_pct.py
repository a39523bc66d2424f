"""idle_dispatch_pct (layer device): the share of the traced stretch's
active part in which the card was idle while a client's thread was inside
the program's ``compress_image`` span but in none of its preparation
spans: dispatching the glue, or waiting in a ``sync``. With
``idle_prep_pct`` it accounts for the idle time inside the encodes; the
rest of ``device_idle_pct`` lies between them, in the harness."""

from benchmark import program_trace


def probe(port):
    return program_trace.Probe()


def read(run):
    split = program_trace.idle_by_class(run, "idle_dispatch_pct")
    if split is None or split[2] <= 0:
        return None
    return 100.0 * split[1] / split[2]
