"""idle_prep_pct (layer device): the share of the traced stretch's active
part in which the card was idle (the gaps ``device_idle_pct`` sums) while
a client's thread was in host preparation: the program's
``image_to_blocks``, ``h2d``, ``d2h`` or ``assemble`` span."""

from benchmark import program_trace


def probe(port):
    return program_trace.Probe()


def read(run):
    split = program_trace.idle_by_class(run, "idle_prep_pct")
    if split is None or split[2] <= 0:
        return None
    return 100.0 * split[0] / split[2]
