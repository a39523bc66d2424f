"""kernel_launches_per_mtexel (layer kernels): launches of the port's own
CUDA kernels in the traced stretch, per million texels, from the
program's counters (``launch.<kernel>``; the forms' ``launch.<kernel>.<form>``
count the same launches again and are left out)."""

from benchmark import program_trace


def probe(port):
    return program_trace.Probe()


def read(run):
    rec = program_trace.recorded(run, "kernel_launches_per_mtexel")
    if rec is None:
        return None
    return (program_trace.counter_sum(rec.counters, "launch.", 2)
            / run.trace.mtexels)
