"""k1_roofline (layer kernels): K1's (mode search, ``csrc/msearch.cu``)
share of its roofline in the traced stretch: the sum of each launch's
bound, the larger of its bytes over 3.35 TB/s and its float operations
over 67 TFLOP/s (``benchmark/roofline.py``), over the sum of the launches'
device time. The launches' shapes are recorded by wrapping the port's
``ops.msearch.mode_search`` during the stretch."""

from benchmark import roofline


def probe(port):
    return roofline.K1Calls(port.msearch)


def read(run):
    tr = run.trace
    calls = run.probes.get("k1_roofline")
    peak = roofline.peaks(run.device_name)
    if tr is None or calls is None or not calls.calls or peak is None:
        return None
    ns = sum(e - s for s, e, name, _ in tr.device
             if tr.source_of(name) == "msearch")
    if not ns:
        return None
    return 100.0 * calls.bounds_ms(peak) / (ns / 1e6)
