"""k4_roofline (layer kernels): K4's (partition search, ``csrc/psearch.cu``)
share of its roofline in the traced stretch: the sum of each launch's
bound, the larger of its bytes over 3.35 TB/s and its float operations
over 67 TFLOP/s (``benchmark/roofline_k4.py``), over the sum of the
launches' device time. The launches' shapes are recorded by wrapping the
port's ``ops.psearch.line_errors_cuda`` during the stretch."""

import importlib

from benchmark import roofline, roofline_k4


def probe(port):
    return roofline_k4.K4Calls(
        importlib.import_module("astcenc_torch.ops.psearch"))


def read(run):
    tr = run.trace
    calls = run.probes.get("k4_roofline")
    peak = roofline.peaks(run.device_name)
    if tr is None or calls is None or not calls.calls or peak is None:
        return None
    ns = sum(e - s for s, e, name, _ in tr.device
             if tr.source_of(name) == "psearch")
    if not ns:
        return None
    return 100.0 * calls.bounds_ms(peak) / (ns / 1e6)
