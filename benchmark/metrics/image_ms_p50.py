"""image_ms_p50 (layer api): the median of every texture's time in the
window, over all clients, from the harness's spans around each
``compress_image`` call."""

from benchmark import stats


def read(run):
    ms = [(s.end - s.start) * 1e3 for s in run.window_spans]
    return stats.percentile(ms, 50.0) if ms else None
