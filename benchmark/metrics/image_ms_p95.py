"""image_ms_p95 (layer api): the 95th percentile of every texture's time in
the window, over all clients: from its ``compress_image`` call to its
blocks on the host, from the harness's spans."""

from benchmark import stats


def read(run):
    ms = [(s.end - s.start) * 1e3 for s in run.window_spans]
    return stats.percentile(ms, 95.0) if ms else None
