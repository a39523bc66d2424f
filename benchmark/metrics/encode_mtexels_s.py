"""encode_mtexels_s: the texels of every texture that the clients encoded
in the window, over the window's seconds, in millions. An encode that the
window's close cuts counts for the share of its time inside the window."""

from benchmark import stats


def read(run):
    t0, t1 = run.window
    return stats.window_work(run.window_spans, t0, t1) / (t1 - t0) / 1e6
