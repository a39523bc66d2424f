"""device_ops_per_mtexel (layer codec): kernels, copies and fills that ran
on the card in the traced stretch, per million texels the stretch's
encodes completed."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or not tr.texels:
        return None
    return len(tr.device) / tr.mtexels
