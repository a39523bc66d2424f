"""device_idle_pct (layer device): the share of the traced stretch's
active part (every client encoding) in which no kernel, copy or fill of
any client ran on the card."""


def read(run):
    tr = run.trace
    if tr is None or tr.active is None or tr.window_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
