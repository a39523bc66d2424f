"""kernel_device_ms_per_mtexel (layer kernels): device time of the kernels
whose symbols are defined in ``astcenc_torch/csrc/``, in the traced
stretch, per million texels."""


def read(run):
    tr = run.trace
    if tr is None or not tr.texels:
        return None
    ns = sum(e - s for s, e, name, _ in tr.device if tr.is_port_kernel(name))
    return ns / 1e6 / tr.mtexels if ns else None
