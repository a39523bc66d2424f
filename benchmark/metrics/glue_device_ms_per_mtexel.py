"""glue_device_ms_per_mtexel (layer codec): device time of every
operation in the traced stretch that is not one of the port's own CUDA
kernels (PyTorch's kernels, copies and fills), per million texels."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or not tr.texels:
        return None
    ns = sum(e - s for s, e, name, _ in tr.device
             if not tr.is_port_kernel(name))
    return ns / 1e6 / tr.mtexels
