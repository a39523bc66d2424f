"""peak_mem_gib (layer device): ``torch.cuda.max_memory_allocated()`` of
the run's process, which holds every client, read after the stretch, in
GiB. It bounds how many clients share a card."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
