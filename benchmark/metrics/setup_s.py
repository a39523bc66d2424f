"""setup_s: from the process's start to the window's opening: imports,
the kernels built or loaded, the texture set made from the seed, the
contexts, and every client's warm-up encode."""


def read(run):
    return run.setup_s
