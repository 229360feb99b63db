"""setup_s (host clock): from the process's start to the first timed call:
imports, the CUDA context, loading (or, in a fresh checkout, building) the
kernels, making the pool and the warm-up."""


def read(run):
    return run.setup_s
