"""setup_s: seconds from the process's start to the window's, on the host
clock: imports, the CUDA context, the kernels' build or load, the seeded
model and pool, the checked steps and the warm-up."""


def read(ctx):
    return ctx['setup_s']
