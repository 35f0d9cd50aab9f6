"""kernel_roofline.train: in the traced block, the sum of the bounds
(benchmark/counts/kernels.py) of the port's kernel calls over the device
time of its kernels, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.kernel_roofline(ctx) if 'steps' in ctx else None
