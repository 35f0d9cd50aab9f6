"""peak_mem_gib: torch.cuda.max_memory_allocated over the checked steps,
the warm-up and the window, in GiB."""


def read(ctx):
    return ctx['peak_bytes'] / 2 ** 30
