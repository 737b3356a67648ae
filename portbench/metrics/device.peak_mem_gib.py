"""device.peak_mem_gib: `torch.cuda.max_memory_allocated()` over the
warm-up and the window, its statistics reset once the weights are on the
card, in GiB."""


def read(ctx):
    return ctx.window_peak_bytes / 2 ** 30 if ctx.window_peak_bytes else None
