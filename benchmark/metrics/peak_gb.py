"""peak_gb: `torch.cuda.max_memory_allocated()` over the window (reset
after set-up), in GB (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.on_card else None
