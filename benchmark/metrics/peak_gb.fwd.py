"""peak_gb.fwd: `torch.cuda.max_memory_allocated()` over the window (after
`reset_peak_memory_stats()` at its start), in 1e9 bytes."""


def read(run):
    return run.window_peak_bytes / 1e9 if run.window_peak_bytes else None
