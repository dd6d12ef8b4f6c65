"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, reset at
its start (the keys and the index, allocated before, are counted)."""


def read(run):
    return run["peak_bytes"] / 2**30
