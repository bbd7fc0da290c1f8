"""``torch.cuda.max_memory_allocated()`` over the window, in GiB."""


def read(t):
    if not t.peak_mem_bytes:
        return None
    return t.peak_mem_bytes / 2**30
