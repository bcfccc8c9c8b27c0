"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start."""


def read(rec):
    peak = rec.get("peak_mem_bytes")
    return None if not peak else peak / 2 ** 30
