"""peak_mem_gib.<suffix>: ``torch.cuda.max_memory_allocated()`` over the
window, the peak statistics reset at its start, in GiB."""


def read(rec):
    peak = rec.memory.get("window_peak_bytes")
    return None if not peak else peak / 2**30
