"""Peak device memory allocated over the traced window, in GiB (``torch.cuda.max_memory_allocated``)."""


def read(trace: dict) -> float:
    return trace["peak_bytes"] / 2**30
