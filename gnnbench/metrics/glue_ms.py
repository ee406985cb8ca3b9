"""Device milliseconds per forward or step in PyTorch's own kernels and
copies (ATen elementwise, casts, reductions, indexing, memcpy, memset):
the glue around the port's kernels, from the traced window."""


def read(record):
    t = record["trace"]
    if not t or t["n_device_events"] == 0:
        return None
    return t["by_class"]["glue"] / t["units"] * 1e3
