"""Device milliseconds per forward or step outside the glue and outside
the vendor matrix products: the port's hand-written kernels, from the
traced window."""


def read(record):
    t = record["trace"]
    if not t or t["n_device_events"] == 0:
        return None
    return t["by_class"]["kernel"] / t["units"] * 1e3
