"""Share of the traced window in which no operation ran on the device
(100 - the union of the device intervals over the window)."""


def read(record):
    t = record["trace"]
    if not t or t["n_device_events"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
