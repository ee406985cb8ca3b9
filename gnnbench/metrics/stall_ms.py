"""Device milliseconds idle inside one request or step: per unit of the
traced window, the time between its first and last device op that no op
of it covers (``gnnbench/spans.py``; the gap between units, where the
harness synchronises, is left out), averaged over the units."""


def read(record):
    a = record.get("span_trace")
    if not a or a["device_s"] <= 0 or not a["units"]:
        return None
    return a["stall_s"] / a["units"] * 1e3
