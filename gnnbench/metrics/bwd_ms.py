"""Device milliseconds of a step's backward phase: per step of the traced
window, the union of the device intervals of the ops queued under the
port's ``train.backward`` span (``gnnbench/spans.py``), averaged."""


def read(record):
    a = record.get("span_trace")
    if not a or a["device_s"] <= 0 or "train.backward" not in a["phase_s"]:
        return None
    return a["phase_s"]["train.backward"] / a["units"] * 1e3
