"""Host milliseconds to queue one request or step: the mean duration of
the port's unit spans (``model.forward`` of a request, ``train.step`` of
a step) in the traced window, by the host's clock."""
from gnnbench import spans


def read(record):
    got = (record.get("spans") or {}).get("window") or {}
    units = [s for s in got.get("spans", ()) if s["id"] == s["unit"]
             and s["name"] in spans.UNIT_NAMES]
    if not units:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in units) / len(units) / 1e6
