"""Device milliseconds per forward in K13, the pair aggregation
(``csrc/pair_agg.cu``): the traced window's device ops whose name holds
``pair_agg``, over its units.  None where the trace has none.

The record's ``device_ops`` are ``trace.summarize``'s heaviest ops only
(``trace.TOP``, 10), not every device op: the reader relies on K13 being
among them, as it is in ``pna2_e11m_serve``, where it is the heaviest.
Were K13 to fall out of that list, or be split into several kernel names
some of which fall out, this would read None or a partial sum (and
``pair_roofline_pct`` too high); the readers need the full by-name device
totals for that, which ``run.py`` does not hand them yet."""

NAME = "pair_agg"


def read(record):
    t = record["trace"]
    if not t or not t["units"]:
        return None
    got = [s for name, s in t["device_ops"] if NAME in name]
    if not got:
        return None
    return sum(got) / t["units"] * 1e3
