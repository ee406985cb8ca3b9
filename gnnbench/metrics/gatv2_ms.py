"""Device milliseconds per forward in K17, GATv2's attention
(``csrc/gatv2_attn.cu``: ``gatv2_attn_kernel`` and its finishing kernel
``gatv2_finish_kernel``): the traced window's device ops whose name holds
``gatv2``, over its units.  None where the trace has none, as on a
program without K17.

The record's ``device_ops`` are ``trace.summarize``'s heaviest ops only
(``trace.TOP``), not every device op.  A list shorter than that holds
every op of the window, so a missing finishing kernel means no row was
cut.  A full list without the finishing kernel may have pushed it out
while the walk stayed in: the sum would then read low (and
``gatv2_roofline_pct`` high), so the reader returns None there."""

from gnnbench import trace

NAME = "gatv2"
FINISH = "gatv2_finish_kernel"


def read(record):
    t = record.get("trace")
    if not t or not t["units"]:
        return None
    ops = t["device_ops"]
    got = [s for name, s in ops if NAME in name]
    if not got:
        return None
    if len(ops) >= trace.TOP and not any(FINISH in name for name, _ in ops):
        return None
    return sum(got) / t["units"] * 1e3
