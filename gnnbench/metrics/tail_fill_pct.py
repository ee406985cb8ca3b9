"""Share of the edge-tiled tails' slots that hold an edge, over every
split of set-up: 100 x the ``tail_edges`` counters of the port's
``lower.split`` spans over their ``tail_slots`` (tiles x edges a tile).
An empty slot is work the tail kernels walk for nothing."""
from gnnbench import spans


def read(record):
    got = spans.recorded(record, "setup", "lower.split")
    slots = sum(s["counters"].get("tail_slots", 0) for s in got)
    if not slots:
        return None
    return 100.0 * sum(s["counters"].get("tail_edges", 0)
                       for s in got) / slots
