"""Seconds of the density splits in set-up: the port's ``lower.split``
spans (``graph.hybrid_graph`` of each forward graph and transposed twin
in ``compiler/fusion.lower_schedule``), summed; part of ``lower_s``."""
from gnnbench import spans


def read(record):
    return spans.seconds(spans.recorded(record, "setup", "lower.split"))
