"""Seconds of the transposed graph's build in set-up (training): the
port's ``lower.transpose`` span (``graph.transpose_host_graph``); part
of ``lower_s``."""
from gnnbench import spans


def read(record):
    return spans.seconds(spans.recorded(record, "setup", "lower.transpose"))
