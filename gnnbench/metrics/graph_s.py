"""Seconds of the port's host graph set-up: ``graph.build_host_graph``
(self loops, symmetric normalisation), ``graph.reorder_nodes`` and the
copy to the device, by the harness's clock around the calls."""


def read(record):
    return record["timers"].get("graph_s")
