"""Block-diagonal graph batching for serving.

Counterpart of the JAX package's ``data/batching.py``.  B graphs batched
as one block-diagonal adjacency share one kernel sweep: node ids of graph
i are offset by the node counts of the graphs before it, the union COO
feeds the same tile and hybrid builders as a single graph, and per-graph
outputs come back by slicing or by a segment readout.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..graph import HostGraph, build_host_graph


def batch_graphs(graphs: Sequence[HostGraph], *,
                 edge_pad_multiple: int = 512
                 ) -> Tuple[HostGraph, np.ndarray]:
    """(batched, node_graph_id): one block-diagonal :class:`HostGraph` of
    ``graphs``, each keeping its own edge weights, and int32 [n_total], the
    graph that owns each node (the readout's segment map)."""
    offs = np.cumsum([0] + [g.n_node for g in graphs])
    s = np.concatenate(
        [g.senders[: g.n_edge] + offs[i] for i, g in enumerate(graphs)])
    r = np.concatenate(
        [g.receivers[: g.n_edge] + offs[i] for i, g in enumerate(graphs)])
    w = np.concatenate([g.edge_weight[: g.n_edge] for g in graphs])
    out = build_host_graph(s, r, int(offs[-1]), edge_weight=w,
                           edge_pad_multiple=edge_pad_multiple)
    gid = np.repeat(np.arange(len(graphs), dtype=np.int32),
                    [g.n_node for g in graphs])
    return out, gid


def batch_features(xs: Sequence[np.ndarray]) -> np.ndarray:
    """Per-graph node features [n_i, F] stacked in the node order of
    :func:`batch_graphs`, [sum n_i, F]."""
    return np.concatenate([np.asarray(x) for x in xs], axis=0)


def readout_mean(h: torch.Tensor, node_graph_id: torch.Tensor,
                 n_graphs: int) -> torch.Tensor:
    """Per-graph mean pooling, [N, F] -> [n_graphs, F], on ``h``'s device:
    two ``index_add_`` segment sums (features and node counts), the counts
    clamped at 1 so an empty graph reads 0."""
    idx = node_graph_id.to(device=h.device, dtype=torch.long)
    tot = h.new_zeros((n_graphs, h.shape[1])).index_add_(0, idx, h)
    cnt = h.new_zeros((n_graphs, 1)).index_add_(
        0, idx, h.new_ones((h.shape[0], 1)))
    return tot / cnt.clamp(min=1)
