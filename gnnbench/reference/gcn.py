"""GCN (Kipf and Welling, arXiv:1609.02907) as the configuration runs it:
each layer transforms first, then aggregates over the graph with self
loops and the symmetric normalisation, out = A_hat (h W), with no bias and
no activation between the layers (the reference op graph of the GTA
model zoo, genGraphOP.py:40-45, stacked)."""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from .common import RefGraph, aggregate, exact


def widths(cfg: Dict) -> List[int]:
    return ([cfg["features"]] + [cfg["hidden"]] * (cfg["layers"] - 1)
            + [cfg["classes"]])


def param_specs(cfg: Dict) -> List[Tuple[str, int, int]]:
    w = widths(cfg)
    return [(f"gcn_l{i}_w", w[i], w[i + 1]) for i in range(cfg["layers"])]


def forward(params: Mapping[str, torch.Tensor], g: RefGraph,
            x: torch.Tensor, rnd=exact) -> torch.Tensor:
    h = x
    i = 0
    while f"gcn_l{i}_w" in params:
        h = rnd(h) @ rnd(params[f"gcn_l{i}_w"])
        h = aggregate(rnd(h), g, rnd(g.weight))
        i += 1
    return h
