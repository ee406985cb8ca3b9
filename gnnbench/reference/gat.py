"""GAT (Velickovic et al., arXiv:1710.10903) as the configuration runs it:
per layer h = x W, per-head logits e = leaky_relu(a_s[s] + a_d[r], 0.2)
with a_s = h A_src and a_d = h A_dst ([HD, H] matrices, as in the GTA
reference op graph, genGraphOP.py:47-62), a softmax over each receiver's
incoming edges (self loops included), the heads' messages concatenated
head-major; ELU after every layer but the last, which has one head and
emits the logits."""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as tF

from .common import RefGraph, exact

SLOPE = 0.2


def layer_shapes(cfg: Dict) -> List[Tuple[int, int, int]]:
    """(in width, out width, heads) per layer."""
    out, w = [], cfg["features"]
    for i in range(cfg["layers"]):
        last = i == cfg["layers"] - 1
        o = cfg["classes"] if last else cfg["hidden"]
        out.append((w, o, 1 if last else cfg["heads"]))
        w = o
    return out


def param_specs(cfg: Dict) -> List[Tuple[str, int, int]]:
    specs = []
    for i, (f, o, h) in enumerate(layer_shapes(cfg)):
        specs += [(f"gat_l{i}_w", f, o), (f"gat_l{i}_asrc", o, h),
                  (f"gat_l{i}_adst", o, h)]
    return specs


def attention_layer(x: torch.Tensor, w: torch.Tensor, a_src: torch.Tensor,
                    a_dst: torch.Tensor, g: RefGraph, rnd=exact
                    ) -> torch.Tensor:
    heads = a_src.shape[1]
    h = rnd(rnd(x) @ rnd(w))
    d = h.shape[1] // heads
    a_s = h @ rnd(a_src)
    a_d = h @ rnd(a_dst)
    e = a_s.index_select(0, g.senders) + a_d.index_select(0, g.receivers)
    e = torch.where(e >= 0, e, SLOPE * e)
    top = torch.full((g.n_node, heads), float("-inf"), device=e.device)
    top = top.scatter_reduce(0, g.receivers[:, None].expand_as(e),
                             e.detach(), "amax")
    p = torch.exp(e - top.index_select(0, g.receivers))
    den = p.new_zeros((g.n_node, heads)).index_add_(0, g.receivers, p)
    msg = (rnd(p).repeat_interleave(d, dim=1)
           * h.index_select(0, g.senders))
    num = h.new_zeros((g.n_node, h.shape[1])).index_add_(0, g.receivers,
                                                         msg)
    return num / den.repeat_interleave(d, dim=1)


def forward(params: Mapping[str, torch.Tensor], g: RefGraph,
            x: torch.Tensor, rnd=exact) -> torch.Tensor:
    h = x
    i = 0
    while f"gat_l{i}_w" in params:
        h = attention_layer(h, params[f"gat_l{i}_w"],
                            params[f"gat_l{i}_asrc"],
                            params[f"gat_l{i}_adst"], g, rnd)
        i += 1
        if f"gat_l{i}_w" in params:
            h = tF.elu(h)
    return h
