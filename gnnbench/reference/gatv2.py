"""GATv2 (Brody, Alon and Yahav, "How Attentive are Graph Attention
Networks?", arXiv:2105.14491) as the configuration runs it.  Per layer
and head h, with i the receiver of edge (j, i), self loops included:

    u = x W_l,  v = x W_r                         (F -> H*C each)
    e_ij,h  = a_h . leaky_relu(u_j,h + v_i,h, 0.2)  (a_h in R^C)
    alpha   = softmax over j of e_ij,h
    out_i,h = sum_j alpha_ij,h u_j,h

The hidden layer's heads are concatenated head-major, ELU runs between
the layers, and the last layer has one head and emits raw logits.  This
is PyG's ``GATv2Conv`` with ``share_weights=False``; departures from it
(the configuration's ``assumed``): no bias, no dropout.  ``rnd`` rounds
where the program rounds to its compute dtype: x and the two weights
before each product, and u and v; the attention vectors, the scores and
the sums stay float32.  Each softmax's exponent is taken in float64 and
rounded once to float32 (the correctly rounded float32 exponent, whatever
the device's library).

The attention walks the edges in blocks of ``EDGE_BLOCK``, so that the
full graph fits beside the program's freed state: the scores [E, H] are
kept whole for the segment max, and the messages are made block by
block.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as tF

from .common import RefGraph, exact

SLOPE = 0.2
EDGE_BLOCK = 1 << 20


def layer_shapes(cfg: Dict) -> List[Tuple[int, int, int]]:
    """(in width, out width H*C, heads H) per layer."""
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
        specs += [(f"gatv2_l{i}_wl", f, o), (f"gatv2_l{i}_wr", f, o),
                  (f"gatv2_l{i}_att", h, o // h)]
    return specs


def attention(u: torch.Tensor, v: torch.Tensor, att: torch.Tensor,
              g: RefGraph, block: int = EDGE_BLOCK) -> torch.Tensor:
    """out [N, H*C] of GATv2's attention over ``g``'s edges, in blocks of
    ``block`` edges."""
    n, HC = u.shape
    H, C = att.shape
    spans = [(a, a + block) for a in range(0, g.senders.shape[0], block)]
    scores = []
    for a, b in spans:
        z = u.index_select(0, g.senders[a:b]) + v.index_select(
            0, g.receivers[a:b])
        z = torch.where(z >= 0, z, SLOPE * z)
        scores.append((z.view(-1, H, C) * att).sum(-1))
        del z
    e = torch.cat(scores)
    del scores
    top = e.new_full((n, H), float("-inf")).scatter_reduce(
        0, g.receivers[:, None].expand_as(e), e.detach(), "amax")
    den = e.new_zeros((n, H))
    num = u.new_zeros((n, HC))
    for a, b in spans:
        rcv = g.receivers[a:b]
        p = torch.exp((e[a:b] - top.index_select(0, rcv)).double()).float()
        den = den.index_add(0, rcv, p)
        num = num.index_add(0, rcv, p.repeat_interleave(C, dim=1)
                            * u.index_select(0, g.senders[a:b]))
        del p
    return num / den.repeat_interleave(C, dim=1)


def layer(x: torch.Tensor, p: Mapping[str, torch.Tensor], i: int,
          g: RefGraph, rnd=exact, block: int = EDGE_BLOCK) -> torch.Tensor:
    xr = rnd(x)
    u = rnd(xr @ rnd(p[f"gatv2_l{i}_wl"]))
    v = rnd(xr @ rnd(p[f"gatv2_l{i}_wr"]))
    return attention(u, v, p[f"gatv2_l{i}_att"], g, block)


def forward(params: Mapping[str, torch.Tensor], g: RefGraph,
            x: torch.Tensor, rnd=exact, block: int = EDGE_BLOCK
            ) -> torch.Tensor:
    h = x
    i = 0
    while f"gatv2_l{i}_wl" in params:
        h = layer(h, params, i, g, rnd, block)
        i += 1
        if f"gatv2_l{i}_wl" in params:
            h = tF.elu(h)
    return h
