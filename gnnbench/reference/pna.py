"""PNA as published (Corso, Cavalleri, Beaini, Lio and Velickovic,
arXiv:2004.05718), as the configuration runs it.  Per layer, with i the
receiver of edge (j, i), self loops included:

    m_ij  = x_i W_dst + x_j W_src                      (one pre-layer)
    A_i   = [mean | min | max | std] of m_ij over i's incoming edges,
            std = sqrt(relu(mean(m^2) - mean(m)^2) + 1e-5)
    out_i = x_i W_x + A_i W_id + amp_i (A_i W_amp) + att_i (A_i W_att)

with the degree scalers amp = log(d+1) / delta and att = delta / log(d+1),
d the node's in-degree (at least 1) and delta the mean of log(d+1) over
the nodes: the post-transform U([x | A | amp A | att A]) with U split by
rows into W_x, W_id, W_amp and W_att.  ReLU between the layers, raw
logits at the end.  Departures from the paper: one tower, no bias, no
batch norm, no residual (listed in the configuration's ``assumed``).

The aggregation walks the edges in blocks (``EDGE_BLOCK``), so that the
full graph fits beside the program's freed state.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from .common import RefGraph, exact

STD_EPS = 1e-5
EDGE_BLOCK = 1 << 20
WEIGHTS = ("wsrc", "wdst", "wx", "wid", "wamp", "watt")


def widths(cfg: Dict) -> List[int]:
    return ([cfg["features"]] + [cfg["hidden"]] * (cfg["layers"] - 1)
            + [cfg["classes"]])


def param_specs(cfg: Dict) -> List[Tuple[str, int, int]]:
    w, D = widths(cfg), cfg["hidden"]
    specs = []
    for i in range(cfg["layers"]):
        f, o = w[i], w[i + 1]
        specs += [(f"pna4_l{i}_wsrc", f, D), (f"pna4_l{i}_wdst", f, D),
                  (f"pna4_l{i}_wx", f, o), (f"pna4_l{i}_wid", 4 * D, o),
                  (f"pna4_l{i}_wamp", 4 * D, o),
                  (f"pna4_l{i}_watt", 4 * D, o)]
    return specs


def degree_scalers(g: RefGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(amplification, attenuation) per node, [N, 1] float32."""
    d = torch.bincount(g.receivers, minlength=g.n_node).float()
    logd = torch.log(d.clamp(min=1.0) + 1.0)
    delta = logd.mean()
    return (logd / delta)[:, None], (delta / logd)[:, None]


def aggregate(u: torch.Tensor, v: torch.Tensor, g: RefGraph, rnd=exact,
              block: int = EDGE_BLOCK) -> torch.Tensor:
    """[mean | min | max | std] [N, 4D] of m = v[receiver] + u[sender], m
    rounded by ``rnd`` where the program rounds it, over blocks of
    ``block`` edges."""
    n, D = u.shape
    s1 = u.new_zeros((n, D))
    s2 = u.new_zeros((n, D))
    lo = u.new_full((n, D), float("inf"))
    hi = u.new_full((n, D), float("-inf"))
    for a in range(0, g.senders.shape[0], block):
        snd, rcv = g.senders[a:a + block], g.receivers[a:a + block]
        m = rnd(v.index_select(0, rcv) + u.index_select(0, snd))
        idx = rcv[:, None].expand_as(m)
        s1 = s1.index_add(0, rcv, m)
        s2 = s2.index_add(0, rcv, m * m)
        lo = lo.scatter_reduce(0, idx, m, "amin")
        hi = hi.scatter_reduce(0, idx, m, "amax")
        del m, idx
    cnt = torch.bincount(g.receivers, minlength=n).float().clamp(min=1.0)
    mean = s1 / cnt[:, None]
    std = torch.sqrt(torch.relu(s2 / cnt[:, None] - mean * mean) + STD_EPS)
    return torch.cat([mean, lo, hi, std], dim=1)


def layer(x: torch.Tensor, p: Mapping[str, torch.Tensor], i: int,
          g: RefGraph, amp: torch.Tensor, att: torch.Tensor, rnd=exact
          ) -> torch.Tensor:
    w = {k: rnd(p[f"pna4_l{i}_{k}"]) for k in WEIGHTS}
    xr = rnd(x)
    u = rnd(xr @ w["wsrc"])
    v = rnd(xr @ w["wdst"])
    a = rnd(aggregate(u, v, g, rnd))
    return (xr @ w["wx"] + a @ w["wid"] + amp * (a @ w["wamp"])
            + att * (a @ w["watt"]))


def forward(params: Mapping[str, torch.Tensor], g: RefGraph,
            x: torch.Tensor, rnd=exact) -> torch.Tensor:
    amp, att = degree_scalers(g)
    h = x
    i = 0
    while f"pna4_l{i}_wsrc" in params:
        h = layer(h, params, i, g, amp, att, rnd)
        i += 1
        if f"pna4_l{i}_wsrc" in params:
            h = torch.relu(h)
    return h
