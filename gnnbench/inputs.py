"""Inputs made from seeds, on the device: the graph, the weights, the
features, the labels and the split.  Both the program and the reference
are handed what these functions make, so nothing here imports either.

The graph is the configuration's dataset: it is drawn from the
configuration's own ``graph.seed``, so every run of a cell serves the same
graph and does the same kernel work; ``--seed`` draws everything else.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one named stream of ``seed``."""
    text = "/".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def community_coo(n: int, e: int, *, seed: int, communities: int,
                  p_in: float, alpha: float, device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(senders, receivers, community of each node) of a power-law
    community graph without self loops (multi-edges possible): ``e``
    receivers drawn with probability proportional to rank^-alpha over a
    random ranking of the nodes, and ``p_in`` of the senders drawn inside
    the receiver's community, the rest uniformly; draws with sender ==
    receiver are dropped.  The distribution of the port's
    ``synthetic_coo(..., communities=, p_in=)``, drawn on ``device``."""
    gen = generator(device, seed, "graph")
    p = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** -alpha
    cdf = torch.cumsum(p, 0)
    cdf = cdf / cdf[-1]
    rank = torch.randperm(n, generator=gen, device=device)
    u = torch.rand(e, generator=gen, dtype=torch.float64, device=device)
    receivers = rank[torch.searchsorted(cdf, u).clamp_(max=n - 1)]
    com_of = torch.randint(0, communities, (n,), generator=gen,
                           device=device)
    order = torch.argsort(com_of, stable=True)
    starts = torch.searchsorted(com_of[order].contiguous(),
                                torch.arange(communities + 1, device=device))
    sizes = (starts[1:] - starts[:-1]).clamp(min=1)
    intra = torch.rand(e, generator=gen, device=device) < p_in
    rc = com_of[receivers]
    off = (torch.rand(e, generator=gen, dtype=torch.float64, device=device)
           * sizes[rc]).long()
    inside = order[(starts[rc] + off).clamp_(max=n - 1)]
    cross = torch.randint(0, n, (e,), generator=gen, device=device)
    senders = torch.where(intra, inside, cross)
    keep = senders != receivers
    return (senders[keep].to(torch.int32), receivers[keep].to(torch.int32),
            com_of)


def make_graph(cfg: Dict, device):
    g = cfg["graph"]
    return community_coo(cfg["nodes"], cfg["edges"], seed=g["seed"],
                         communities=g["communities"], p_in=g["p_in"],
                         alpha=g["alpha"], device=device)


def make_weights(specs: List[Tuple[str, int, int]], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Glorot-uniform float32 weights, one draw for all of them."""
    gen = generator(device, seed, "weights")
    total = sum(i * o for _, i, o in specs)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, i, o in specs:
        limit = (6.0 / (i + o)) ** 0.5
        out[name] = ((2.0 * u[at:at + i * o] - 1.0) * limit).view(i, o)
        at += i * o
    return out


def make_features(cfg: Dict, seed: int, index: int, device) -> torch.Tensor:
    """Feature matrix ``index`` of the seed's pool: standard normal
    [nodes, features] float32."""
    gen = generator(device, seed, "x", index)
    return torch.randn((cfg["nodes"], cfg["features"]), generator=gen,
                       device=device)


def make_labels(cfg: Dict, seed: int, x: torch.Tensor) -> torch.Tensor:
    """A learnable label per node: the class a random linear probe of the
    features scores highest (computed in float64, so no matrix-product
    algorithm can change a label)."""
    gen = generator(x.device, seed, "probe")
    wy = torch.randn((cfg["features"], cfg["classes"]), generator=gen,
                     dtype=torch.float64, device=x.device)
    rows = 16384     # row blocks: a float64 copy of x would set the peak
    return torch.cat([(x[i:i + rows].double() @ wy).argmax(dim=1)
                      for i in range(0, x.shape[0], rows)])


def make_train_mask(cfg: Dict, seed: int, device) -> torch.Tensor:
    """The training nodes of a random split with the published sizes
    (train, validation, test)."""
    n_train = cfg["split"][0]
    gen = generator(device, seed, "split")
    order = torch.randperm(cfg["nodes"], generator=gen, device=device)
    mask = torch.zeros(cfg["nodes"], dtype=torch.bool, device=device)
    mask[order[:n_train]] = True
    return mask
