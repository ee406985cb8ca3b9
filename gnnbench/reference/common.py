"""What the plain references of every family share: the graph as the
reference sees it (self loops, symmetric normalisation, the node
permutation, all worked out again from the raw COO), the rounding of the
lower-precision control, the masked loss and a plain AdamW.

Plain PyTorch in float32 with TF32 off; imports nothing of the port and
nothing of JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as tF


@dataclasses.dataclass
class RefGraph:
    senders: torch.Tensor      # int64 [E], self loops included
    receivers: torch.Tensor    # int64 [E]
    weight: torch.Tensor       # float32 [E], 1 / sqrt(in_deg[r] out_deg[s])
    perm: torch.Tensor         # int64 [N]: perm[new id] = original id
    n_node: int


def hubs_then_communities(deg: np.ndarray, community: np.ndarray
                          ) -> np.ndarray:
    """The node order the port is asked for ("hubs+labels"): the 2% of
    nodes of highest degree first, then the rest grouped by community;
    degree-descending inside each group, ties by original id."""
    n = deg.shape[0]
    k = max(int(n * 0.02), 1)
    cut = max(int(np.sort(deg)[::-1][k - 1]), 1)
    group = np.where(deg >= cut, -1, np.asarray(community, np.int64))
    return np.lexsort((np.arange(n), -deg, group)).astype(np.int64)


def prepare_graph(senders: torch.Tensor, receivers: torch.Tensor,
                  community: torch.Tensor, n: int) -> RefGraph:
    """The reference's graph from the raw COO (no self loops): a self loop
    on every node, the symmetric normalisation over in- and out-degrees
    counted with the loops, and the node permutation."""
    dev = senders.device
    loop = torch.arange(n, device=dev)
    s = torch.cat([senders.long(), loop])
    r = torch.cat([receivers.long(), loop])
    indeg = torch.bincount(r, minlength=n).double()
    outdeg = torch.bincount(s, minlength=n).double()
    w = (1.0 / torch.sqrt(torch.clamp(indeg[r] * outdeg[s], min=1.0))
         ).float()
    deg = (indeg + outdeg).long().cpu().numpy()
    perm = hubs_then_communities(deg, community.cpu().numpy())
    return RefGraph(s, r, w, torch.as_tensor(perm, device=dev), n)


# -- the control's rounding --------------------------------------------------

FP8_MAX = 448.0     # float8_e4m3fn's largest finite value


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale per tensor (its
    largest magnitude mapped to 448), returned in x's dtype."""
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8(x)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding point: float8 on the way in and on the way
    back."""
    return _Fp8.apply(x)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


ROUNDING: Dict[str, Callable] = {"float32": exact, "fp8": fp8_round}


# -- plain building blocks ---------------------------------------------------


def aggregate(h: torch.Tensor, g: RefGraph,
              weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[r] = sum over edges (s, r) of weight * h[s]."""
    msg = h.index_select(0, g.senders)
    if weight is not None:
        msg = msg * weight[:, None]
    return h.new_zeros((g.n_node, h.shape[1])).index_add_(0, g.receivers,
                                                           msg)


def masked_loss(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the masked nodes."""
    return tF.cross_entropy(logits[mask], labels[mask])


def train_steps(forward: Callable, params0: Mapping[str, torch.Tensor],
                g: RefGraph, x: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, opt: Mapping, steps: int,
                rnd: Callable = exact) -> Dict:
    """``steps`` full-batch steps of AdamW with decoupled weight decay and
    bias correction (PyTorch's and optax's update) from ``params0``.
    Returns each step's loss, the first step's gradient per leaf and each
    leaf's change after the last step."""
    lr, wd = float(opt["lr"]), float(opt["weight_decay"])
    b1, b2 = (float(b) for b in opt["betas"])
    eps = float(opt["eps"])
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    for t in range(1, steps + 1):
        loss = masked_loss(forward(p, g, x, rnd), labels, mask)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, w), gr in zip(p.items(), grads):
                if t == 1:
                    first[k] = gr.clone()
                w.mul_(1.0 - lr * wd)
                m[k].mul_(b1).add_(gr, alpha=1.0 - b1)
                v2[k].mul_(b2).addcmul_(gr, gr, value=1.0 - b2)
                denom = (v2[k] / (1.0 - b2 ** t)).sqrt_().add_(eps)
                w.addcdiv_(m[k], denom, value=-lr / (1.0 - b1 ** t))
        del loss, grads
    delta = {k: (p[k].detach() - params0[k]) for k in p}
    return {"losses": losses, "grad": first, "delta": delta}
