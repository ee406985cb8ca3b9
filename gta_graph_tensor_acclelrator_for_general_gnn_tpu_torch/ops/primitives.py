"""Per-op implementations of the four IR primitives on torch tensors.

The port's per-op path and its end-to-end oracle (the JAX package's XLA
path): scatter is ``index_select``, gather is ``index_add_`` or
``scatter_reduce``, and node/edge appliers are elementwise ops or a matrix
product.  Semantics follow the JAX ``ops/primitives.py``:

  scatter  ORDER=C: node rows broadcast to edges by sender;
           ORDER=R: by receiver.  Padding edges read a zero dump row.
  gather   segment-reduce edge rows to their receiver (ADD / MAX / MEAN);
           padding edges land in the dump segment ``n_node``, sliced away.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as tF

from .. import ir
from ..graph import GraphTensor


def scatter_to_edges(x: torch.Tensor, g: GraphTensor,
                     order: str = "C") -> torch.Tensor:
    """Node [N, F] -> edge [E_pad, F]."""
    idx = g.senders if order == "C" else g.receivers
    x1 = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)
    return x1.index_select(0, idx)


def gather_to_nodes(e: torch.Tensor, g: GraphTensor, reduce: str = ir.ADD,
                    order: str = "R") -> torch.Tensor:
    """Edge [E_pad, F] -> node [N, F] segment reduction."""
    idx = g.receivers if order == "R" else g.senders
    num = g.n_node + 1
    shape = (num,) + tuple(e.shape[1:])
    if reduce == ir.ADD:
        out = e.new_zeros(shape).index_add_(0, idx, e)
    elif reduce == ir.MAX:
        out = e.new_full(shape, float("-inf")).scatter_reduce_(
            0, idx.view(-1, *([1] * (e.dim() - 1))).expand_as(e), e, "amax")
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    elif reduce == ir.MEAN:
        s = e.new_zeros(shape).index_add_(0, idx, e)
        d = e.new_zeros(num).index_add_(0, idx, g.edge_mask.to(e.dtype))
        out = s / torch.clamp(d, min=1.0)[:, None]
    else:
        raise ValueError(f"bad gather reduce {reduce}")
    return out[: g.n_node]


_SF_FNS: Dict[str, Callable] = {
    "relu": torch.relu,
    "exp": torch.exp,
    "elu": tF.elu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": lambda x: x,
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
}


def special_function(x: torch.Tensor, name: str,
                     negative_slope: float = 0.2) -> torch.Tensor:
    if name == "leaky_relu":
        # where(x >= 0): jax.nn.leaky_relu, whose gradient at 0 is 1 (as
        # the backward kernels take it); tF.leaky_relu's is the slope
        return torch.where(x >= 0, x, negative_slope * x)
    fn = _SF_FNS.get(name)
    if fn is None:
        raise ValueError(f"unknown SF {name}")
    return fn(x)


def _broadcast_pair(a: torch.Tensor, b: torch.Tensor):
    """Equal widths as-is; width 1 broadcasts; when one width divides the
    other the narrow operand repeats head-major (alpha [E, H] against
    h [E, H*D]: each head's value repeated D times)."""
    fa, fb = a.shape[-1], b.shape[-1]
    if fa == fb or fa == 1 or fb == 1:
        return a, b
    if fb > fa and fb % fa == 0:
        return a.repeat_interleave(fb // fa, dim=-1), b
    if fa > fb and fa % fb == 0:
        return a, b.repeat_interleave(fa // fb, dim=-1)
    raise ValueError(f"incompatible widths {fa} vs {fb}")


def binary_op(compute: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _broadcast_pair(a, b)
    if compute == ir.ADD:
        return a + b
    if compute == ir.MUL:
        return a * b
    if compute == ir.SUB:
        return a - b
    if compute == ir.DIV:
        return a / b
    raise ValueError(f"bad binary compute {compute}")


def dense_mm(x: torch.Tensor, w: torch.Tensor,
             compute_dtype=None) -> torch.Tensor:
    """X @ W with float32 accumulation and a float32 result (float64 when X
    is float64, so the per-op path can serve as a float64 yardstick).

    ``compute_dtype=torch.bfloat16`` rounds both operands to bf16 first (the
    production policy); their products are exact in float32, so the f32
    product of the rounded operands is what the JAX package computes with
    ``preferred_element_type=float32``."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc) @ w.to(acc)
