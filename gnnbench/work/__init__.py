"""The work one forward or one training step needs, per model family
(``work/<family>.py``: ``forward_ops(cfg, n, e)``, ``step_ops(cfg, n,
e)``), as (name, FLOPs, bytes) per model op.

Counted from the node and edge counts, the widths, the heads and the
dtype alone, never from what an implementation touches (tiles, slots,
padding, the chosen fusion): every input of an op is read once and every
output written once.  The input features and the logits are counted as
float32 (what the caller hands in and gets back), weights and optimizer
state as float32, activations in the configuration's compute dtype, the
graph as CSR (int32 column per edge, int32 row pointer per node, a
float32 weight per edge where the model weights its edges), labels as
int32 and the mask as one byte a node."""
from __future__ import annotations

from typing import Dict, List, NamedTuple

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


class Op(NamedTuple):
    name: str
    flops: float
    bytes: float


def act_bytes(cfg: Dict) -> int:
    return DTYPE_BYTES[cfg["dtype"]]


def graph_bytes(n: int, e: int, weighted: bool) -> int:
    return 4 * e + 4 * (n + 1) + (4 * e if weighted else 0)


def loss_ops(cfg: Dict, n: int) -> List[Op]:
    """Masked softmax cross-entropy and its gradient, over every node's
    logits (a fixed mask selects among them)."""
    c = cfg["classes"]
    return [Op("loss", 5.0 * n * c, 4 * n * c + 4 * n + n + 4 * n * c)]


def optimizer_ops(n_params: int) -> List[Op]:
    """AdamW: reads parameter, gradient and both moments, writes the
    parameter and the moments."""
    return [Op("adamw", 12.0 * n_params, 7 * 4 * n_params)]


def totals(ops: List[Op]) -> Dict[str, float]:
    return {"flops": float(sum(o.flops for o in ops)),
            "bytes": float(sum(o.bytes for o in ops))}
