"""GATv2 (``reference/gatv2.py``): per layer the two products of the
layer's input, x [W_l | W_r] (``mm``: u and v in the compute dtype), and
the attention (``attn``: per edge and feature the message u_j + v_i, the
leaky ReLU, the head dot's multiply-add and the weighted sum's
multiply-add; per edge and head the receiver's max, the subtraction, the
exponent and the denominator's sum; per node and feature the division,
and ELU on all but the last layer), which reads u, v, the attention
vectors and the CSR once and writes the layer's output once.  The step
adds the loss, each op's backward and AdamW.

``run.py`` hands a per-layer metric only the totals of the work, so
``forward_ops`` keeps the op list of its last call in ``LAST_FORWARD_OPS``
for the reader of ``gatv2_roofline_pct``, which uses it only where its
totals are the record's."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import Op, act_bytes, graph_bytes, loss_ops, optimizer_ops

LAST_FORWARD_OPS: Optional[List[Op]] = None


def _layers(cfg: Dict) -> List[Tuple[int, int, int]]:
    """(in width, out width H*C, heads H) per layer."""
    out, w = [], cfg["features"]
    for i in range(cfg["layers"]):
        last = i == cfg["layers"] - 1
        o = cfg["classes"] if last else cfg["hidden"]
        out.append((w, o, 1 if last else cfg["heads"]))
        w = o
    return out


def forward_ops(cfg: Dict, n: int, e: int) -> List[Op]:
    global LAST_FORWARD_OPS
    ba, last = act_bytes(cfg), cfg["layers"] - 1
    ops = []
    for i, (fi, hc, h) in enumerate(_layers(cfg)):
        bx = 4 if i == 0 else ba
        bo = 4 if i == last else ba
        ops.append(Op(f"mm{i}", 2.0 * n * fi * 2 * hc,
                      n * fi * bx + fi * 2 * hc * 4 + 2 * n * hc * ba))
        ops.append(Op(f"attn{i}",
                      e * (6.0 * hc + 4.0 * h)
                      + n * hc * (1 if i == last else 2),
                      2 * n * hc * ba + hc * 4 + graph_bytes(n, e, False)
                      + n * hc * bo))
    LAST_FORWARD_OPS = list(ops)
    return ops


def step_ops(cfg: Dict, n: int, e: int) -> List[Op]:
    ba, last = act_bytes(cfg), cfg["layers"] - 1
    layers = _layers(cfg)
    ops = forward_ops(cfg, n, e) + loss_ops(cfg, n)
    for i in reversed(range(len(layers))):
        fi, hc, h = layers[i]
        bx = 4 if i == 0 else ba
        bo = 4 if i == last else ba
        # the ELU's gradient reads the layer's output where there is one
        elu = 0 if i == last else n * hc * ba
        # per edge the message, leaky and score again, the probability's
        # gradient by a dot per head, and the gradients of u_j (twice: as
        # the message and through the score), v_i and a
        ops.append(Op(f"attn{i}_bwd",
                      e * (16.0 * hc + 8.0 * h) + 2.0 * n * hc,
                      n * hc * bo + elu + 2 * n * hc * ba + hc * 4
                      + graph_bytes(n, e, False) + n * hc * ba
                      + 2 * n * hc * ba + hc * 4))
        ops.append(Op(f"mm{i}_bwd_w", 2.0 * n * fi * 2 * hc,
                      n * fi * bx + 2 * n * hc * ba + fi * 2 * hc * 4))
        if i > 0:
            ops.append(Op(f"mm{i}_bwd_x", 2.0 * n * fi * 2 * hc,
                          2 * n * hc * ba + fi * 2 * hc * 4 + n * fi * ba))
    n_params = sum(2 * fi * hc + hc for fi, hc, _ in layers)
    return ops + optimizer_ops(n_params)
