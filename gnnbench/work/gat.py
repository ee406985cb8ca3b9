"""GAT: per layer a transform x W, the attention projections a_s = h A_src
and a_d = h A_dst, and the attention aggregation (per edge and head: the
logit, leaky ReLU, the receiver's max, exp and the denominator; per edge
a multiply-add of every feature; per node the division, and ELU on all
but the last layer); the step adds the loss, the attention backward
(logits and probabilities recomputed per edge, the gradient of the
probability by a dot product per head, the messages' gradient by a
multiply-add per feature), the projections' and transforms' gradients,
and AdamW."""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import Op, act_bytes, graph_bytes, loss_ops, optimizer_ops


def _layers(cfg: Dict) -> List[Tuple[int, int, int]]:
    out, w = [], cfg["features"]
    for i in range(cfg["layers"]):
        last = i == cfg["layers"] - 1
        o = cfg["classes"] if last else cfg["hidden"]
        out.append((w, o, 1 if last else cfg["heads"]))
        w = o
    return out


def forward_ops(cfg: Dict, n: int, e: int) -> List[Op]:
    ba, last = act_bytes(cfg), cfg["layers"] - 1
    ops = []
    for i, (fi, hd, h) in enumerate(_layers(cfg)):
        bx = 4 if i == 0 else ba
        bo = 4 if i == last else ba
        ops.append(Op(f"mm{i}", 2.0 * n * fi * hd,
                      n * fi * bx + fi * hd * 4 + n * hd * ba))
        ops.append(Op(f"proj{i}", 4.0 * n * hd * h,
                      n * hd * ba + 2 * hd * h * 4 + 2 * n * h * 4))
        ops.append(Op(f"attn{i}",
                      e * (6.0 * h + 2.0 * hd) + n * hd * (1 if i == last
                                                           else 2),
                      n * hd * ba + 2 * n * h * 4 + graph_bytes(n, e, False)
                      + n * hd * bo))
    return ops


def step_ops(cfg: Dict, n: int, e: int) -> List[Op]:
    ba, last = act_bytes(cfg), cfg["layers"] - 1
    layers = _layers(cfg)
    ops = forward_ops(cfg, n, e) + loss_ops(cfg, n)
    for i in reversed(range(len(layers))):
        fi, hd, h = layers[i]
        bx = 4 if i == 0 else ba
        bo = 4 if i == last else ba
        # the ELU's gradient reads the layer's output where there is one
        elu = 0 if i == last else n * hd * ba
        ops.append(Op(f"attn{i}_bwd",
                      e * (9.0 * h + 4.0 * hd) + 2.0 * n * hd,
                      n * hd * bo + elu + n * hd * ba + 2 * n * h * 4
                      + graph_bytes(n, e, False) + n * hd * ba
                      + 2 * n * h * 4))
        ops.append(Op(f"proj{i}_bwd", 8.0 * n * hd * h,
                      2 * n * hd * ba + 2 * n * h * 4 + 2 * hd * h * 4
                      + n * hd * ba))
        ops.append(Op(f"mm{i}_bwd_w", 2.0 * n * fi * hd,
                      n * fi * bx + n * hd * ba + fi * hd * 4))
        if i > 0:
            ops.append(Op(f"mm{i}_bwd_x", 2.0 * n * fi * hd,
                          n * hd * ba + fi * hd * 4 + n * fi * ba))
    n_params = sum(fi * hd + 2 * hd * h for fi, hd, h in layers)
    return ops + optimizer_ops(n_params)
