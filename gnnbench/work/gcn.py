"""GCN: per layer a transform x W and an aggregation over the normalised
graph (a multiply-add per edge and feature); the step adds the loss, the
transposed aggregations, the weight gradients, the input gradients of
every layer but the first, and AdamW."""
from __future__ import annotations

from typing import Dict, List

from . import Op, act_bytes, graph_bytes, loss_ops, optimizer_ops


def _widths(cfg: Dict) -> List[int]:
    return ([cfg["features"]] + [cfg["hidden"]] * (cfg["layers"] - 1)
            + [cfg["classes"]])


def forward_ops(cfg: Dict, n: int, e: int) -> List[Op]:
    w, ba, last = _widths(cfg), act_bytes(cfg), cfg["layers"] - 1
    ops = []
    for i in range(cfg["layers"]):
        fi, fo = w[i], w[i + 1]
        bx = 4 if i == 0 else ba
        bo = 4 if i == last else ba
        ops.append(Op(f"mm{i}", 2.0 * n * fi * fo,
                      n * fi * bx + fi * fo * 4 + n * fo * ba))
        ops.append(Op(f"agg{i}", 2.0 * e * fo,
                      n * fo * ba + graph_bytes(n, e, True) + n * fo * bo))
    return ops


def step_ops(cfg: Dict, n: int, e: int) -> List[Op]:
    w, ba, last = _widths(cfg), act_bytes(cfg), cfg["layers"] - 1
    ops = forward_ops(cfg, n, e) + loss_ops(cfg, n)
    for i in reversed(range(cfg["layers"])):
        fi, fo = w[i], w[i + 1]
        bx = 4 if i == 0 else ba
        bo = 4 if i == last else ba
        ops.append(Op(f"agg{i}_bwd", 2.0 * e * fo,
                      n * fo * bo + graph_bytes(n, e, True) + n * fo * ba))
        ops.append(Op(f"mm{i}_bwd_w", 2.0 * n * fi * fo,
                      n * fi * bx + n * fo * ba + fi * fo * 4))
        if i > 0:
            ops.append(Op(f"mm{i}_bwd_x", 2.0 * n * fi * fo,
                          n * fo * ba + fi * fo * 4 + n * fi * ba))
    n_params = sum(w[i] * w[i + 1] for i in range(cfg["layers"]))
    return ops + optimizer_ops(n_params)
