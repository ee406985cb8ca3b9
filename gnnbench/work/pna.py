"""PNA as published (``reference/pna.py``): per layer the three products of
the layer's input, x [W_src | W_dst | W_x] (``mm``); the pair aggregation
(``pair``: per edge the message m = u[s] + v[r] and its four reductions,
sum, sum of squares, min and max, then per node the mean and the std),
which reads u, v and the CSR once and writes the four N x D float32
aggregates once; and the post-transform (``post``: the aggregates times
W_id, W_amp and W_att, the two degree scalers, the sum with x W_x and the
ReLU between layers).  The step adds the loss, each op's backward and
AdamW.

``run.py`` hands a per-layer metric only the totals of the work, so
``forward_ops`` keeps the op list of its last call in ``LAST_FORWARD_OPS``
for the reader of ``pair_roofline_pct``, which uses it only where its
totals are the record's."""
from __future__ import annotations

from typing import Dict, List, Optional

from . import Op, act_bytes, graph_bytes, loss_ops, optimizer_ops

N_AGG = 4                 # mean, min, max, std
N_SCALED = 3 * N_AGG      # each under identity, amplification, attenuation
LAST_FORWARD_OPS: Optional[List[Op]] = None


def _widths(cfg: Dict) -> List[int]:
    return ([cfg["features"]] + [cfg["hidden"]] * (cfg["layers"] - 1)
            + [cfg["classes"]])


def _layer_ops(cfg: Dict, n: int, e: int, i: int) -> List[Op]:
    w, ba, D = _widths(cfg), act_bytes(cfg), cfg["hidden"]
    fi, fo = w[i], w[i + 1]
    last = i == cfg["layers"] - 1
    bx = 4 if i == 0 else ba
    bo = 4 if last else ba
    agg = N_AGG * n * D * 4                       # the aggregates, float32
    return [
        # u and v in the compute dtype, x W_x in float32
        Op(f"mm{i}", 2.0 * n * fi * (2 * D + fo),
           n * fi * bx + fi * (2 * D + fo) * 4 + 2 * n * D * ba
           + n * fo * 4),
        # per edge and feature: the message, the sum, the square and its
        # sum, the min and the max; per node and feature the mean and the
        # std (a division each, a product, a difference, the ReLU, the
        # epsilon and the square root)
        Op(f"pair{i}", 6.0 * e * D + 8.0 * n * D,
           2 * n * D * ba + graph_bytes(n, e, False) + agg),
        # three products of the aggregates, two scalings, three sums and
        # the ReLU between layers; the scalers as two float32 vectors
        Op(f"post{i}", 2.0 * n * N_SCALED * D * fo
           + n * fo * (5 + (0 if last else 1)),
           agg + n * fo * 4 + 2 * n * 4 + N_SCALED * D * fo * 4
           + n * fo * bo),
    ]


def forward_ops(cfg: Dict, n: int, e: int) -> List[Op]:
    global LAST_FORWARD_OPS
    ops = [o for i in range(cfg["layers"]) for o in _layer_ops(cfg, n, e, i)]
    LAST_FORWARD_OPS = list(ops)
    return ops


def step_ops(cfg: Dict, n: int, e: int) -> List[Op]:
    w, ba, D = _widths(cfg), act_bytes(cfg), cfg["hidden"]
    ops = forward_ops(cfg, n, e) + loss_ops(cfg, n)
    n_params = 0
    for i in reversed(range(cfg["layers"])):
        fi, fo = w[i], w[i + 1]
        last = i == cfg["layers"] - 1
        bx = 4 if i == 0 else ba
        bo = 4 if last else ba
        agg = N_AGG * n * D * 4
        # the gradient of the aggregates and of W_id, W_amp, W_att
        ops.append(Op(f"post{i}_bwd", 4.0 * n * N_SCALED * D * fo
                      + n * fo * 6,
                      n * fo * bo + agg + 2 * n * 4 + N_SCALED * D * fo * 4
                      + agg + N_SCALED * D * fo * 4))
        # per edge: the message again and its share of each aggregate's
        # gradient, into u's and v's gradients
        ops.append(Op(f"pair{i}_bwd", 12.0 * e * D + 8.0 * n * D,
                      agg + 2 * n * D * ba + graph_bytes(n, e, False) + agg
                      + 2 * n * D * 4))
        ops.append(Op(f"mm{i}_bwd_w", 2.0 * n * fi * (2 * D + fo),
                      n * fi * bx + n * (2 * D + fo) * 4
                      + fi * (2 * D + fo) * 4))
        if i > 0:
            ops.append(Op(f"mm{i}_bwd_x", 2.0 * n * fi * (2 * D + fo),
                          n * (2 * D + fo) * 4 + fi * (2 * D + fo) * 4
                          + n * fi * ba))
        n_params += fi * (2 * D + fo) + N_SCALED * D * fo
    return ops + optimizer_ops(n_params)
