"""Op-graph builders for the seven GNN families of the reference model zoo.

Mirrors ``vTCAD/GraphOP/genGraphOP.py:gen_yaml`` (GCN :34-45, GAT :47-77,
SGC :79-86, GraphSAGE :88-95, GIN :97-108, DGN :110-121, PNA :123-147), with
the same ``reorder`` (aggregate-first vs transform-first) algebraic variants.
Two deliberate deltas from the reference graphs, which were built for a
byte-count simulator rather than numerical execution:

* GAT softmax is numerically stabilised (gather-MAX / subtract / exp instead
  of a bare exp — the reference's SF op at genGraphOP.py:57);
* GraphSAGE uses a true MEAN gather and PNA uses {sum, max, mean} aggregators
  (the defining feature of PNA), expressed with the gather-reduce extension
  documented in ``ir.py``.

Beyond the reference zoo, ``"PNA-4x3"`` is PNA as published (Corso et al.,
arXiv:2004.05718): the aggregators mean, min, max and std, each under the
degree scalers identity, amplification and attenuation, and the
post-transform over [x | 12 scaled aggregates], and ``"GATv2"`` is GATv2
(Brody, Alon and Yahav, arXiv:2105.14491): dynamic attention, whose
score puts a LeakyReLU between the sender's and the receiver's
transformed features.

Every builder returns a single-layer :class:`~..ir.OpGraph`; multi-layer
models stack these (see ``models/zoo.py``).
"""
from __future__ import annotations

from .. import ir
from ..ir import Op, OpGraph

# the reference zoo's families, which the JAX package builds too
NETWORKS = ("GCN", "GAT", "SGC", "GraphSAGE", "GIN", "DGN", "PNA")
# published forms the port builds beside them
PUBLISHED = ("PNA-4x3", "GATv2")


def _w(name: str, iw: int, ow: int) -> dict:
    return {"weight": (name, iw, ow)}


def build_op_graph(
    network: str,
    in_width: int,
    out_width: int,
    *,
    heads: int = 4,
    hidden: int = 0,
    reorder: bool = False,
    layer_tag: str = "l0",
    final_sf: str = "relu",
    eps: float = 0.1,
) -> OpGraph:
    """Build the op graph for one layer of ``network``."""
    F, O, t = in_width, out_width, layer_tag
    X = ir.X_INPUT
    EW = ir.EDGE_WEIGHT

    if network == "GCN" and not reorder:
        # aggregate-first (genGraphOP.py:34-38)
        ops = [
            Op(0, ir.SCATTER, ir.NONE, "C", [X], F),
            Op(1, ir.APPLY_EDGE, ir.MUL, "R", [0, EW], F),
            Op(2, ir.GATHER, ir.ADD, "R", [1], F),
            Op(3, ir.APPLY_NODE, ir.MM, "R", [2], O, _w(f"gcn_{t}_w", F, O)),
        ]
    elif network == "GCN" and reorder:
        # transform-first (genGraphOP.py:40-45)
        ops = [
            Op(0, ir.APPLY_NODE, ir.MM, "R", [X], O, _w(f"gcn_{t}_w", F, O)),
            Op(1, ir.SCATTER, ir.NONE, "C", [0], O),
            Op(2, ir.APPLY_EDGE, ir.MUL, "R", [1, EW], O),
            Op(3, ir.GATHER, ir.ADD, "R", [2], O),
        ]

    elif network == "GAT":
        # 14-op reference graph (genGraphOP.py:47-62) with stable softmax.
        H, HD = heads, O  # O = heads * per-head-dim
        assert O % heads == 0, "GAT out_width must be a multiple of heads"
        ops = [
            Op(0, ir.APPLY_NODE, ir.MM, "R", [X], HD, _w(f"gat_{t}_w", F, HD)),
            Op(1, ir.APPLY_NODE, ir.MM, "R", [0], H, _w(f"gat_{t}_asrc", HD, H)),
            Op(2, ir.APPLY_NODE, ir.MM, "R", [0], H, _w(f"gat_{t}_adst", HD, H)),
            Op(3, ir.SCATTER, ir.NONE, "C", [0], HD),       # h_src on edges
            Op(4, ir.SCATTER, ir.NONE, "R", [2], H),        # a_dst on edges
            Op(5, ir.SCATTER, ir.NONE, "C", [1], H),        # a_src on edges
            Op(6, ir.APPLY_EDGE, ir.ADD, "R", [4, 5], H),
            Op(7, ir.APPLY_EDGE, ir.SF, "R", [6], H, {"sf": "leaky_relu"}),
            Op(8, ir.GATHER, ir.MAX, "R", [7], H),          # segment max
            Op(9, ir.SCATTER, ir.NONE, "R", [8], H),
            Op(10, ir.APPLY_EDGE, ir.SUB, "R", [7, 9], H),
            Op(11, ir.APPLY_EDGE, ir.SF, "R", [10], H, {"sf": "exp"}),
        ]
        if not reorder:
            # normalise on edges, then aggregate (original ordering)
            ops += [
                Op(12, ir.GATHER, ir.ADD, "R", [11], H),    # softmax denom
                Op(13, ir.SCATTER, ir.NONE, "R", [12], H),
                Op(14, ir.APPLY_EDGE, ir.DIV, "R", [11, 13], H),   # alpha
                Op(15, ir.APPLY_EDGE, ir.MUL, "R", [14, 3], HD),   # alpha * h_src
                Op(16, ir.GATHER, ir.ADD, "R", [15], HD),
                Op(17, ir.APPLY_NODE, ir.SF, "R", [16], HD, {"sf": final_sf}),
            ]
        else:
            # aggregate numerator and denominator, divide on nodes
            # (genGraphOP.py:64-77 'trans' variant)
            ops += [
                Op(12, ir.APPLY_EDGE, ir.MUL, "R", [11, 3], HD),   # exp * h_src
                Op(13, ir.GATHER, ir.ADD, "R", [12], HD),          # numerator
                Op(14, ir.GATHER, ir.ADD, "R", [11], H),           # denominator
                Op(15, ir.APPLY_NODE, ir.DIV, "R", [13, 14], HD),
                Op(16, ir.APPLY_NODE, ir.SF, "R", [15], HD, {"sf": final_sf}),
            ]

    elif network == "SGC":
        # two propagation hops then one linear map (genGraphOP.py:79-86)
        ops = [
            Op(0, ir.SCATTER, ir.NONE, "C", [X], F),
            Op(1, ir.APPLY_EDGE, ir.MUL, "R", [0, EW], F),
            Op(2, ir.GATHER, ir.ADD, "R", [1], F),
            Op(3, ir.SCATTER, ir.NONE, "C", [2], F),
            Op(4, ir.APPLY_EDGE, ir.MUL, "R", [3, EW], F),
            Op(5, ir.GATHER, ir.ADD, "R", [4], F),
            Op(6, ir.APPLY_NODE, ir.MM, "R", [5], O, _w(f"sgc_{t}_w", F, O)),
        ]

    elif network == "GraphSAGE":
        # mean-aggregate + self path (genGraphOP.py:88-95)
        ops = [
            Op(0, ir.SCATTER, ir.NONE, "C", [X], F),
            Op(1, ir.GATHER, ir.MEAN, "R", [0], F),
            Op(2, ir.APPLY_NODE, ir.MM, "R", [1], O, _w(f"sage_{t}_wn", F, O)),
            Op(3, ir.APPLY_NODE, ir.MM, "R", [X], O, _w(f"sage_{t}_ws", F, O)),
            Op(4, ir.APPLY_NODE, ir.ADD, "R", [2, 3], O),
            Op(5, ir.APPLY_NODE, ir.SF, "R", [4], O, {"sf": final_sf}),
        ]

    elif network == "GIN":
        # (1+eps)x + sum-aggregate, 2-layer MLP (genGraphOP.py:97-108)
        hid = hidden or O
        ops = [
            Op(0, ir.SCATTER, ir.NONE, "C", [X], F),
            Op(1, ir.GATHER, ir.ADD, "R", [0], F),
            Op(2, ir.APPLY_NODE, ir.MUL, "R", [X], F, {"const": 1.0 + eps}),
            Op(3, ir.APPLY_NODE, ir.ADD, "R", [1, 2], F),
            Op(4, ir.APPLY_NODE, ir.MM, "R", [3], hid, _w(f"gin_{t}_w1", F, hid)),
            Op(5, ir.APPLY_NODE, ir.SF, "R", [4], hid, {"sf": "relu"}),
            Op(6, ir.APPLY_NODE, ir.MM, "R", [5], O, _w(f"gin_{t}_w2", hid, O)),
            Op(7, ir.APPLY_NODE, ir.SF, "R", [6], O, {"sf": final_sf}),
        ]

    elif network == "DGN":
        # directional: transform, form src+dst edge messages in both the raw
        # and transformed streams, combine, aggregate (genGraphOP.py:110-121;
        # the reference graph's dangling inputs are made coherent here)
        ops = [
            Op(0, ir.SCATTER, ir.NONE, "C", [X], F),
            Op(1, ir.SCATTER, ir.NONE, "R", [X], F),
            Op(2, ir.APPLY_EDGE, ir.ADD, "R", [0, 1], F),
            Op(3, ir.APPLY_EDGE, ir.MM, "R", [2], O, _w(f"dgn_{t}_we", F, O)),
            Op(4, ir.APPLY_NODE, ir.MM, "R", [X], O, _w(f"dgn_{t}_wn", F, O)),
            Op(5, ir.SCATTER, ir.NONE, "C", [4], O),
            Op(6, ir.SCATTER, ir.NONE, "R", [4], O),
            Op(7, ir.APPLY_EDGE, ir.ADD, "R", [5, 6], O),
            Op(8, ir.APPLY_EDGE, ir.ADD, "R", [3, 7], O),
            Op(9, ir.GATHER, ir.ADD, "R", [8], O),
            Op(10, ir.APPLY_NODE, ir.MUL, "R", [9], O, {"const": 0.5}),
            Op(11, ir.APPLY_NODE, ir.SF, "R", [10], O, {"sf": final_sf}),
        ]

    elif network == "PNA":
        # multi-aggregator neighbourhood aggregation (genGraphOP.py:123-147;
        # uses the true PNA {sum,max,mean} aggregator set)
        D = hidden or O
        if not reorder:
            head = [
                Op(0, ir.SCATTER, ir.NONE, "C", [X], F),
                Op(1, ir.SCATTER, ir.NONE, "R", [X], F),
                Op(2, ir.APPLY_EDGE, ir.MM, "R", [0], D, _w(f"pna_{t}_wsrc", F, D)),
                Op(3, ir.APPLY_EDGE, ir.MM, "R", [1], D, _w(f"pna_{t}_wdst", F, D)),
            ]
        else:
            # transform-first: apply the two MMs on nodes, then scatter
            head = [
                Op(0, ir.APPLY_NODE, ir.MM, "R", [X], D, _w(f"pna_{t}_wsrc", F, D)),
                Op(1, ir.APPLY_NODE, ir.MM, "R", [X], D, _w(f"pna_{t}_wdst", F, D)),
                Op(2, ir.SCATTER, ir.NONE, "C", [0], D),
                Op(3, ir.SCATTER, ir.NONE, "R", [1], D),
            ]
        a, b = (2, 3) if not reorder else (2, 3)
        ops = head + [
            Op(4, ir.APPLY_EDGE, ir.ADD, "R", [a, b], D),
            Op(5, ir.APPLY_EDGE, ir.SF, "R", [4], D, {"sf": "leaky_relu"}),
            Op(6, ir.GATHER, ir.ADD, "R", [5], D),
            Op(7, ir.GATHER, ir.MAX, "R", [5], D),
            Op(8, ir.GATHER, ir.MEAN, "R", [5], D),
            Op(9, ir.APPLY_NODE, ir.ADD, "R", [6, 7], D),
            Op(10, ir.APPLY_NODE, ir.ADD, "R", [9, 8], D),
            Op(11, ir.APPLY_NODE, ir.MUL, "R", [10], D, {"const": 1.0 / 3.0}),
            Op(12, ir.APPLY_NODE, ir.MM, "R", [11], O, _w(f"pna_{t}_wo", D, O)),
        ]

    elif network == "PNA-4x3":
        ops = _pna_published(F, O, hidden or O, t, reorder, final_sf)

    elif network == "GATv2":
        ops = _gatv2(F, O, heads, t, final_sf)

    else:
        raise ValueError(f"unknown network {network!r}; choose from "
                         f"{NETWORKS + PUBLISHED}")

    variant = "trans" if reorder else "original"
    return OpGraph(name=f"{network}-{variant}-{t}", ops=ops, in_width=F)


def _pna_published(F: int, O: int, D: int, t: str, reorder: bool,
                   final_sf: str) -> list:
    """One PNA layer as published: messages m = x_dst W_dst + x_src W_src of
    width D (PyG's ``PNAConv`` with one pre-layer and one tower), the
    aggregators mean, min, max and std over each receiver's incoming
    edges, the scalers identity, amplification and attenuation, and the
    post-transform U([x | A | amp A | att A]) with A = [mean | min | max |
    std].  A row scaling commutes with a product, so U's aggregate part is
    A W_id + amp (A W_amp) + att (A W_att): the 12 D-wide input is never
    formed.  No bias, as everywhere in this zoo."""
    X = ir.X_INPUT
    if reorder:
        # transform first: the two pre-transform products on nodes
        head = [
            Op(0, ir.APPLY_NODE, ir.MM, "R", [X], D, _w(f"pna4_{t}_wsrc", F, D)),
            Op(1, ir.APPLY_NODE, ir.MM, "R", [X], D, _w(f"pna4_{t}_wdst", F, D)),
            Op(2, ir.SCATTER, ir.NONE, "C", [0], D),
            Op(3, ir.SCATTER, ir.NONE, "R", [1], D),
        ]
    else:
        head = [
            Op(0, ir.SCATTER, ir.NONE, "C", [X], F),
            Op(1, ir.SCATTER, ir.NONE, "R", [X], F),
            Op(2, ir.APPLY_EDGE, ir.MM, "R", [0], D, _w(f"pna4_{t}_wsrc", F, D)),
            Op(3, ir.APPLY_EDGE, ir.MM, "R", [1], D, _w(f"pna4_{t}_wdst", F, D)),
        ]
    aggs = [5, 6, 7, 8]
    A = 4 * D
    return head + [
        Op(4, ir.APPLY_EDGE, ir.ADD, "R", [2, 3], D),
        Op(5, ir.GATHER, ir.MEAN, "R", [4], D),
        Op(6, ir.GATHER, ir.MIN, "R", [4], D),
        Op(7, ir.GATHER, ir.MAX, "R", [4], D),
        Op(8, ir.GATHER, ir.STD, "R", [4], D),
        Op(9, ir.APPLY_NODE, ir.MM, "R", aggs, O, _w(f"pna4_{t}_wid", A, O)),
        Op(10, ir.APPLY_NODE, ir.MM, "R", aggs, O, _w(f"pna4_{t}_wamp", A, O)),
        Op(11, ir.APPLY_NODE, ir.MM, "R", aggs, O, _w(f"pna4_{t}_watt", A, O)),
        Op(12, ir.APPLY_NODE, ir.SCALER, "R", [10], O,
           {"scaler": "amplification"}),
        Op(13, ir.APPLY_NODE, ir.SCALER, "R", [11], O,
           {"scaler": "attenuation"}),
        Op(14, ir.APPLY_NODE, ir.MM, "R", [X], O, _w(f"pna4_{t}_wx", F, O)),
        Op(15, ir.APPLY_NODE, ir.ADD, "R", [14, 9], O),
        Op(16, ir.APPLY_NODE, ir.ADD, "R", [15, 12], O),
        Op(17, ir.APPLY_NODE, ir.ADD, "R", [16, 13], O),
        Op(18, ir.APPLY_NODE, ir.SF, "R", [17], O, {"sf": final_sf}),
    ]


def _gatv2(F: int, O: int, H: int, t: str, final_sf: str) -> list:
    """One GATv2 layer (PyG's ``GATv2Conv`` with ``share_weights=False``,
    no bias): u = x W_l and v = x W_r of width O = H*C, per edge (j, i)
    and head h the score e = a_h . leaky_relu(u_j,h + v_i,h, 0.2), a
    softmax over each receiver's incoming edges (stabilised by the
    segment max, as GAT's), out_i,h = sum_j alpha_ij,h u_j,h, heads
    concatenated head-major.  Numerator and denominator are gathered and
    divided on nodes, the form of GAT's ``reorder`` variant; u and v are
    node products in either variant, so ``reorder`` changes nothing."""
    X = ir.X_INPUT
    assert O % H == 0, "GATv2 out_width must be a multiple of heads"
    C = O // H
    return [
        Op(0, ir.APPLY_NODE, ir.MM, "R", [X], O, _w(f"gatv2_{t}_wl", F, O)),
        Op(1, ir.APPLY_NODE, ir.MM, "R", [X], O, _w(f"gatv2_{t}_wr", F, O)),
        Op(2, ir.SCATTER, ir.NONE, "C", [0], O),            # u_j on edges
        Op(3, ir.SCATTER, ir.NONE, "R", [1], O),            # v_i on edges
        Op(4, ir.APPLY_EDGE, ir.ADD, "R", [2, 3], O),
        Op(5, ir.APPLY_EDGE, ir.SF, "R", [4], O, {"sf": "leaky_relu"}),
        Op(6, ir.APPLY_EDGE, ir.HEAD_DOT, "R", [5], H,
           _w(f"gatv2_{t}_att", H, C)),
        Op(7, ir.GATHER, ir.MAX, "R", [6], H),              # segment max
        Op(8, ir.SCATTER, ir.NONE, "R", [7], H),
        Op(9, ir.APPLY_EDGE, ir.SUB, "R", [6, 8], H),
        Op(10, ir.APPLY_EDGE, ir.SF, "R", [9], H, {"sf": "exp"}),
        Op(11, ir.APPLY_EDGE, ir.MUL, "R", [10, 2], O),     # exp * u_j
        Op(12, ir.GATHER, ir.ADD, "R", [11], O),            # numerator
        Op(13, ir.GATHER, ir.ADD, "R", [10], H),            # denominator
        Op(14, ir.APPLY_NODE, ir.DIV, "R", [12, 13], O),
        Op(15, ir.APPLY_NODE, ir.SF, "R", [14], O, {"sf": final_sf}),
    ]
