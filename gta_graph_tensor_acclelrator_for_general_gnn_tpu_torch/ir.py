"""The 4-primitive message-passing IR.

The reference expresses every GNN as a DAG of four primitive ops —
``scatter``, ``gather``, ``applyedge``, ``applynode`` — with compute types
{MM, ADD, MUL, SF, ELE, NONE} and an ORDER (R = row-wise / by destination,
C = column-wise / by source) (schema: ``template/op_template.yaml:1-19``,
generator: ``vTCAD/GraphOP/genGraphOP.py:4-25`` in the reference).  The
reference lowers this DAG to a simulated ISA; here the same IR lowers to a
traced JAX function, and fused sub-DAGs lower to Pallas TPU kernels.

Extensions over the reference (documented deltas, needed for *numerically
correct* execution rather than byte-count simulation):

* gather supports MAX and MEAN reductions (for stable softmax / SAGE-mean);
* apply_* adds SUB and DIV compute types;
* SF ops name their function (relu / leaky_relu / exp / elu / sigmoid / ...)
  in ``extra['sf']`` instead of being an opaque "special function" unit;
* MM ops name a parameter (``extra['weight']``) with an explicit
  (in_width, out_width) shape, so the graph carries enough information to
  initialise and apply real weights.

Domains: every op produces either a node-aligned ``[N, F]`` array or an
edge-aligned ``[E, F]`` array.  scatter: node->edge, gather: edge->node,
apply_edge: edge->edge, apply_node: node->node.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Op kinds / compute types
# ---------------------------------------------------------------------------

SCATTER = "scatter"
GATHER = "gather"
APPLY_EDGE = "apply_edge"
APPLY_NODE = "apply_node"
KINDS = (SCATTER, GATHER, APPLY_EDGE, APPLY_NODE)

# compute types (reference set + extensions)
NONE = "NONE"
ADD = "ADD"
MUL = "MUL"
SUB = "SUB"
DIV = "DIV"
MM = "MM"
SF = "SF"
ELE = "ELE"
MAX = "MAX"
MEAN = "MEAN"
COMPUTES = (NONE, ADD, MUL, SUB, DIV, MM, SF, ELE, MAX, MEAN)

# special input ids
X_INPUT = -2          # the graph's node feature matrix
EDGE_WEIGHT = -1      # the per-edge scalar weight (reference uses -1 for this
                      # in e.g. GCN op1 MUL [0, -1], genGraphOP.py:36)

NODE = "node"
EDGE = "edge"


@dataclasses.dataclass
class Op:
    """One IR op.  Mirrors the reference op dict (gen_one_op) but carries
    semantic info (weights, sf kind, constants) instead of byte sizes."""

    op_id: int
    kind: str
    compute: str = NONE
    order: str = "R"                      # scatter: R=by receiver, C=by sender
    inputs: List[int] = dataclasses.field(default_factory=list)
    out_width: int = 0                    # feature width of the output
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # extra keys:
    #   'weight': (name, in_width, out_width)   for MM
    #   'sf': 'relu'|'leaky_relu'|'exp'|'elu'|'sigmoid'|'tanh'|'identity'
    #   'const': float                          scalar constant operand
    #   'negative_slope': float                 for leaky_relu

    @property
    def out_domain(self) -> str:
        return EDGE if self.kind in (SCATTER, APPLY_EDGE) else NODE

    @property
    def in_domain(self) -> str:
        return NODE if self.kind in (SCATTER, APPLY_NODE) else EDGE


@dataclasses.dataclass
class OpGraph:
    """A validated DAG of ops. ``name`` identifies the model family."""

    name: str
    ops: List[Op]
    in_width: int                          # width of X
    outputs: Optional[List[int]] = None    # default: ops nobody consumes

    def __post_init__(self):
        self.by_id = {op.op_id: op for op in self.ops}
        if len(self.by_id) != len(self.ops):
            raise ValueError(f"duplicate op ids in {self.name}")
        if self.outputs is None:
            consumed = {i for op in self.ops for i in op.inputs if i >= 0}
            self.outputs = [op.op_id for op in self.ops if op.op_id not in consumed]
        self.validate()

    # -- structure ---------------------------------------------------------
    def edges(self) -> List[Tuple[int, int]]:
        """DAG edges (producer, consumer) — the fusion search space, one bit
        per edge as in the reference compiler (gen_op_connected_info,
        vTCAD/code/compiler.py:463-480)."""
        es = []
        for op in self.ops:
            for i in op.inputs:
                if i >= 0:
                    es.append((i, op.op_id))
        return es

    def topo_order(self) -> List[int]:
        indeg = {op.op_id: 0 for op in self.ops}
        succ: Dict[int, List[int]] = {op.op_id: [] for op in self.ops}
        for u, v in self.edges():
            indeg[v] += 1
            succ[u].append(v)
        ready = sorted([i for i, d in indeg.items() if d == 0])
        out = []
        while ready:
            u = ready.pop(0)
            out.append(u)
            for v in succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
            ready.sort()
        if len(out) != len(self.ops):
            raise ValueError(f"cycle in op graph {self.name}")
        return out

    # -- validation --------------------------------------------------------
    def validate(self):
        self.topo_order()
        for op in self.ops:
            if op.kind not in KINDS:
                raise ValueError(f"op {op.op_id}: bad kind {op.kind}")
            if op.compute not in COMPUTES:
                raise ValueError(f"op {op.op_id}: bad compute {op.compute}")
            for i in op.inputs:
                if i >= 0:
                    src = self.by_id.get(i)
                    if src is None:
                        raise ValueError(f"op {op.op_id}: missing input {i}")
                    if src.out_domain != op.in_domain:
                        raise ValueError(
                            f"op {op.op_id} ({op.kind}) expects {op.in_domain}"
                            f" input but op {i} produces {src.out_domain}")
                elif i == X_INPUT:
                    if op.in_domain != NODE:
                        raise ValueError(f"op {op.op_id}: X is node-aligned")
                elif i == EDGE_WEIGHT:
                    if op.in_domain != EDGE:
                        raise ValueError(
                            f"op {op.op_id}: edge_weight is edge-aligned")
            if op.compute == MM and "weight" not in op.extra:
                raise ValueError(f"op {op.op_id}: MM needs extra['weight']")

    # -- widths ------------------------------------------------------------
    def width_of(self, ref: int) -> int:
        if ref == X_INPUT:
            return self.in_width
        if ref == EDGE_WEIGHT:
            return 1
        return self.by_id[ref].out_width

    def param_specs(self) -> List[Tuple[str, int, int]]:
        """(name, in_width, out_width) for every MM weight, in topo order."""
        specs = []
        seen = set()
        for oid in self.topo_order():
            op = self.by_id[oid]
            if op.compute == MM:
                name, iw, ow = op.extra["weight"]
                if name not in seen:
                    specs.append((name, iw, ow))
                    seen.add(name)
        return specs


# ---------------------------------------------------------------------------
# Fusion legality — the reference compiler's rules, kernel-ised
# ---------------------------------------------------------------------------

def is_breakpoint(producer: Op, consumer: Op) -> bool:
    """An edge of the op DAG that can never be inside a fused block.

    Mirrors the reference rule (vTCAD/code/compiler.py:472-473): a
    gather -> scatter edge is a breakpoint (the intermediate is node-aligned
    and must round-trip), and a scatter whose ORDER differs from its
    producer's ORDER is a breakpoint (a data re-layout between by-source and
    by-destination edge order).  On TPU the same boundaries are where a fused
    Pallas kernel would need a full re-sort of the edge stream.
    """
    if producer.kind == GATHER and consumer.kind == SCATTER:
        return True
    if consumer.kind == SCATTER and consumer.order != producer.order \
            and producer.kind == SCATTER:
        return True
    return False


def partition_is_legal(graph: OpGraph, blocks: Sequence[Sequence[int]]) -> bool:
    """A fusion partition is legal iff (a) no breakpoint edge is internal to a
    block, (b) the quotient DAG over blocks is acyclic (no block output feeds
    back into the block through another block — the reference's
    is_subgraph_output_returning / check_cycle, compiler.py:330-383)."""
    block_of = {}
    for b, ops in enumerate(blocks):
        for o in ops:
            if o in block_of:
                return False
            block_of[o] = b
    if set(block_of) != set(graph.by_id):
        return False
    for u, v in graph.edges():
        if block_of[u] == block_of[v] and is_breakpoint(graph.by_id[u], graph.by_id[v]):
            return False
    # quotient acyclicity
    qedges = {(block_of[u], block_of[v]) for u, v in graph.edges()
              if block_of[u] != block_of[v]}
    indeg = {b: 0 for b in range(len(blocks))}
    succ = {b: [] for b in range(len(blocks))}
    for a, b in qedges:
        indeg[b] += 1
        succ[a].append(b)
    ready = [b for b, d in indeg.items() if d == 0]
    seen = 0
    while ready:
        a = ready.pop()
        seen += 1
        for b in succ[a]:
            indeg[b] -= 1
            if indeg[b] == 0:
                ready.append(b)
    return seen == len(blocks)


# ---------------------------------------------------------------------------
# The port's extensions, after the JAX package's IR above (kept byte for
# byte): PNA as published (Corso et al., arXiv:2004.05718)
# ---------------------------------------------------------------------------
#
# * gather MIN, and gather STD: std = sqrt(relu(mean(e^2) - mean(e)^2) +
#   STD_EPS), as the PNA authors' code takes it;
# * apply_node SCALER multiplies each node's row by a degree scaler,
#   ``extra['scaler']`` in SCALERS: 'amplification' log(d+1)/delta or
#   'attenuation' delta/log(d+1), d the node's in-degree clamped to at
#   least 1 and delta the mean of log(d+1) over the graph's nodes;
# * an MM of several inputs multiplies the concatenation of their
#   features, in input order.

MIN = "MIN"
STD = "STD"
SCALER = "SCALER"
COMPUTES = COMPUTES + (MIN, STD, SCALER)
SCALERS = ("amplification", "attenuation")
STD_EPS = 1e-5

# GATv2 (Brody, Alon and Yahav, arXiv:2105.14491):
#
# * apply_edge HEAD_DOT takes each head's dot of an edge value [E, H*C]
#   (heads head-major) with that head's attention vector, row h of the
#   [H, C] parameter ``extra['weight']`` = (name, H, C):
#   out[e, h] = sum_c x[e, h*C + c] * a[h, c].

HEAD_DOT = "HEAD_DOT"
COMPUTES = COMPUTES + (HEAD_DOT,)


def _param_specs(self: OpGraph) -> List[Tuple[str, int, int]]:
    """(name, rows, cols) of every parameter, in topo order: each MM
    weight ([in_width, out_width]), then each HEAD_DOT's [H, C] attention
    vectors.  A graph without HEAD_DOT (every network of the JAX package)
    gets the JAX package's list."""
    specs = _mm_param_specs(self)
    seen = {name for name, _, _ in specs}
    for oid in self.topo_order():
        op = self.by_id[oid]
        if op.compute == HEAD_DOT:
            name, h, c = op.extra["weight"]
            if name not in seen:
                specs.append((name, h, c))
                seen.add(name)
    return specs


_mm_param_specs = OpGraph.param_specs
OpGraph.param_specs = _param_specs
