"""Schedules: a fusion partition of the op graph plus a tile config per block.

Counterpart of the JAX package's ``compiler/schedule.py``: the same
``TileConfig`` / ``Schedule`` types and keys, the same path names, and the
partitions the ported paths use (singleton, aggregation, pattern, pair
aggregation, max fusion, default).
The partition enumerator, the traffic model and the on-chip buffer rules
are not ported yet (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .. import ir

PATH_XLA = "xla"         # per-op primitives (materialised edge tensors)
PATH_ONEHOT = "onehot"   # edge-tile kernels
PATH_STREAM = "stream"   # chunked edge streaming
PATH_HYBRID = "hybrid"   # density split: dense-block kernels + edge tiles
PATH_GROUPED = "grouped"  # stripe-group chunked SpMM tail
PATH_DENSEFULL = "densefull"  # one dense adjacency matmul
PATHS = (PATH_XLA, PATH_ONEHOT, PATH_STREAM, PATH_HYBRID, PATH_GROUPED,
         PATH_DENSEFULL)
GROUPED_G = 16   # sub-tiles per chunk of PATH_GROUPED tilings (the JAX value)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Per-block execution config: the path and the tile geometry of its
    kernels.  ``dense_block`` (hybrid only) is the side of the square
    dense-block grid; 0 = follow block_rows / block_cols."""
    block_rows: int = 256
    block_cols: int = 256
    tile_edges: int = 512
    path: str = PATH_ONEHOT
    dense_block: int = 0

    def key(self) -> Tuple:
        base = (self.block_rows, self.block_cols, self.tile_edges, self.path)
        return base + ((f"d{self.dense_block}",) if self.dense_block else ())

    @property
    def kernel(self) -> bool:
        return self.path != PATH_XLA


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A fusion partition plus per-block tile configs; ``blocks`` are in
    topological order of the quotient DAG."""
    blocks: Tuple[Tuple[int, ...], ...]
    tiles: Tuple[TileConfig, ...]

    def key(self) -> str:
        bs = ";".join(",".join(map(str, b)) for b in self.blocks)
        ts = ";".join("x".join(map(str, t.key())) for t in self.tiles)
        return f"{bs}|{ts}"

    @classmethod
    def from_key(cls, key: str) -> "Schedule":
        """Inverse of :meth:`key`."""
        bs, ts = key.split("|")
        blocks = tuple(tuple(int(o) for o in b.split(","))
                       for b in bs.split(";"))
        tiles = []
        for t in ts.split(";"):
            br, bc, te, path = t.split("x", 3)
            dense = 0
            if "xd" in path:
                path, d = path.rsplit("xd", 1)
                dense = int(d)
            tiles.append(TileConfig(int(br), int(bc), int(te), path,
                                    dense_block=dense))
        return cls(blocks=blocks, tiles=tuple(tiles))


def _components(n_ops: Sequence[int],
                fused_edges: Iterable[Tuple[int, int]]) -> List[List[int]]:
    parent = {o: o for o in n_ops}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for u, v in fused_edges:
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
    comps: Dict[int, List[int]] = {}
    for o in n_ops:
        comps.setdefault(find(o), []).append(o)
    return [sorted(c) for c in comps.values()]


def _order_blocks(graph: ir.OpGraph,
                  blocks: List[List[int]]) -> List[List[int]]:
    """Topologically order blocks by the quotient DAG (deterministic)."""
    block_of = {o: i for i, b in enumerate(blocks) for o in b}
    indeg = [0] * len(blocks)
    succ: List[set] = [set() for _ in blocks]
    for u, v in graph.edges():
        a, b = block_of[u], block_of[v]
        if a != b and b not in succ[a]:
            succ[a].add(b)
            indeg[b] += 1
    ready = sorted(i for i, d in enumerate(indeg) if d == 0)
    out = []
    while ready:
        a = ready.pop(0)
        out.append(blocks[a])
        for b in sorted(succ[a]):
            indeg[b] -= 1
            if indeg[b] == 0:
                ready.append(b)
        ready.sort(key=lambda i: blocks[i])
    return out


def singleton_partition(graph: ir.OpGraph) -> Tuple[Tuple[int, ...], ...]:
    return tuple((o,) for o in graph.topo_order())


def aggregation_partition(
        graph: ir.OpGraph) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Partition isolating every SpMM-matchable aggregation chain
    (scatter(C) [-> apply_edge MUL edge_weight] -> gather(ADD|MEAN)) as its
    own block, everything else singleton; None when there is no chain."""
    from .fusion import match_spmm
    consumers: dict = {op.op_id: set() for op in graph.ops}
    for op in graph.ops:
        for i in op.inputs:
            if i in consumers:
                consumers[i].add(op.op_id)
    blocks: List[List[int]] = []
    used: set = set()
    for ga in graph.ops:
        if ga.kind != ir.GATHER or len(ga.inputs) != 1 or ga.inputs[0] < 0:
            continue
        mid = graph.by_id[ga.inputs[0]]
        chain = None
        if mid.kind == ir.SCATTER:
            chain = [mid.op_id, ga.op_id]
        elif mid.kind == ir.APPLY_EDGE and ir.EDGE_WEIGHT in mid.inputs:
            sc = next((i for i in mid.inputs if i >= 0), None)
            if sc is not None and graph.by_id[sc].kind == ir.SCATTER:
                chain = [sc, mid.op_id, ga.op_id]
        if chain is None or used & set(chain):
            continue
        # internal values must not escape the block
        if any(consumers[o] - set(chain) for o in chain[:-1]):
            continue
        if set(chain[:-1]) & set(graph.outputs):
            continue
        if match_spmm(graph, chain) is None:
            continue
        blocks.append(sorted(chain))
        used.update(chain)
    if not blocks:
        return None
    rest = [[o] for o in graph.topo_order() if o not in used]
    part = _order_blocks(graph, blocks + rest)
    return tuple(tuple(b) for b in part)


def pair_agg_partition(
        graph: ir.OpGraph) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Partition isolating the DGN / PNA pair-sum aggregation chain (z =
    sf(u[src] + v[dst]) and its gathers) as ONE block for the fused
    pair-aggregate kernel, everything else singleton; None when there is
    none.  The chain crosses the scatter-order breakpoint of the fusion
    rule, which the fused kernel may: it never materialises the edge
    value."""
    from ..ops.pairagg import _collect_terms, match_pair_agg
    all_ids = {op.op_id for op in graph.ops}
    for g0 in graph.ops:
        if g0.kind != ir.GATHER or not g0.inputs or g0.inputs[0] < 0:
            continue
        root = g0.inputs[0]
        gathers = [op.op_id for op in graph.ops
                   if op.kind == ir.GATHER and op.inputs == [root]]
        rop = graph.by_id[root]
        block = set(gathers)
        expr_root = root
        if rop.kind == ir.APPLY_EDGE and rop.compute == ir.SF:
            block.add(root)
            expr_root = rop.inputs[0]
        got = _collect_terms(graph, expr_root, all_ids)
        if got is None:
            continue
        block |= got[2]
        if match_pair_agg(graph, sorted(block)) is None:
            continue
        rest = [[o] for o in graph.topo_order() if o not in block]
        part = _order_blocks(graph, [sorted(block)] + rest)
        return tuple(tuple(b) for b in part)
    return None


def max_fusion_partition(graph: ir.OpGraph) -> Tuple[Tuple[int, ...], ...]:
    """Greedy max fusion: fuse every non-breakpoint edge whose fusion keeps
    the partition legal."""
    ids = [op.op_id for op in graph.ops]
    fused: List[Tuple[int, int]] = []
    for (u, v) in graph.edges():
        if ir.is_breakpoint(graph.by_id[u], graph.by_id[v]):
            continue
        cand = fused + [(u, v)]
        if ir.partition_is_legal(graph, _components(ids, cand)):
            fused = cand
    blocks = _components(ids, fused)
    return tuple(tuple(b) for b in _order_blocks(graph, blocks))


def pattern_partition(
        graph: ir.OpGraph) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """The whole GAT attention chain as ONE block (the fused attention
    kernels keep per-row num/den on chip, so the chain's breakpoints do not
    apply), everything else singleton; None when there is no chain."""
    from ..ops.gat import find_gat_chain
    plan = find_gat_chain(graph)
    if plan is None:
        return None
    if (set(plan.ops) - {plan.out_op}) & set(graph.outputs):
        return None
    rest = [o for o in graph.topo_order() if o not in plan.ops]
    blocks = [[o] for o in rest] + [sorted(plan.ops)]
    return tuple(tuple(b) for b in _order_blocks(graph, blocks))


def default_schedule(graph: ir.OpGraph) -> Schedule:
    """Pattern super-fusion when available, else max legal fusion."""
    blocks = pattern_partition(graph) or max_fusion_partition(graph)
    return Schedule(blocks=blocks, tiles=tuple(TileConfig() for _ in blocks))
