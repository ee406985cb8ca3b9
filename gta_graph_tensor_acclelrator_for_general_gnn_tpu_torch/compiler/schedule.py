"""Schedules: a fusion partition of the op graph plus a tile config per block.

Counterpart of the JAX package's ``compiler/schedule.py``: the same
``TileConfig`` / ``Schedule`` types and keys, the same path names, the
partitions (singleton, aggregation, pattern, whole layer, pair
aggregation, max fusion, the enumerator, default), legality with the
kernel-pattern exemption and the analytic traffic model.  The TPU's VMEM
rules (``vmem_bytes`` / ``tile_is_feasible``) become a Hopper
shared-memory rule: :func:`smem_bytes` and :func:`tile_is_feasible`.
"""
from __future__ import annotations

import dataclasses
import itertools
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


def enumerate_partitions(
    graph: ir.OpGraph,
    max_edges: int = 20,
    limit: Optional[int] = None,
) -> List[Tuple[Tuple[int, ...], ...]]:
    """All legal fusion partitions of the op DAG: one bit per DAG edge,
    breakpoint edges forced to 0, candidates with an illegal block
    (internal breakpoint or quotient cycle) rejected; deduplicated, in the
    JAX package's order."""
    ids = [op.op_id for op in graph.ops]
    free = [(u, v) for (u, v) in graph.edges()
            if not ir.is_breakpoint(graph.by_id[u], graph.by_id[v])]
    if len(free) > max_edges:
        raise ValueError(
            f"{len(free)} free fusion edges > {max_edges}; use the GA search")
    seen = set()
    out: List[Tuple[Tuple[int, ...], ...]] = []
    for bits in itertools.product((0, 1), repeat=len(free)):
        blocks = _components(ids, [e for e, b in zip(free, bits) if b])
        key = tuple(tuple(b) for b in sorted(blocks))
        if key in seen:
            continue
        seen.add(key)
        if not ir.partition_is_legal(graph, blocks):
            continue
        out.append(tuple(tuple(b) for b in _order_blocks(graph, blocks)))
        if limit and len(out) >= limit:
            break
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


def gatv2_partition(
        graph: ir.OpGraph) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Partition isolating the GATv2 attention chain (the scatters of u and
    v through the division on nodes) as ONE block for K17, everything
    else singleton; None when there is none.  As the GAT chain, it crosses
    breakpoints the fused kernel may: it keeps each row's softmax on
    chip."""
    from ..ops.gatv2 import find_gatv2_chain
    plan = find_gatv2_chain(graph)
    if plan is None:
        return None
    rest = [[o] for o in graph.topo_order() if o not in plan.ops]
    part = _order_blocks(graph, [sorted(plan.ops)] + rest)
    return tuple(tuple(b) for b in part)


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


def layer_partition(
        graph: ir.OpGraph) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """The complete GAT layer (projection MMs, attention chain, activation)
    as ONE block for the whole-layer kernel (``ops/gat.gat_layer``): the
    whole graph when it is one layer, else the chain with its MMs and SF ops
    and everything else singleton; None when no layer matches."""
    from ..ops.gat import find_gat_chain, match_gat_layer
    all_ops = [op.op_id for op in graph.ops]
    if match_gat_layer(graph, all_ops) is not None:
        return (tuple(sorted(all_ops)),)
    if pattern_partition(graph) is None:
        return None
    cand = set(find_gat_chain(graph).ops) | {
        op.op_id for op in graph.ops
        if op.kind == ir.APPLY_NODE and op.compute in (ir.MM, ir.SF)}
    plan = match_gat_layer(graph, sorted(cand))
    if plan is None:
        return None
    rest = [o for o in graph.topo_order() if o not in plan.ops]
    blocks = [[o] for o in rest] + [sorted(plan.ops)]
    return tuple(tuple(b) for b in _order_blocks(graph, blocks))


def partition_is_legal_with_patterns(
        graph: ir.OpGraph, blocks: Sequence[Sequence[int]]) -> bool:
    """Partition legality with the kernel-pattern exemption: a block that
    exactly matches a fused-kernel pattern (attention chain, whole layer,
    pair aggregation, GATv2 attention) may contain breakpoint edges; the quotient must still
    be a DAG and every other block breakpoint-free."""
    from ..ops.gat import match_gat_block, match_gat_layer
    from ..ops.gatv2 import match_gatv2
    from ..ops.pairagg import match_pair_agg
    if ir.partition_is_legal(graph, blocks):
        return True
    exempt = {i for i, b in enumerate(blocks)
              if match_gat_block(graph, b) is not None
              or match_gat_layer(graph, b) is not None
              or match_pair_agg(graph, b) is not None
              or match_gatv2(graph, b) is not None}
    if not exempt:
        return False
    block_of: Dict[int, int] = {}
    for i, b in enumerate(blocks):
        for o in b:
            if o in block_of:
                return False
            block_of[o] = i
    if set(block_of) != set(graph.by_id):
        return False
    for u, v in graph.edges():
        if (block_of[u] == block_of[v] and block_of[u] not in exempt
                and ir.is_breakpoint(graph.by_id[u], graph.by_id[v])):
            return False
    indeg = {i: 0 for i in range(len(blocks))}
    succ: Dict[int, List[int]] = {i: [] for i in range(len(blocks))}
    for a, b in {(block_of[u], block_of[v]) for u, v in graph.edges()
                 if block_of[u] != block_of[v]}:
        indeg[b] += 1
        succ[a].append(b)
    ready = [i for i, d in indeg.items() if d == 0]
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
# analytic cost model (the reference's cal_size / rw)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Static per-graph quantities the cost model needs (host side)."""
    n_node: int
    n_edge: int
    e_pad: int


def traffic_bytes(graph: ir.OpGraph, blocks: Sequence[Sequence[int]],
                  stats: GraphStats, dtype_bytes: int = 4) -> int:
    """Device-memory bytes of one forward under the partition, the JAX
    package's model: every cross-block value is written by its producer and
    read by each consuming block, intra-block values stay on chip; edge
    values have e_pad rows, node values n_node; weights count once per MM
    and graph inputs once per reading op."""
    block_of = {o: i for i, b in enumerate(blocks) for o in b}
    total = 0
    for op in graph.ops:
        w = op.extra.get("weight")
        if w is not None:
            total += w[1] * w[2] * dtype_bytes
        for i in op.inputs:
            if i == ir.X_INPUT:
                total += stats.n_node * graph.in_width * dtype_bytes
            elif i == ir.EDGE_WEIGHT:
                total += stats.e_pad * dtype_bytes
    consumers: Dict[int, set] = {}
    for u, v in graph.edges():
        if block_of[u] != block_of[v]:
            consumers.setdefault(u, set()).add(block_of[v])
    for op in graph.ops:
        rows = stats.n_node if op.out_domain == ir.NODE else stats.e_pad
        nbytes = rows * max(op.out_width, 1) * dtype_bytes
        outside = consumers.get(op.op_id, set())
        if outside or op.op_id in graph.outputs:
            total += nbytes                       # producer writes once
        total += nbytes * len(outside)            # each consumer block reads
    return total


# ---------------------------------------------------------------------------
# Hopper shared-memory rule (in place of the TPU's VMEM rules)
# ---------------------------------------------------------------------------

SMEM_BLOCK_BYTES = 232_448   # dynamic shared memory one H100 block may use
LOCAL_INDEX_MAX = 32_000     # tilings keep int16 block-local offsets below

# the kernel kinds each path lowers to (classify_block)
PATH_KINDS = {
    PATH_XLA: (),
    PATH_ONEHOT: ("spmm", "gat", "gat_layer", "sddmm", "pair_agg", "gatv2"),
    PATH_HYBRID: ("spmm_hybrid", "gat_hybrid"),
    PATH_GROUPED: ("spmm_grouped",),
    PATH_STREAM: ("spmm_stream", "gat_stream"),
    PATH_DENSEFULL: ("spmm_densefull",),
}


def _gat_wgmma_width(H: int, D: int) -> int:
    """N, the padded head width of K4's bf16 wgmma path
    (csrc/wgmma.cuh wgmma_width): the next of 8, 32, 48, 64, 128
    at or above D, for 1, 2, 4 or 8 heads with H N <= 128; else 0 (the
    shape runs on the mma.sync kernel)."""
    if H not in (1, 2, 4, 8):
        return 0
    n = next((w for w in (8, 32, 48, 64, 128) if w >= D), 0)
    return n if H * n <= 128 else 0


def _dense_attention_smem(HD: int, H: int, dtype_bytes: int, panel: bool,
                          values_bytes: Optional[int] = None) -> int:
    """K4 (``panel`` False) / K15 (``panel`` True), csrc/gat_dense_blocks.cu,
    as their wrappers pass it to the launch.  bf16 h on the wgmma path
    (``_gat_wgmma_width`` > 0): 3 ring stages of the h panel (H N rows of
    128 bytes), a count tile of 64 columns by 256 rows (int8 counts,
    ``values_bytes`` 1, or bf16 values, 2, in the larger of its two
    layouts; None: the larger) and a_s of the chunk (K15: a_s, E1s and E2s,
    three arrays [64, H]), each stage rounded up to 1 KB, plus 1 KB of alignment and the rows' terms
    (K4: a_d and the bound; K15: a_d,
    E1d and E2d); else the mma.sync / FMA kernel's smem_bytes (column chunk
    and tensor-core choice as its launch_h picks them)."""
    n = _gat_wgmma_width(H, HD // H) if dtype_bytes == 2 else 0
    if n:
        # K4: a_s per column and head; K15: a_s, E1s and E2s
        cols = 3 * H if panel else H
        rows = 3 if panel else 2        # a_d, bound [| E2d] per head

        def ring(vb):
            tile = max(64 * (256 * vb + 16), 256 * (64 * vb + 16))
            stage = -(-(H * n * 128 + tile + 64 * 4 * cols) // 1024) * 1024
            return 3 * stage + 1024 + rows * 256 * H * 4
        return (max(ring(1), ring(2)) if values_bytes is None
                else ring(values_bytes))
    BM, PAD = 64, 8
    cc = 32
    while cc > 4 and H * BM * cc * 4 > 32 * 1024:
        cc //= 2
    f = BM * (HD + H) + cc * H + 2 * BM * H + BM * cc + (
        cc * 2 * H + BM * H if panel else 0)
    if dtype_bytes == 2 and cc % 16 == 0:
        return f * 4 + (HD + H * BM) * (cc + PAD) * 2
    return (f + cc * HD + H * BM * cc) * 4


def _dense_bwd_smem(HD: int, H: int, dtype_bytes: int, src_mode: bool,
                    values_bytes: Optional[int] = None) -> int:
    """K7 (``src_mode`` False, csrc/gat_dense_bwd_dad.cu) / K8
    (csrc/gat_dense_bwd_src.cu), as their wrapper passes it to the launch.
    bf16 h on the wgmma path (``_gat_wgmma_width`` > 0; the ring of
    csrc/gat_bwd.cuh TcStage): 3 ring stages of the column panel rows (H
    KT rows of 128 bytes, KT = N padded to 16), a count tile of 64 columns
    by 128 rows (int8 counts, ``values_bytes`` 1, or bf16 values, 2, each
    column padded by 16 bytes; None: the larger) and the columns' terms
    (K7: a_s, K8: four terms per head; 64 f32 each), each stage rounded up
    to 1 KB, then for K8 the 256 threads' te A fragments (16 bytes a head
    and k-step each), and 1 KB of alignment; else the dense walk's 64-row
    sub-tile: the rows' vectors and side values, a 64 x 65 count chunk and
    the rows' accumulators (H wide for K7, H + HD for K8), float32."""
    n = _gat_wgmma_width(H, HD // H) if dtype_bytes == 2 else 0
    if n:
        kt = -(-n // 16) * 16
        terms, frags = (4 * H, 256 * H * kt) if src_mode else (H, 0)

        def ring(vb):
            stage = H * kt * 128 + 64 * (128 * vb + 16) + terms * 64 * 4
            return 3 * (-(-stage // 1024) * 1024) + frags + 1024
        return (max(ring(1), ring(2)) if values_bytes is None
                else ring(values_bytes))
    width = H + (HD if src_mode else 0)
    return 4 * (64 * HD + 64 * 4 * H + 64 * 65 + 64 * width)


def _spmm_dense_smem(F: int, dtype_bytes: int,
                     values_bytes: Optional[int] = None) -> int:
    """K2, csrc/spmm_dense_blocks.cu, as its wrapper passes it to the
    launch: 3 ring stages of a 256-row count tile (int8 counts,
    ``values_bytes`` 1: 128 columns in 144-byte rows; bf16 values, 2: 64 in
    160; None: the larger) and an x tile at feature tile N, plus 1 KB of
    alignment; the float32 path requests none."""
    if dtype_bytes != 2:
        return 0
    n = 64 if F <= 64 else 128
    stage = {1: 256 * 144 + 128 * n * 2, 2: 256 * 160 + 64 * n * 2}
    return 3 * (max(stage.values()) if values_bytes is None
                else stage[values_bytes]) + 1024


def _gat_layer_smem(HD: int, H: int, dtype_bytes: int) -> int:
    """K14's projection, csrc/gat_layer.cu, as its wrapper passes it to the
    launch (the walk and the epilogue request none).  bf16 at HD <= 128
    (N = ``_gat_wgmma_width(1, HD)``): the larger of 3 ring stages of [x
    tile 128 rows x 128 bytes | W panel N rows x 128 bytes] and the
    epilogue's f32 hq tile [128, N + 1] that reuses their space, plus 1 KB
    of alignment and wa_s | wa_d [HD, 2H] f32; else the FMA kernel's f32
    hq tile [64, HP] (HP = HD padded to 16), wa_s | wa_d and its k-chunk
    staging of x [64, 32] and W [32, HP]."""
    n = _gat_wgmma_width(1, HD) if dtype_bytes == 2 else 0
    if n:
        ring = 3 * (128 * 128 + n * 128)
        return max(ring, 128 * (n + 1) * 4) + 1024 + 8 * HD * H
    hp = (HD + 15) // 16 * 16
    return (64 * hp + 2 * HD * H + 64 * 32 + 32 * hp) * 4


def _kind_smem(kind: str, HD: int, H: int, dtype_bytes: int) -> int:
    """The largest dynamic shared memory, in bytes, that a kernel of
    ``kind`` (forward and backward) requests at width HD and H heads, by
    the formula beside its launch."""
    gat_tail = HD * H * 4                           # K3's, K10's a_s pass: gat_as.cuh
    if kind == "gat":
        return gat_tail                             # K5, K6 request none
    if kind == "gat_hybrid":
        return max(gat_tail,                        # K3, K10
                   _dense_attention_smem(HD, H, dtype_bytes, False),
                   _dense_attention_smem(HD, H, dtype_bytes, True),
                   _dense_bwd_smem(HD, H, dtype_bytes, False),
                   _dense_bwd_smem(HD, H, dtype_bytes, True))
    if kind == "gat_layer":                         # K14: gat_layer.cu
        return _gat_layer_smem(HD, H, dtype_bytes)
    if kind == "spmm_hybrid":                       # K2 (K1: none)
        return _spmm_dense_smem(HD, dtype_bytes)
    return 0                                        # K1, K9, K11-K13, K17: none


def smem_bytes(tile: TileConfig, feat_width: int, heads: int = 1,
               dtype_bytes: int = 4, kind: Optional[str] = None) -> int:
    """Dynamic shared memory one block of the port's kernels requests for
    ``tile``'s path at feature width ``feat_width`` (HD for attention) and
    ``heads``: the largest over the kinds the path lowers to, or of
    ``kind`` alone.  The port's kernels stage per-feature rows or a ring of
    fixed-size chunks, never a tile-sized buffer, so the tile's geometry
    does not enter."""
    kinds = (kind,) if kind is not None else PATH_KINDS.get(tile.path, ())
    return max([_kind_smem(k, feat_width, heads, dtype_bytes)
                for k in kinds] + [0])


def tile_is_feasible(tile: TileConfig, feat_width: int,
                     smem_budget: Optional[int] = None, heads: int = 1,
                     dtype_bytes: int = 4, kind: Optional[str] = None
                     ) -> bool:
    """Whether the port's kernels run ``tile`` at ``feat_width``: a path
    the port lowers, block-local offsets that fit the int16 tile arrays,
    and the shared memory of :func:`smem_bytes` within ``smem_budget``
    (default the hardware config's, 232,448 bytes on an H100)."""
    from ..hwconfig import load_hw_config
    if tile.path not in PATH_KINDS:
        return False
    if max(tile.block_rows, tile.block_cols) >= LOCAL_INDEX_MAX:
        return False
    budget = (smem_budget if smem_budget is not None
              else load_hw_config().smem_budget_bytes)
    return smem_bytes(tile, feat_width, heads, dtype_bytes, kind) <= budget


def default_schedule(graph: ir.OpGraph) -> Schedule:
    """Pattern super-fusion when available, else max legal fusion."""
    blocks = pattern_partition(graph) or max_fusion_partition(graph)
    return Schedule(blocks=blocks, tiles=tuple(TileConfig() for _ in blocks))
