"""Schedule lowering: matched blocks run on the Hopper kernels, the rest
op by op.

Counterpart of the JAX package's ``compiler/fusion.py``.  Classification
(:func:`classify_block`) is the JAX package's, so both packages agree on
what each (block, TileConfig) lowers to, and the port lowers every kind
it names: ``xla``, ``spmm``, ``spmm_grouped``, ``spmm_hybrid``, ``gat``,
``gat_hybrid``, ``gat_layer`` (the whole layer on K14), ``sddmm`` (the
attention-logit block on K11), ``pair_agg`` (the DGN / PNA aggregation on
K13), ``gatv2`` (GATv2's attention on K17, which the JAX package does
not know), ``spmm_stream`` and ``gat_stream`` (the edge-chunk loops of
``ops/chunked.py``) and ``spmm_densefull`` (one product with the full
dense adjacency, ``graph.dense_adjacency``; above ``DENSEFULL_MAX_N``
nodes the block runs op by op, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import ir
from ..graph import (DENSE_ROWS, DENSEFULL_MAX_N, GraphTensor, HostGraph,
                     dense_adjacency, hybrid_graph, resolve_device,
                     separable_weight_scales, tile_graph, tile_graph_grouped,
                     transpose_host_graph)
from ..ops import chunked
from ..ops import dense as dense_mod
from ..ops import gat as gat_mod
from ..ops import gatv2 as gatv2_mod
from ..ops import pairagg as pair_mod
from ..ops import primitives as P
from ..ops import sddmm as sddmm_mod
from ..ops import sinput as sinput_mod
from ..ops import spmm as spmm_mod
from ..utils.spans import count, span, spanned
from . import schedule as S
from .lower import _eval_op
from .schedule import Schedule, TileConfig

# the port's own kernel version: it keys the tuner's memo
# (tune/search.py), so a measurement of older kernels never resurfaces
KERNEL_VERSION = 4


@dataclasses.dataclass
class _SpmmPlan:
    in_op: int              # external producer (or X_INPUT) feeding the scatter
    out_op: int             # the gather op id (block output)
    weighted: bool          # True if the apply_edge MUL edge_weight is inside
    mean: bool = False      # gather MEAN: segment sum + 1/in-degree post-scale


@dataclasses.dataclass
class _SddmmPlan:
    src_op: int
    dst_op: int
    out_op: int
    compute: str            # ADD or MUL


def match_sddmm(graph: ir.OpGraph,
                block: Sequence[int]) -> Optional[_SddmmPlan]:
    """Match scatter(C) + scatter(R) + apply_edge(ADD|MUL)."""
    if len(block) != 3:
        return None
    ops = [graph.by_id[o] for o in block]
    kinds = sorted(op.kind for op in ops)
    if kinds != sorted([ir.SCATTER, ir.SCATTER, ir.APPLY_EDGE]):
        return None
    ae = next(o for o in ops if o.kind == ir.APPLY_EDGE)
    scs = [o for o in ops if o.kind == ir.SCATTER]
    if ae.compute not in (ir.ADD, ir.MUL):
        return None
    if sorted(ae.inputs) != sorted([s.op_id for s in scs]):
        return None
    if {scs[0].order, scs[1].order} != {"R", "C"}:
        return None
    sc_c = scs[0] if scs[0].order == "C" else scs[1]
    sc_r = scs[0] if scs[0].order == "R" else scs[1]
    if sc_c.compute != ir.NONE or sc_r.compute != ir.NONE:
        return None
    if len(sc_c.inputs) != 1 or len(sc_r.inputs) != 1:
        return None
    return _SddmmPlan(src_op=sc_c.inputs[0], dst_op=sc_r.inputs[0],
                      out_op=ae.op_id, compute=ae.compute)


def match_spmm(graph: ir.OpGraph,
               block: Sequence[int]) -> Optional[_SpmmPlan]:
    """Match scatter(C) [-> apply_edge MUL edge_weight] -> gather(ADD|MEAN)."""
    ops = [graph.by_id[o] for o in block]
    kinds = sorted(op.kind for op in ops)
    if len(ops) == 3:
        if kinds != sorted([ir.SCATTER, ir.APPLY_EDGE, ir.GATHER]):
            return None
        sc = next(o for o in ops if o.kind == ir.SCATTER)
        ae = next(o for o in ops if o.kind == ir.APPLY_EDGE)
        ga = next(o for o in ops if o.kind == ir.GATHER)
        if ae.compute != ir.MUL or set(ae.inputs) != {sc.op_id,
                                                      ir.EDGE_WEIGHT}:
            return None
        if ga.inputs != [ae.op_id]:
            return None
        weighted = True
    elif len(ops) == 2:
        if kinds != sorted([ir.SCATTER, ir.GATHER]):
            return None
        sc = next(o for o in ops if o.kind == ir.SCATTER)
        ga = next(o for o in ops if o.kind == ir.GATHER)
        if ga.inputs != [sc.op_id]:
            return None
        weighted = False
    else:
        return None
    if sc.order != "C" or sc.compute != ir.NONE:
        return None
    if ga.compute not in (ir.ADD, ir.MEAN) or ga.order != "R":
        return None
    if len(sc.inputs) != 1:
        return None
    return _SpmmPlan(in_op=sc.inputs[0], out_op=ga.op_id, weighted=weighted,
                     mean=ga.compute == ir.MEAN)


def classify_block(graph: ir.OpGraph, block, tc: TileConfig):
    """Which execution path a (block, TileConfig) pair lowers to:
    ``(kind, plan)``, exactly as the JAX package classifies it, and the
    GATv2 chain on the ``onehot`` path as ``gatv2`` (K17)."""
    spmm_plan = match_spmm(graph, block) if tc.kernel else None
    layer_plan = (gat_mod.match_gat_layer(graph, block)
                  if tc.kernel and spmm_plan is None else None)
    gat_plan = (gat_mod.match_gat_block(graph, block)
                if tc.kernel and spmm_plan is None and layer_plan is None
                else None)
    sddmm_plan = (match_sddmm(graph, block)
                  if tc.kernel and spmm_plan is None
                  and layer_plan is None and gat_plan is None else None)
    pair_plan = None
    gatv2_plan = None
    if (tc.kernel and spmm_plan is None and layer_plan is None
            and gat_plan is None and sddmm_plan is None):
        pair_plan = pair_mod.match_pair_agg(graph, block)
        gatv2_plan = gatv2_mod.match_gatv2(graph, block)
    if tc.path == S.PATH_GROUPED:
        return ("spmm_grouped", spmm_plan) if spmm_plan is not None \
            else ("xla", None)
    if tc.path == S.PATH_DENSEFULL:
        return ("spmm_densefull", spmm_plan) if spmm_plan is not None \
            else ("xla", None)
    if tc.path == S.PATH_STREAM and (spmm_plan or gat_plan):
        return ("spmm_stream" if spmm_plan else "gat_stream",
                spmm_plan or gat_plan)
    if tc.path == S.PATH_HYBRID and spmm_plan is not None:
        return "spmm_hybrid", spmm_plan
    if tc.path == S.PATH_HYBRID and gat_plan is not None:
        return "gat_hybrid", gat_plan
    if spmm_plan is not None:
        return "spmm", spmm_plan
    if layer_plan is not None and tc.path == S.PATH_ONEHOT:
        return "gat_layer", layer_plan
    if gat_plan is not None:
        return "gat", gat_plan
    if sddmm_plan is not None:
        return "sddmm", sddmm_plan
    if pair_plan is not None and tc.path == S.PATH_ONEHOT:
        return "pair_agg", pair_plan
    if gatv2_plan is not None and tc.path == S.PATH_ONEHOT:
        return "gatv2", gatv2_plan
    return "xla", None


# the ``onehot`` tile the pair aggregate (K13) runs on by default
PAIR_TILE = TileConfig(1024, 1024, 512)


def hybrid_schedules(layers: Sequence[ir.OpGraph], *,
                     spmm_tile: TileConfig = TileConfig(
                         1024, 1024, 512, S.PATH_HYBRID, dense_block=256),
                     gat_tile: TileConfig = TileConfig(
                         512, 1024, 512, S.PATH_HYBRID, dense_block=256)
                     ) -> List[Schedule]:
    """Per-layer schedules of the hybrid serving path, built as the JAX
    package's ``scripts/reddit_train.py`` builds them: GCN-style layers
    isolate their aggregation (``aggregation_partition``) and run it as
    ``spmm_hybrid``; GAT layers fuse the attention chain
    (``pattern_partition``) and run it as ``gat_hybrid``; every other block
    runs op by op.  The default geometries are that script's.  A layer with
    neither runs a GATv2 attention chain as ``gatv2`` (K17) on
    ``PAIR_TILE``, whose work list it walks, and else an aggregation that
    is a pair chain (DGN, PNA) as ``pair_agg`` on ``PAIR_TILE``, as
    :func:`pair_agg_schedules` does."""
    out = []
    for graph in layers:
        part = S.pattern_partition(graph)
        tc, want = gat_tile, "gat_hybrid"
        if part is None:
            part = S.aggregation_partition(graph)
            tc, want = spmm_tile, "spmm_hybrid"
        if part is None:
            part = S.gatv2_partition(graph)
            tc, want = PAIR_TILE, "gatv2"
        if part is None:
            part = S.pair_agg_partition(graph)
            tc, want = PAIR_TILE, "pair_agg"
        if part is None:
            raise ValueError(f"{graph.name}: no hybrid-path block")
        tiles = tuple(tc if classify_block(graph, b, tc)[0] == want
                      else TileConfig(path=S.PATH_XLA) for b in part)
        out.append(Schedule(blocks=part, tiles=tiles))
    return out


def _one_kind(graph: ir.OpGraph, part, tc: TileConfig,
              kind: str) -> Schedule:
    """``part`` with its one block of ``kind`` on ``tc`` and every other
    block op by op."""
    tiles = tuple(tc if classify_block(graph, b, tc)[0] == kind
                  else TileConfig(path=S.PATH_XLA) for b in part)
    if sum(t is tc for t in tiles) != 1:
        raise ValueError(f"{graph.name}: expected one {kind} block")
    return Schedule(blocks=tuple(tuple(b) for b in part), tiles=tiles)


def pair_agg_schedules(layers: Sequence[ir.OpGraph], *,
                       tile: TileConfig = PAIR_TILE) -> List[Schedule]:
    """Per-layer schedules of DGN / PNA on the fused pair aggregate: each
    layer's ``pair_agg_partition`` with the pair chain on ``tile`` (the
    ``onehot`` path; the kind ``pair_agg``), every other op alone."""
    out = []
    for graph in layers:
        part = S.pair_agg_partition(graph)
        if part is None:
            raise ValueError(f"{graph.name}: no pair-sum aggregation chain")
        out.append(_one_kind(graph, part, tile, "pair_agg"))
    return out


def gat_onehot_schedules(layers: Sequence[ir.OpGraph], *, whole_layer: bool,
                         tile: TileConfig = TileConfig(512, 1024, 512)
                         ) -> List[Schedule]:
    """Per-layer schedules of GAT on the ``onehot`` path at ``tile`` (the
    geometry of the JAX package's one-hot recipe,
    ``scripts/reddit_train.py``): with ``whole_layer`` each layer's
    ``layer_partition`` as the one ``gat_layer`` block (K14), else its
    ``pattern_partition`` with the attention chain as the ``gat`` kind (K3;
    its backward K5 and K6 with ``build_transpose``)."""
    part_of, kind = ((S.layer_partition, "gat_layer") if whole_layer
                     else (S.pattern_partition, "gat"))
    out = []
    for graph in layers:
        part = part_of(graph)
        if part is None:
            raise ValueError(f"{graph.name}: no {kind} block")
        out.append(_one_kind(graph, part, tile, kind))
    return out


def sddmm_schedules(layers: Sequence[ir.OpGraph], *,
                    tile: TileConfig = TileConfig(1024, 1024, 512)
                    ) -> List[Schedule]:
    """Per-layer schedules of GAT with its attention-logit block
    (scatter(C) + scatter(R) + their apply_edge ADD) on ``tile``, where it
    lowers to the ``sddmm`` kind, and every other op alone."""
    out = []
    for graph in layers:
        add = next((op for op in graph.ops
                    if op.kind == ir.APPLY_EDGE and op.compute == ir.ADD
                    and len(op.inputs) == 2
                    and all(i >= 0 and graph.by_id[i].kind == ir.SCATTER
                            for i in op.inputs)), None)
        if add is None:
            raise ValueError(f"{graph.name}: no logit block")
        block = sorted(add.inputs + [add.op_id])
        part = S._order_blocks(graph, [block] + [
            [o] for o in graph.topo_order() if o not in block])
        out.append(_one_kind(graph, part, tile, "sddmm"))
    return out


class _Densefull(torch.autograd.Function):
    """y = (A v)[:n] float32 for the bf16 dense adjacency ``a`` [N_pad,
    N_pad] and v [n, F] (the JAX package's ``jnp.dot(A.astype(v.dtype),
    v_padded, preferred_element_type=float32)``).  A bf16 v on the card
    takes one product with float32 output (``torch.mm``'s ``out_dtype``:
    each bf16 product is exact in float32); otherwise A is widened to
    float32 ``DENSE_ROWS`` rows at a time (TF32 stays off).  The
    backward, dv = A[:n, :n]ᵀ ȳ in float32 rounded to v's dtype, widens A
    the same way: autograd has no derivative for the ``out_dtype``
    overload, and this one holds A in bf16 only."""

    @staticmethod
    def forward(ctx, a, v):
        ctx.save_for_backward(a)
        ctx.v_dtype = v.dtype
        n = v.shape[0]
        if v.is_cuda and v.dtype == torch.bfloat16:
            vp = torch.nn.functional.pad(v, (0, 0, 0, a.shape[1] - n))
            return torch.mm(a[:n], vp, out_dtype=torch.float32)
        vf = v.float()
        return torch.cat([a[rows, :n].float() @ vf for rows in _row_blocks(n)])

    @staticmethod
    def backward(ctx, gy):
        a, = ctx.saved_tensors
        n = gy.shape[0]
        gy = gy.float()
        dv = torch.zeros_like(gy)
        for rows in _row_blocks(n):
            dv += a[rows, :n].float().t() @ gy[rows]
        return None, dv.to(ctx.v_dtype)


def _row_blocks(n: int):
    return [slice(i, min(i + DENSE_ROWS, n))
            for i in range(0, n, DENSE_ROWS)]


@spanned("lower.layer")
def lower_schedule(
    graph: ir.OpGraph,
    schedule: Schedule,
    host_graph: HostGraph,
    compute_dtype: Optional[torch.dtype] = None,
    *,
    device=None,
    x_host: Optional[np.ndarray] = None,
    build_transpose: bool = False,
    tile_cache: Optional[Dict] = None,
) -> Callable[[Dict[str, torch.Tensor], GraphTensor, torch.Tensor],
              torch.Tensor]:
    """Lower ``graph`` under ``schedule`` to ``apply(params, g, x)``.

    Host side, once: builds the tilings and hybrid splits the matched
    blocks need, on ``device`` (default the CUDA card).  ``tile_cache``
    shares them across the layers of a model.  ``x_host``: the dataset's
    features (numpy); when their density is below
    ``sinput.SPARSITY_THRESHOLD`` and the graph has an MM of the input
    features, that MM runs ``sinput.sparse_input_mm`` over X's nonzeros
    (K1 and K2 over the bipartite feature graph, built here once).  X is
    baked: ``apply`` must then be called with those features.  ``build_transpose`` also
    tiles or splits the TRANSPOSED graph (kept in
    ``tile_cache["transpose"]``) for every SpMM, attention and hybrid
    block, so its gradient runs the kernels (dx = Aᵀ ȳ, and the attention
    backward K5-K8) instead of autograd of the plain formulation; it doubles
    the set-up and the tilings' device memory.  The ``gat_layer``,
    ``sddmm``, ``pair_agg`` and ``gatv2`` kinds run forward on their kernels and
    differentiate through their plain per-edge formulations, as in the JAX
    package; the stream and densefull kinds are plain PyTorch, which
    autograd differentiates.  ``spmm_stream`` and ``gat_stream`` stream
    chunks of ``tile_edges * 2048`` edges; ``spmm_densefull`` builds the
    bf16 adjacency once per weighting (shared through ``tile_cache``)."""
    device = resolve_device(device)
    cache = tile_cache if tile_cache is not None else {}
    tiled: Dict[tuple, object] = cache.setdefault("tiled", {})
    hybrids: Dict[tuple, object] = cache.setdefault("hybrids", {})
    host_graph_t = None
    if build_transpose:
        if "transpose" not in cache:
            with span("lower.transpose"):
                cache["transpose"] = transpose_host_graph(host_graph)
        host_graph_t = cache["transpose"][0]

    def get_perm_t():
        """The transposed graph's edge permutation on ``device`` (the
        ``gat`` kind's ``ev_perm_t``)."""
        key = ("perm_t", str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(cache["transpose"][1], device=device)
        return cache[key]

    def get_tiled(tc: TileConfig, unit_weight: bool,
                  hg: Optional[HostGraph] = None):
        """The per-tile tiling, or for PATH_GROUPED the grouped tiling of
        ``GROUPED_G`` sub-tiles per chunk, of ``hg`` (default the forward
        graph)."""
        hg = hg if hg is not None else host_graph
        grouped = tc.path == S.PATH_GROUPED
        key = (id(hg), str(device), tc.block_rows, tc.block_cols,
               tc.tile_edges, unit_weight, grouped)
        if key not in tiled:
            geo = dict(block_rows=tc.block_rows, block_cols=tc.block_cols,
                       tile_edges=tc.tile_edges, unit_weight=unit_weight,
                       device=device)
            tiled[key] = (tile_graph_grouped(hg, group=S.GROUPED_G, **geo)
                          if grouped else tile_graph(hg, **geo))
        return tiled[key]

    def get_hybrid(tc: TileConfig, unit_weight: bool, kind: str,
                   heads: int = 1, head_dim: int = 128,
                   hg: Optional[HostGraph] = None):
        """The density-split build of the JAX package's hybrid recipe: int8
        count blocks on the dense grid (budget-capped threshold), the edge
        tail at the schedule's tile geometry; weighted SpMM keeps exactness
        through separable scales when the weights are the symmetric norm,
        else float32 weight blocks.  ``hg`` (default the forward graph) is
        the graph split; the threshold and scales are computed over it, so
        a transposed twin gets its own, as in the JAX package."""
        hg = hg if hg is not None else host_graph
        key = (id(hg), str(device), tc.key(), unit_weight, kind,
               heads, head_dim)
        if key not in hybrids:
            scales = None
            if not (unit_weight or kind == "gat"):
                with span("lower.scales"):
                    scales = separable_weight_scales(hg)
            int8 = unit_weight or kind == "gat" or scales is not None
            drows = tc.dense_block or tc.block_rows
            dcols = tc.dense_block or tc.block_cols
            with span("lower.threshold"):
                thr = dense_mod.hybrid_threshold(
                    hg, kind, heads=heads, head_dim=head_dim,
                    value_bytes=1 if int8 else 4, dense_rows=drows,
                    dense_cols=dcols)
            with span("lower.split"):
                hyb = hybrid_graph(
                    hg, block_rows=drows, block_cols=dcols,
                    sparse_block_rows=tc.block_rows,
                    sparse_block_cols=tc.block_cols,
                    tile_edges=tc.tile_edges, min_nnz=thr,
                    unit_weight=unit_weight,
                    block_layout="cr" if kind == "gat" else "rc",
                    supergroup=0 if kind == "gat" else 16,
                    values_dtype=np.int8 if int8 else np.float32,
                    device=device)
                count("dense_blocks",
                      0 if hyb.dense is None else hyb.dense.n_blocks)
                count("dense_edges", hyb.n_dense_edges)
                count("tail_edges", hyb.n_sparse_edges)
                count("tail_tiles", hyb.tiles.n_tiles)
                count("tail_slots", hyb.tiles.total_slots)
            if scales is not None and hyb.dense is not None:
                hyb = dataclasses.replace(
                    hyb, row_scale=torch.as_tensor(scales[0], device=device),
                    col_scale=torch.as_tensor(scales[1], device=device))
            hybrids[key] = hyb
        return hybrids[key]

    fg = None
    if x_host is not None:
        xh = np.asarray(x_host)
        if (sinput_mod.density(xh) < sinput_mod.SPARSITY_THRESHOLD
                and any(op.compute == ir.MM and op.inputs == [ir.X_INPUT]
                        for op in graph.ops)):
            fg = sinput_mod.feature_graph(xh, device=device)

    # (kind, block, tc, plan, graph data, transposed twin or None)
    plans: List[tuple] = []
    for block, tc in zip(schedule.blocks, schedule.tiles):
        kind, plan = classify_block(graph, block, tc)
        if kind == "spmm_densefull" and host_graph.n_node > DENSEFULL_MAX_N:
            kind, plan = "xla", None
        twin = None
        if kind == "spmm_hybrid":
            args = (tc, not plan.weighted, "spmm")
        elif kind == "gat_hybrid":
            hd = graph.width_of(plan.h_op)
            args = (tc, True, "gat", plan.heads, hd // plan.heads)
        if kind in ("spmm_hybrid", "gat_hybrid"):
            data = get_hybrid(*args)
            if host_graph_t is not None:
                twin = get_hybrid(*args, hg=host_graph_t)
        elif kind in ("spmm", "spmm_grouped"):
            data = get_tiled(tc, not plan.weighted)
            if host_graph_t is not None:
                twin = get_tiled(tc, not plan.weighted, host_graph_t)
        elif kind == "gat":
            data = get_tiled(tc, unit_weight=True)
            if host_graph_t is not None:
                twin = (get_tiled(tc, True, host_graph_t), get_perm_t())
        elif kind in ("gat_layer", "sddmm", "pair_agg", "gatv2"):
            data = get_tiled(tc, unit_weight=True)
            n = host_graph.n_node
            if (kind in ("pair_agg", "gatv2") and data.src_local.is_cuda
                    and (kind, n) not in data.work_lists):
                # K13's work list (K17 walks it too, with its partial
                # rows), at set-up rather than in a request
                with span("lower.pair_work"):
                    work = pair_mod.pair_work(data, n)
                    count("pair_slots", int(work.slot_src.numel()))
                    count("pair_chunks", work.n_chunks)
                    count("pair_split_rows", int(work.split_rows.numel()))
                    if kind == "gatv2":
                        gatv2_mod.gatv2_work(data, n)
        elif kind == "spmm_densefull":
            key = ("densefull", plan.weighted, str(device))
            if key not in cache:
                cache[key] = dense_adjacency(host_graph,
                                             weighted=plan.weighted,
                                             device=device)
            data = cache[key]
        else:
            data = None
        plans.append((kind, block, tc, plan, data, twin))

    outputs = list(graph.outputs)
    block_spans = ["block.op" if p[0] == "xla" else f"block.{p[0]}"
                   for p in plans]
    inv_deg = scalers = None
    if any(p[0] in ("spmm", "spmm_grouped", "spmm_hybrid", "spmm_stream",
                    "spmm_densefull") and p[3].mean for p in plans):
        deg = np.bincount(host_graph.receivers,
                          minlength=host_graph.n_node + 1)[: host_graph.n_node]
        inv_deg = torch.as_tensor(1.0 / np.maximum(deg, 1),
                                  dtype=torch.float32, device=device)[:, None]
    if any(op.compute == ir.SCALER for op in graph.ops):
        # PNA's degree scalers of the host graph's in-degrees, once for
        # the layers that share ``tile_cache``
        key = ("degree_scalers", id(host_graph), str(device))
        if key not in cache:
            with span("lower.degree_scalers"):
                deg = np.bincount(host_graph.receivers,
                                  minlength=host_graph.n_node + 1
                                  )[: host_graph.n_node]
                cache[key] = {k: v.to(device) for k, v in P.degree_scalers(
                    torch.as_tensor(deg)).items()}
        scalers = cache[key]

    def apply(params: Dict[str, torch.Tensor], g: GraphTensor,
              x: torch.Tensor):
        vals: Dict[int, torch.Tensor] = {}

        def ref(i: int) -> torch.Tensor:
            if i == ir.X_INPUT:
                return x
            if i == ir.EDGE_WEIGHT:
                return g.edge_weight[:, None]
            return vals[i]

        def kin(v: torch.Tensor) -> torch.Tensor:
            # kernel inputs follow the compute dtype
            return v.to(compute_dtype) if compute_dtype is not None else v

        def seg_out(plan, y):
            return y * inv_deg if plan.mean else y

        def side(terms):
            # u or v of a pair aggregation: each term kin(t [@ W]), the
            # product accumulated in float32, summed in the compute dtype
            acc = None
            for rf, wname in terms:
                t = ref(rf)
                if wname is not None:
                    t = P.dense_mm(t, params[wname], compute_dtype)
                acc = kin(t) if acc is None else acc + kin(t)
            return acc

        def w_asrc_of(plan):
            # canonical GAT wiring (a_src = MM(h)): pass the weight so the
            # tail kernel derives a_s from the rows it gathers
            prod = graph.by_id.get(plan.asrc_op)
            if (prod is not None and prod.compute == ir.MM
                    and prod.inputs == [plan.h_op]):
                return params[prod.extra["weight"][0]]
            return None

        def run_block(kind, block, tc, plan, data, twin):
            if kind in ("spmm", "spmm_grouped"):
                vals[plan.out_op] = seg_out(plan, spmm_mod.spmm(
                    data, kin(ref(plan.in_op)), tg_t=twin))
            elif kind == "spmm_hybrid":
                vals[plan.out_op] = seg_out(plan, dense_mod.spmm_hybrid(
                    data, g, kin(ref(plan.in_op)), weighted=plan.weighted,
                    hyb_t=twin))
            elif kind == "spmm_stream":
                # an unweighted block takes the edge mask as its weights
                gw = g if plan.weighted else dataclasses.replace(
                    g, edge_weight=g.edge_mask.float())
                vals[plan.out_op] = seg_out(plan, chunked.spmm_chunked(
                    gw, kin(ref(plan.in_op)), chunk=tc.tile_edges * 2048))
            elif kind == "gat_stream":
                vals[plan.out_op] = chunked.gat_chunked(
                    g, kin(ref(plan.h_op)), kin(ref(plan.asrc_op)),
                    kin(ref(plan.adst_op)),
                    negative_slope=plan.negative_slope,
                    chunk=tc.tile_edges * 2048)
            elif kind == "spmm_densefull":
                vals[plan.out_op] = seg_out(plan, _Densefull.apply(
                    data, kin(ref(plan.in_op))))
            elif kind == "sddmm":
                vals[plan.out_op] = sddmm_mod.sddmm_edges(
                    data, g, kin(ref(plan.src_op)), kin(ref(plan.dst_op)),
                    plan.compute)
            elif kind == "pair_agg":
                u, v = side(plan.cterms), side(plan.rterms)
                if plan.want_min_sq:
                    # K13 writes the aggregates as column slices of one
                    # tensor, in op order, so that an MM of their
                    # concatenation reads it without a copy
                    # (lower.concat_features)
                    order = sorted(plan.gathers, key=plan.gathers.get)
                    y, _ = pair_mod.pair_aggregate(
                        data, u, v, sf=plan.sf, slope=plan.slope,
                        want_min_sq=True, layout=order)
                    got = dict(zip(order, y.split(plan.width, 1)))
                else:
                    y_sum, y_max, cnt = pair_mod.pair_aggregate(
                        data, u, v, sf=plan.sf, slope=plan.slope,
                        want_max=ir.MAX in plan.gathers)
                    got = {ir.ADD: y_sum, ir.MAX: y_max}
                    if ir.MEAN in plan.gathers:
                        got[ir.MEAN] = y_sum / cnt.clamp(min=1.0)
                for r, oid in plan.gathers.items():
                    vals[oid] = got[r]
            elif kind == "gatv2":
                # u and v in the compute dtype, the attention vectors in
                # float32; the output float32
                vals[plan.out_op] = gatv2_mod.gatv2_attention(
                    data, kin(ref(plan.u_op)), kin(ref(plan.v_op)),
                    params[plan.att], slope=plan.slope)
            elif kind == "gat_layer":
                vals[plan.out_op] = gat_mod.gat_layer(
                    data, kin(ref(plan.x_op)), kin(params[plan.w_name]),
                    kin(params[plan.was_name]), kin(params[plan.wad_name]),
                    negative_slope=plan.negative_slope,
                    final_sf=plan.final_sf)
            elif kind in ("gat", "gat_hybrid"):
                w_as = w_asrc_of(plan)
                kw = dict(negative_slope=plan.negative_slope,
                          w_asrc=None if w_as is None else kin(w_as))
                a_src = None if w_as is not None else kin(ref(plan.asrc_op))
                if kind == "gat":
                    tg_t, perm = twin if twin is not None else (None, None)
                    vals[plan.out_op] = gat_mod.gat_attention(
                        data, kin(ref(plan.h_op)), a_src,
                        kin(ref(plan.adst_op)), heads=plan.heads,
                        g=g if twin is not None else None, tg_t=tg_t,
                        ev_perm_t=perm, **kw)
                else:
                    vals[plan.out_op] = dense_mod.gat_hybrid(
                        data, g, kin(ref(plan.h_op)), a_src,
                        kin(ref(plan.adst_op)), hyb_t=twin, **kw)
            else:
                for oid in block:
                    op = graph.by_id[oid]
                    if (fg is not None and op.compute == ir.MM
                            and op.inputs == [ir.X_INPUT]):
                        vals[oid] = sinput_mod.sparse_input_mm(
                            fg, params[op.extra["weight"][0]],
                            compute_dtype=compute_dtype)
                        continue
                    if op.compute == ir.SCALER:
                        vals[oid] = (ref(op.inputs[0])
                                     * scalers[op.extra["scaler"]])
                        continue
                    vals[oid] = _eval_op(op, vals, params, g, x,
                                         compute_dtype)

        for p, name in zip(plans, block_spans):
            with span(name):
                run_block(*p)
        if len(outputs) == 1:
            return vals[outputs[0]]
        return {o: vals[o] for o in outputs}

    # (kind, block, graph data, transposed twin) per block, for inspection
    # and kernel checks; a ``gat`` block's twin is (tiling, perm)
    apply.plans = [(p[0], p[1], p[4], p[5]) for p in plans]
    apply.feature_graph = fg
    return apply
