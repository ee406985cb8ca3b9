"""Schedule lowering: matched blocks run on the Hopper kernels, the rest
op by op.

Counterpart of the JAX package's ``compiler/fusion.py``.  Classification
(:func:`classify_block`) is the JAX package's, so both packages agree on
what each (block, TileConfig) lowers to.  The port lowers the kinds
``xla``, ``spmm``, ``spmm_grouped``, ``spmm_hybrid``, ``gat``,
``gat_hybrid``, ``gat_layer`` (the whole layer on K14), ``sddmm`` (the
attention-logit block on K11) and ``pair_agg`` (the DGN / PNA aggregation
on K13); every other kind raises ``NotImplementedError`` naming its
ROADMAP.md item instead of running silently on the per-op path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import ir
from ..graph import (GraphTensor, HostGraph, hybrid_graph, resolve_device,
                     separable_weight_scales, tile_graph, tile_graph_grouped,
                     transpose_host_graph)
from ..ops import dense as dense_mod
from ..ops import gat as gat_mod
from ..ops import pairagg as pair_mod
from ..ops import primitives as P
from ..ops import sddmm as sddmm_mod
from ..ops import spmm as spmm_mod
from . import schedule as S
from .lower import _eval_op
from .schedule import Schedule, TileConfig

# the port's own kernel version: it keys the tuner's memo
# (tune/search.py), so a measurement of older kernels never resurfaces
KERNEL_VERSION = 3


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
    ``(kind, plan)``, exactly as the JAX package classifies it."""
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
    if (tc.kernel and spmm_plan is None and layer_plan is None
            and gat_plan is None and sddmm_plan is None):
        pair_plan = pair_mod.match_pair_agg(graph, block)
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
    return "xla", None


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
    runs op by op.  The default geometries are that script's."""
    out = []
    for graph in layers:
        part = S.pattern_partition(graph)
        tc, want = gat_tile, "gat_hybrid"
        if part is None:
            part = S.aggregation_partition(graph)
            tc, want = spmm_tile, "spmm_hybrid"
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
                       tile: TileConfig = TileConfig(1024, 1024, 512)
                       ) -> List[Schedule]:
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


# kinds this slice does not lower yet, with the ROADMAP.md item that ports
# each of them
NOT_PORTED = {
    "spmm_densefull": "Queue 1 item 9 (PATH_DENSEFULL)",
    "spmm_stream": "Queue 1 item 9 (chunked stream path)",
    "gat_stream": "Queue 1 item 9 (chunked stream path)",
}


def lower_schedule(
    graph: ir.OpGraph,
    schedule: Schedule,
    host_graph: HostGraph,
    compute_dtype: Optional[torch.dtype] = None,
    *,
    device=None,
    build_transpose: bool = False,
    tile_cache: Optional[Dict] = None,
) -> Callable[[Dict[str, torch.Tensor], GraphTensor, torch.Tensor],
              torch.Tensor]:
    """Lower ``graph`` under ``schedule`` to ``apply(params, g, x)``.

    Host side, once: builds the tilings and hybrid splits the matched
    blocks need, on ``device`` (default the CUDA card).  ``tile_cache``
    shares them across the layers of a model.  ``build_transpose`` also
    tiles or splits the TRANSPOSED graph (kept in
    ``tile_cache["transpose"]``) for every SpMM, attention and hybrid
    block, so its gradient runs the kernels (dx = Aᵀ ȳ, and the attention
    backward K5-K8) instead of autograd of the plain formulation; it doubles
    the set-up and the tilings' device memory.  The ``gat_layer``,
    ``sddmm`` and ``pair_agg`` kinds run forward on their kernels and
    differentiate through their plain per-edge formulations, as in the JAX
    package."""
    device = resolve_device(device)
    cache = tile_cache if tile_cache is not None else {}
    tiled: Dict[tuple, object] = cache.setdefault("tiled", {})
    hybrids: Dict[tuple, object] = cache.setdefault("hybrids", {})
    host_graph_t = None
    if build_transpose:
        if "transpose" not in cache:
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
            scales = (None if (unit_weight or kind == "gat")
                      else separable_weight_scales(hg))
            int8 = unit_weight or kind == "gat" or scales is not None
            drows = tc.dense_block or tc.block_rows
            dcols = tc.dense_block or tc.block_cols
            thr = dense_mod.hybrid_threshold(
                hg, kind, heads=heads, head_dim=head_dim,
                value_bytes=1 if int8 else 4, dense_rows=drows,
                dense_cols=dcols)
            hyb = hybrid_graph(
                hg, block_rows=drows, block_cols=dcols,
                sparse_block_rows=tc.block_rows,
                sparse_block_cols=tc.block_cols, tile_edges=tc.tile_edges,
                min_nnz=thr, unit_weight=unit_weight,
                block_layout="cr" if kind == "gat" else "rc",
                supergroup=0 if kind == "gat" else 16,
                values_dtype=np.int8 if int8 else np.float32, device=device)
            if scales is not None and hyb.dense is not None:
                hyb = dataclasses.replace(
                    hyb, row_scale=torch.as_tensor(scales[0], device=device),
                    col_scale=torch.as_tensor(scales[1], device=device))
            hybrids[key] = hyb
        return hybrids[key]

    # (kind, block, tc, plan, graph data, transposed twin or None)
    plans: List[tuple] = []
    for block, tc in zip(schedule.blocks, schedule.tiles):
        kind, plan = classify_block(graph, block, tc)
        if kind in NOT_PORTED:
            raise NotImplementedError(
                f"block {block} lowers to {kind!r}, which the port does not "
                f"run yet: ROADMAP.md {NOT_PORTED[kind]}")
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
        elif kind in ("gat_layer", "sddmm", "pair_agg"):
            data = get_tiled(tc, unit_weight=True)
            if kind == "pair_agg" and data.src_local.is_cuda:
                # K13's work list, at set-up rather than in a request
                pair_mod.pair_work(data, host_graph.n_node)
        else:
            data = None
        plans.append((kind, block, tc, plan, data, twin))

    outputs = list(graph.outputs)
    inv_deg = None
    if any(p[0] in ("spmm", "spmm_grouped", "spmm_hybrid") and p[3].mean
           for p in plans):
        deg = np.bincount(host_graph.receivers,
                          minlength=host_graph.n_node + 1)[: host_graph.n_node]
        inv_deg = torch.as_tensor(1.0 / np.maximum(deg, 1),
                                  dtype=torch.float32, device=device)[:, None]

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

        for kind, block, tc, plan, data, twin in plans:
            if kind in ("spmm", "spmm_grouped"):
                vals[plan.out_op] = seg_out(plan, spmm_mod.spmm(
                    data, kin(ref(plan.in_op)), tg_t=twin))
            elif kind == "spmm_hybrid":
                vals[plan.out_op] = seg_out(plan, dense_mod.spmm_hybrid(
                    data, g, kin(ref(plan.in_op)), weighted=plan.weighted,
                    hyb_t=twin))
            elif kind == "sddmm":
                vals[plan.out_op] = sddmm_mod.sddmm_edges(
                    data, g, kin(ref(plan.src_op)), kin(ref(plan.dst_op)),
                    plan.compute)
            elif kind == "pair_agg":
                y_sum, y_max, cnt = pair_mod.pair_aggregate(
                    data, side(plan.cterms), side(plan.rterms), sf=plan.sf,
                    slope=plan.slope, want_max=ir.MAX in plan.gathers)
                if ir.ADD in plan.gathers:
                    vals[plan.gathers[ir.ADD]] = y_sum
                if ir.MAX in plan.gathers:
                    vals[plan.gathers[ir.MAX]] = y_max
                if ir.MEAN in plan.gathers:
                    vals[plan.gathers[ir.MEAN]] = y_sum / cnt.clamp(min=1.0)
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
                    vals[oid] = _eval_op(graph.by_id[oid], vals, params, g,
                                         x, compute_dtype)
        if len(outputs) == 1:
            return vals[outputs[0]]
        return {o: vals[o] for o in outputs}

    # (kind, block, graph data, transposed twin) per block, for inspection
    # and kernel checks; a ``gat`` block's twin is (tiling, perm)
    apply.plans = [(p[0], p[1], p[4], p[5]) for p in plans]
    return apply
