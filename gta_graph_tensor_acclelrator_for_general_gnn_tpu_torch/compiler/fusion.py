"""Schedule lowering: matched blocks run on the Hopper kernels, the rest
op by op.

Counterpart of the JAX package's ``compiler/fusion.py``.  Classification
(:func:`classify_block`) is the JAX package's, so both packages agree on
what each (block, TileConfig) lowers to.  This slice lowers the kinds
``xla``, ``spmm``, ``spmm_hybrid``, ``gat`` and ``gat_hybrid``; every other
kind raises ``NotImplementedError`` naming its ROADMAP.md item instead of
running silently on the per-op path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import ir
from ..graph import (GraphTensor, HostGraph, TiledGraph, hybrid_graph,
                     separable_weight_scales, tile_graph,
                     transpose_host_graph)
from ..ops import dense as dense_mod
from ..ops import gat as gat_mod
from ..ops import spmm as spmm_mod
from . import schedule as S
from .lower import _eval_op
from .schedule import Schedule, TileConfig


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


# --- pair-sum aggregation matcher (pure IR, from the JAX ops/pairagg.py) ---


@dataclasses.dataclass
class PairAggPlan:
    """u = sum of terms_c (node_ref [@ W]), v = sum of terms_r; per edge
    z = sf(u[src] + v[dst]); ``gathers`` maps reduce -> gather op id."""
    cterms: list
    rterms: list
    sf: Optional[str]
    slope: float
    gathers: Dict[str, int]
    ops: frozenset
    width: int


def _collect_terms(graph: ir.OpGraph, oid: int, allow: set):
    """(cterms, rterms, ops) of the linear pair expression rooted at
    ``oid``, or None."""
    if oid not in allow:
        return None
    op = graph.by_id[oid]
    if (op.kind == ir.SCATTER and op.compute == ir.NONE
            and len(op.inputs) == 1):
        term = [(op.inputs[0], None)]
        return (term, [], {oid}) if op.order == "C" else ([], term, {oid})
    if op.kind == ir.APPLY_EDGE and op.compute == ir.ADD \
            and len(op.inputs) == 2:
        a = _collect_terms(graph, op.inputs[0], allow)
        b = _collect_terms(graph, op.inputs[1], allow)
        if a is None or b is None:
            return None
        return a[0] + b[0], a[1] + b[1], a[2] | b[2] | {oid}
    if op.kind == ir.APPLY_EDGE and op.compute == ir.MM \
            and op.extra.get("weight") and len(op.inputs) == 1:
        inner = _collect_terms(graph, op.inputs[0], allow)
        if inner is None:
            return None
        wname = op.extra["weight"][0]
        if any(w is not None for _, w in inner[0] + inner[1]):
            return None
        ct = [(r, wname) for r, _ in inner[0]]
        rt = [(r, wname) for r, _ in inner[1]]
        return ct, rt, inner[2] | {oid}
    return None


def match_pair_agg(graph: ir.OpGraph,
                   block: Sequence[int]) -> Optional[PairAggPlan]:
    """Match a block that is exactly: a linear pair expression, an optional
    leaky_relu, and 1..3 gathers {ADD, MAX, MEAN} consuming it."""
    allow = set(block)
    B = {o: graph.by_id[o] for o in block}
    gathers = {o: op for o, op in B.items() if op.kind == ir.GATHER}
    if not gathers:
        return None
    roots = {op.inputs[0] for op in gathers.values()}
    if len(roots) != 1:
        return None
    root = next(iter(roots))
    reduces = {}
    for o, op in gathers.items():
        if op.order != "R" or op.compute not in (ir.ADD, ir.MAX, ir.MEAN):
            return None
        if op.compute in reduces:
            return None
        reduces[op.compute] = o
    sf = None
    slope = 0.2
    covered = set(gathers)
    expr_root = root
    rop = B.get(root)
    if rop is None:
        return None
    if rop.kind == ir.APPLY_EDGE and rop.compute == ir.SF:
        if rop.extra.get("sf") != "leaky_relu":
            return None
        sf = "leaky_relu"
        slope = rop.extra.get("negative_slope", 0.2)
        covered.add(root)
        expr_root = rop.inputs[0]
    got = _collect_terms(graph, expr_root, allow)
    if got is None:
        return None
    ct, rt, expr_ops = got
    if not ct or not rt:
        return None
    covered |= expr_ops
    if covered != set(block):
        return None
    consumers: Dict[int, set] = {o: set() for o in graph.by_id}
    for op in graph.ops:
        for i in op.inputs:
            if i in consumers:
                consumers[i].add(op.op_id)
    internal = set(block) - set(gathers)
    if any(consumers[o] - set(block) for o in internal) \
            or (internal & set(graph.outputs)):
        return None
    return PairAggPlan(cterms=ct, rterms=rt, sf=sf, slope=slope,
                       gathers=dict(reduces), ops=frozenset(block),
                       width=graph.by_id[root].out_width)


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
        pair_plan = match_pair_agg(graph, block)
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


# kinds this slice does not lower yet, with the ROADMAP.md item that ports
# each of them
NOT_PORTED = {
    "spmm_grouped": "Queue 1 item 7 (grouped tail)",
    "spmm_densefull": "Queue 1 item 9 (PATH_DENSEFULL)",
    "spmm_stream": "Queue 1 item 9 (chunked stream path)",
    "gat_stream": "Queue 1 item 9 (chunked stream path)",
    "gat_layer": "Queue 2 #15 (whole-layer GAT kernel)",
    "sddmm": "Queue 1 item 8 (SDDMM)",
    "pair_agg": "Queue 1 item 8 (pair aggregation)",
}


def _needs_grad(plan, ref, w_asrc_of) -> bool:
    """True when autograd would need the gradient of a non-hybrid kernel
    block: its kernels have no backward in the port yet."""
    if not torch.is_grad_enabled():
        return False
    if isinstance(plan, _SpmmPlan):
        ins = [ref(plan.in_op)]
    else:
        w = w_asrc_of(plan)
        ins = [ref(plan.h_op), ref(plan.adst_op),
               w if w is not None else ref(plan.asrc_op)]
    return any(t.requires_grad for t in ins)


def lower_schedule(
    graph: ir.OpGraph,
    schedule: Schedule,
    host_graph: HostGraph,
    compute_dtype: Optional[torch.dtype] = None,
    *,
    device="cpu",
    build_transpose: bool = False,
    tile_cache: Optional[Dict] = None,
) -> Callable[[Dict[str, torch.Tensor], GraphTensor, torch.Tensor],
              torch.Tensor]:
    """Lower ``graph`` under ``schedule`` to ``apply(params, g, x)``.

    Host side, once: builds the tilings and hybrid splits the matched
    blocks need, on ``device``.  ``tile_cache`` shares them across the
    layers of a model.  ``build_transpose`` also splits the TRANSPOSED
    graph (kept in ``tile_cache["transpose"]``) for every hybrid block, so
    its gradient runs the kernels (dx = Aᵀ ȳ, and the attention backward
    K5-K8) instead of autograd of the full-graph formulation; it doubles
    the set-up and the split's device memory.  The backward of the
    non-hybrid ``spmm`` and ``gat`` kinds and the sparse-input first layer
    are not ported yet: taking a gradient through those kinds raises."""
    cache = tile_cache if tile_cache is not None else {}
    tiled: Dict[tuple, TiledGraph] = cache.setdefault("tiled", {})
    hybrids: Dict[tuple, object] = cache.setdefault("hybrids", {})
    host_graph_t = None
    if build_transpose:
        if "transpose" not in cache:
            cache["transpose"] = transpose_host_graph(host_graph)
        host_graph_t = cache["transpose"][0]

    def get_tiled(tc: TileConfig, unit_weight: bool) -> TiledGraph:
        key = (id(host_graph), str(device), tc.block_rows, tc.block_cols,
               tc.tile_edges, unit_weight)
        if key not in tiled:
            tiled[key] = tile_graph(
                host_graph, block_rows=tc.block_rows,
                block_cols=tc.block_cols, tile_edges=tc.tile_edges,
                unit_weight=unit_weight, device=device)
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
        elif kind == "spmm":
            data = get_tiled(tc, not plan.weighted)
        elif kind == "gat":
            data = get_tiled(tc, unit_weight=True)
        else:
            data = None
        plans.append((kind, block, tc, plan, data, twin))

    outputs = list(graph.outputs)
    inv_deg = None
    if any(p[0] in ("spmm", "spmm_hybrid") and p[3].mean for p in plans):
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

        def w_asrc_of(plan):
            # canonical GAT wiring (a_src = MM(h)): pass the weight so the
            # tail kernel derives a_s from the rows it gathers
            prod = graph.by_id.get(plan.asrc_op)
            if (prod is not None and prod.compute == ir.MM
                    and prod.inputs == [plan.h_op]):
                return params[prod.extra["weight"][0]]
            return None

        for kind, block, tc, plan, data, twin in plans:
            if kind in ("spmm", "gat") and _needs_grad(plan, ref, w_asrc_of):
                raise NotImplementedError(
                    f"block {block} lowers to {kind!r}, whose backward the "
                    "port does not run yet (ROADMAP.md Queue 1 items 4-5): "
                    "use the hybrid path to train")
            if kind == "spmm":
                vals[plan.out_op] = seg_out(
                    plan, spmm_mod.spmm(data, kin(ref(plan.in_op))))
            elif kind == "spmm_hybrid":
                vals[plan.out_op] = seg_out(plan, dense_mod.spmm_hybrid(
                    data, g, kin(ref(plan.in_op)), weighted=plan.weighted,
                    hyb_t=twin))
            elif kind in ("gat", "gat_hybrid"):
                w_as = w_asrc_of(plan)
                kw = dict(negative_slope=plan.negative_slope,
                          w_asrc=None if w_as is None else kin(w_as))
                a_src = None if w_as is not None else kin(ref(plan.asrc_op))
                if kind == "gat":
                    vals[plan.out_op] = gat_mod.gat_attention(
                        data, kin(ref(plan.h_op)), a_src,
                        kin(ref(plan.adst_op)), heads=plan.heads, **kw)
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
    # and kernel checks
    apply.plans = [(p[0], p[1], p[4], p[5]) for p in plans]
    return apply
