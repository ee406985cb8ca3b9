"""Analytic latency model for the compile-only schedule pick.

Counterpart of the JAX package's ``compiler/latency.py``: a closed-form
latency estimate per schedule, so that ``min_latency_schedule`` picks a
fusion and tile schedule for a model and a graph without running any
candidate (the role of the reference's cycle simulator).  It sums, block
by block, what the lowering runs (dispatch through
``fusion.classify_block``):

  * per-op blocks (``xla``): the port's per-op path (``compiler/lower.py``,
    ``ops/primitives.py``): ``index_select`` for scatter, ``index_add_``
    for gather, elementwise ops over the bytes they move, and ``dense_mm``
    for X W;
  * kernel blocks: the edge-tile model (``graph.tile_time_model_ns``) for
    K1, K3, K11, K13 and K14, dense blocks (K2, K4) by bytes and products
    plus a per-block constant, the grouped tail (K9, K10) by chunks, live
    sub-tiles and edges, the stream path by rows and chunks, the densefull
    path by one product.

One code path serves two sets of constants.  The default
:class:`LatencyConstants` is the fit on the card
(``compiler/latency_fit.py``).  The field names are the JAX package's
(``xla_*`` keeps its name, and prices the port's per-op path); the fields
it lacks give the card's forms a switch that is off with the JAX
package's values (a per-edge and per-byte cost where the TPU's priced
slots and 128-lane groups, a dense-block rate apart from the per-op
product's, a GAT factor per part).  With the JAX package's constants the
port's model returns the JAX model's numbers.

Like the JAX model it prices the forward only, and the candidate pool
always holds the all-per-op schedule, so the pick never models itself
into a regression against the per-op path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import ir
from . import schedule as S


@dataclasses.dataclass(frozen=True)
class LatencyConstants:
    """Primitive costs, in ns, GB/s and TFLOP/s.  The defaults are the fit
    of ``compiler/latency_fit.py`` on one NVIDIA H100 80GB HBM3 at
    700.00 W (nvidia-smi), 2026-10-18, bf16 requests on the smoke's graph
    (``PERF.md``, PR 15, lists each point's residual).  Refit when a kernel
    or the torch version changes; ``chip_smoke.py`` phase 11's rank check
    guards the ranking on the card.  A field at 0 or inf switches off a
    term of the JAX package's form that the card's fit does not use."""

    # elementwise bytes (apply_edge / apply_node) and per-op X W
    hbm_gbps: float = 3599.0
    mxu_tflops_bf16: float = 23.9       # dense_mm: fitted to f32 products, not K16
    mxu_tflops_f32: float = 23.9
    # dense blocks (K2, K4), in-kernel projections (K14), densefull
    dense_tflops_bf16: float = 363.2
    dense_tflops_f32: float = 51.19
    # per-op row ops: ns per edge row per group of ``xla_lane_width``
    # features, plus ns per row byte, times the residency factor past
    # ``xla_resident_bytes`` of node table (the card's L2); a per-op
    # constant.  ``xla_value_bytes`` (0: the schedule's dtype) is the width
    # of the per-op path's values: it keeps them in float32 at every
    # compute dtype
    xla_take_row_ns: float = 0.004152
    xla_segment_row_ns: float = 0.02681
    xla_take_byte_ns: float = 0.0005372
    xla_segment_byte_ns: float = 0.0006878
    xla_lane_width: int = 8
    xla_value_bytes: int = 4
    xla_op_const_ns: float = 25840.0
    xla_resident_bytes: int = 50 << 20
    xla_nonresident_factor: float = 1.536
    # the edge-tile model (graph.tile_time_model_ns and grid_ramp_ns); on
    # the card tiles walk their edge prefix: no panel, no slot cost
    tile_panel_gbps: float = math.inf
    tile_grid_const_ns: float = 0.7346
    tile_slot_ns: float = 0.0
    tile_surcharge_ns: float = 0.0
    tile_edge_ns: float = 0.07743
    tile_edge_byte_ns: float = 8.417e-05
    ramp_run_ns: float = 0.0
    ramp_tile_ns: float = 0.0
    kernel_call_ns: float = 0.0
    # per dense block beyond bytes and products
    dense_block_const_ns: float = 64.98
    # GAT chain: K3 over K1 on one tiling, K4 over K2's blocks plus a cost
    # per dense cell and head; K14 over K3's chain
    gat_pass_factor: float = 2.319
    gat_dense_factor: float = 0.2408
    gat_cell_ns: float = 0.001925
    layer_kernel_factor: float = 0.8491
    # K13 over K1: DGN's sum alone, sets with max (PNA), other sets
    pair_sum_factor: float = 1.305
    pair_max_factor: float = 1.037
    pair_other_factor: float = 1.06
    # stream path: row cost factor over the per-op rows, per-chunk
    # constant; GAT's stream over GCN's, and its own per-chunk cost (its
    # two passes run many more ops a chunk)
    stream_row_factor: float = 1.629
    stream_chunk_ns: float = 30720.0
    gat_stream_factor: float = 0.9804
    gat_stream_chunk_ns: float = 418800.0
    # grouped tail: per chunk (+ weighted), its one-hot product rate (inf:
    # none), per live sub-tile; its edges at the tile model's edge terms
    grouped_chunk_ns: float = 0.0
    grouped_weighted_ns: float = 0.0
    grouped_tflops_bf16: float = math.inf
    grouped_tflops_f32: float = math.inf
    grouped_sub_ns: float = 0.1543

    def tile_model(self) -> dict:
        """The keywords of ``graph.tile_time_model_ns``."""
        return dict(grid_const_ns=self.tile_grid_const_ns,
                    slot_ns=self.tile_slot_ns,
                    panel_gbps=self.tile_panel_gbps,
                    surcharge_ns=self.tile_surcharge_ns,
                    edge_ns=self.tile_edge_ns,
                    edge_byte_ns=self.tile_edge_byte_ns,
                    ramp_run_ns=self.ramp_run_ns,
                    ramp_tile_ns=self.ramp_tile_ns,
                    call_ns=self.kernel_call_ns)


DEFAULT = LatencyConstants()


# ---------------------------------------------------------------------------
# per-op cost
# ---------------------------------------------------------------------------


def _lane_groups(width: int, lane: int) -> int:
    return max(-(-max(width, 1) // lane), 1)


def _row_factor(stats: S.GraphStats, width: int, value_bytes: int,
                c: LatencyConstants) -> float:
    """The residency cliff: rows gathered from or added into a node table
    larger than ``xla_resident_bytes`` cost ``xla_nonresident_factor``
    times more."""
    table = stats.n_node * max(width, 1) * value_bytes
    return c.xla_nonresident_factor if table > c.xla_resident_bytes else 1.0


def _row_ns(row_ns: float, byte_ns: float, width: int, value_bytes: int,
            c: LatencyConstants) -> float:
    """One edge row of a per-op row op: per lane group and per byte."""
    return (row_ns * _lane_groups(width, c.xla_lane_width)
            + byte_ns * max(width, 1) * value_bytes)


def _value_bytes(dtype_bytes: int, c: LatencyConstants) -> int:
    return c.xla_value_bytes or dtype_bytes


def _mm_tflops(dtype_bytes: int, c: LatencyConstants) -> float:
    return c.mxu_tflops_bf16 if dtype_bytes <= 2 else c.mxu_tflops_f32


def _dense_tflops(dtype_bytes: int, c: LatencyConstants) -> float:
    return c.dense_tflops_bf16 if dtype_bytes <= 2 else c.dense_tflops_f32


def xla_op_ns(
    op: ir.Op,
    graph: ir.OpGraph,
    stats: S.GraphStats,
    dtype_bytes: int = 2,
    c: LatencyConstants = DEFAULT,
) -> float:
    """Modelled latency of one op on the per-op path."""
    n, e = stats.n_node, stats.e_pad
    w = max(op.out_width, 1)
    vb = _value_bytes(dtype_bytes, c)
    if op.kind == ir.SCATTER:
        t = (e * _row_ns(c.xla_take_row_ns, c.xla_take_byte_ns, w, vb, c)
             * _row_factor(stats, w, vb, c))
        return t + c.xla_op_const_ns
    if op.kind == ir.GATHER:
        t = (e * _row_ns(c.xla_segment_row_ns, c.xla_segment_byte_ns, w, vb,
                         c)
             * _row_factor(stats, w, vb, c))
        return t + c.xla_op_const_ns
    if op.kind == ir.APPLY_EDGE:
        reads = max(len(op.inputs), 1)
        byts = (reads + 1) * e * w * vb
        return byts / c.hbm_gbps + c.xla_op_const_ns
    # apply_node
    wt = op.extra.get("weight")
    if op.compute == ir.MM and wt is not None:
        _, iw, ow = wt
        flops = 2.0 * n * iw * ow
        byts = (n * iw + n * ow + iw * ow) * vb
        return (max(flops / (_mm_tflops(dtype_bytes, c) * 1e3),
                    byts / c.hbm_gbps) + c.xla_op_const_ns)
    reads = max(len(op.inputs), 1)
    byts = (reads + 1) * n * w * vb
    return byts / c.hbm_gbps + c.xla_op_const_ns


# ---------------------------------------------------------------------------
# kernel block cost
# ---------------------------------------------------------------------------


class GraphCost:
    """Per-graph cost oracle: keeps the run-nnz histograms, dense-block
    counts and hybrid thresholds per geometry (one instance may serve
    every layer and model of a graph), and prices kernel blocks."""

    def __init__(self, host_graph, constants: LatencyConstants = DEFAULT):
        from ..graph import _as_host
        self.g = _as_host(host_graph)
        self.c = constants
        self.stats = S.GraphStats(
            n_node=self.g.n_node,
            n_edge=self.g.n_edge,
            e_pad=self.g.e_pad,
        )
        self._memo: Dict[tuple, object] = {}

    def _cached(self, key: tuple, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def _hist(self, br: int, bc: int) -> np.ndarray:
        from ..graph import run_nnz_hist
        return self._cached(("hist", br, bc),
                            lambda: run_nnz_hist(self.g, br, bc))

    def _block_nnz(self, br: int, bc: int) -> np.ndarray:
        from ..graph import block_nnz
        return self._cached(("bnnz", br, bc),
                            lambda: block_nnz(self.g, br, bc))

    def threshold(self, kind: str, rows: int, cols: int, heads: int = 1,
                  head_dim: int = 128) -> int:
        """``ops.dense.hybrid_threshold`` at one dense geometry, once."""
        from ..ops import dense as dense_mod
        return self._cached(
            ("thr", kind, rows, cols, heads, head_dim),
            lambda: dense_mod.hybrid_threshold(
                self.g, kind, heads=heads, head_dim=head_dim,
                dense_rows=rows, dense_cols=cols))

    def onehot_ns(self, tc: S.TileConfig, feat_width: int,
                  dtype_bytes: int = 2, include_ramp: bool = True) -> float:
        from ..graph import tile_time_model_ns
        hist = self._hist(tc.block_rows, tc.block_cols)
        if len(hist) == 0:
            return 0.0
        return tile_time_model_ns(
            hist, tc.tile_edges, tc.block_rows, tc.block_cols,
            feat_width=max(feat_width, 1), x_bytes=dtype_bytes,
            include_ramp=include_ramp, **self.c.tile_model())

    def ramp_ns(self, tc: S.TileConfig, feat_width: int = 128,
                dense_threshold: int = 0) -> float:
        """The short-grid ramp and launch (``graph.grid_ramp_ns``), a
        per-call cost: chains of passes (GAT, pair aggregation) add it
        once, unscaled.  ``dense_threshold`` restricts it to the runs a
        hybrid split leaves in the tail."""
        from ..graph import grid_ramp_ns
        if dense_threshold > 0:
            hist = self._tail_hist(tc.block_rows, tc.block_cols,
                                   tc.dense_block or tc.block_rows,
                                   tc.dense_block or tc.block_cols,
                                   dense_threshold)
        else:
            hist = self._hist(tc.block_rows, tc.block_cols)
        if len(hist) == 0:
            return 0.0
        tiles = float(np.ceil(hist / tc.tile_edges).sum())
        return grid_ramp_ns(len(hist), tiles, feat_width,
                            run_ns=self.c.ramp_run_ns,
                            tile_ns=self.c.ramp_tile_ns,
                            call_ns=self.c.kernel_call_ns)

    def _tail_hist(self, br: int, bc: int, drows: int, dcols: int,
                   thr: int) -> np.ndarray:
        """Run-nnz histogram at the tail geometry (br, bc) over exactly the
        edges the hybrid split (dense grid (drows, dcols), threshold
        ``thr``) leaves to the tail."""
        def build():
            hg = self.g
            ne = hg.n_edge
            if ne == 0:
                return np.zeros(0, np.int64)
            bn = self._block_nnz(drows, dcols)
            ncb_d = bn.shape[1]
            s = hg.senders[:ne]
            r = hg.receivers[:ne]
            keyd = (r // drows).astype(np.int64) * ncb_d + s // dcols
            tail = bn.reshape(-1)[keyd] < thr
            ncb = max(-(-hg.n_node // bc), 1)
            key = ((r[tail] // br).astype(np.int64) * ncb + s[tail] // bc)
            cnt = np.bincount(key)
            return cnt[cnt > 0]
        return self._cached(("tail", br, bc, drows, dcols, thr), build)

    def _dense_count(self, drows: int, dcols: int, thr: int):
        """(n_dense_blocks, n_dense_edges) of the hybrid split."""
        def build():
            bn = self._block_nnz(drows, dcols).reshape(-1)
            m = bn >= thr
            return int(m.sum()), int(bn[m].sum())
        return self._cached(("dense", drows, dcols, thr), build)

    def _hybrid_parts(self, tc: S.TileConfig, feat_width: int,
                      dense_threshold: int, dtype_bytes: int,
                      include_ramp: bool,
                      dense_value_bytes: int) -> Tuple[float, float]:
        """(dense blocks, tail) of a hybrid split."""
        from ..graph import tile_time_model_ns
        drows = tc.dense_block or tc.block_rows
        dcols = tc.dense_block or tc.block_cols
        c = self.c
        f = max(feat_width, 1)
        nb, _ = self._dense_count(drows, dcols, dense_threshold)
        # per dense block: the count block and x panel bytes against the
        # product, plus a fixed cost per block
        per_block = max((drows * dcols * dense_value_bytes
                         + dcols * f * dtype_bytes) / c.hbm_gbps,
                        2.0 * drows * dcols * f
                        / (_dense_tflops(dtype_bytes, c) * 1e3))
        dense = nb * (per_block + c.dense_block_const_ns)
        tail = self._tail_hist(tc.block_rows, tc.block_cols,
                               drows, dcols, dense_threshold)
        t_tail = 0.0
        if len(tail):
            t_tail = tile_time_model_ns(
                tail, tc.tile_edges, tc.block_rows, tc.block_cols,
                feat_width=f, x_bytes=dtype_bytes,
                include_ramp=include_ramp, **c.tile_model())
        return dense, t_tail

    def hybrid_ns(self, tc: S.TileConfig, feat_width: int,
                  dense_threshold: int, dtype_bytes: int = 2,
                  include_ramp: bool = True,
                  dense_value_bytes: int = 1) -> float:
        dense, tail = self._hybrid_parts(tc, feat_width, dense_threshold,
                                         dtype_bytes, include_ramp,
                                         dense_value_bytes)
        return dense + tail

    def _grouped_chunks(self, br: int, bc: int, et: int, g: int) -> int:
        """Chunk count of the grouped tiler at this geometry: per
        (stripe group, column block), the deepest run of its row blocks in
        tiles of ``et``."""
        def build():
            hg = self.g
            ne = hg.n_edge
            if ne == 0:
                return 1
            r = hg.receivers[:ne]
            s = hg.senders[:ne]
            ncb = max(-(-hg.n_node // bc), 1)
            rb = (r // br).astype(np.int64)
            cb = (s // bc).astype(np.int64)
            key = (rb // g) * ncb * g + cb * g + rb % g
            cnt = np.bincount(key)
            cnt = cnt[cnt > 0]
            levels = -(-cnt // et)
            uniq = np.unique(key)
            gc = uniq // g
            order = np.argsort(gc, kind="stable")
            gc_s, lv_s = gc[order], levels[order]
            starts = np.flatnonzero(np.concatenate([[True],
                                                    gc_s[1:] != gc_s[:-1]]))
            return int(np.maximum.reduceat(lv_s, starts).sum())
        return self._cached(("chunks", br, bc, et, g), build)

    def grouped_ns(self, tc: S.TileConfig, feat_width: int,
                   dtype_bytes: int = 2, weighted: bool = True) -> float:
        """The grouped tail: per chunk its one-hot product against its
        panel (the TPU's form; none on the card) and a constant, per live
        sub-tile (K9's work list: a sub-tile whose row block has an edge at
        that depth) and per live edge."""
        g = S.GROUPED_G
        nc = self._grouped_chunks(tc.block_rows, tc.block_cols,
                                  tc.tile_edges, g)
        c = self.c
        f = max(feat_width, 1)
        tf = (c.grouped_tflops_bf16 if dtype_bytes <= 2
              else c.grouped_tflops_f32)
        compute = (2.0 * g * tc.tile_edges
                   * (tc.block_rows + tc.block_cols) * f / (tf * 1e3))
        panel = tc.block_cols * f * dtype_bytes / c.tile_panel_gbps
        per = max(compute, panel) + c.grouped_chunk_ns
        if weighted:
            per += c.grouped_weighted_ns
        hist = self._hist(tc.block_rows, tc.block_cols)
        live = float(np.ceil(hist / tc.tile_edges).sum())
        return (nc * per + live * c.grouped_sub_ns
                + float(hist.sum()) * (c.tile_edge_ns
                                       + c.tile_edge_byte_ns * f
                                       * dtype_bytes)
                + c.kernel_call_ns)

    def stream_chunks(self, tc: S.TileConfig) -> int:
        """The stream path's chunks of ``tile_edges * 2048`` edges."""
        return max(-(-self.stats.e_pad // (tc.tile_edges * 2048)), 1)

    def stream_ns(self, tc: S.TileConfig, feat_width: int,
                  dtype_bytes: int = 2) -> float:
        """The edge-chunk loop (``ops/chunked.py``): the per-op path's row
        gather and add, times ``stream_row_factor``, plus a constant per
        chunk of ``tile_edges * 2048`` edges."""
        c = self.c
        chunks = self.stream_chunks(tc)
        vb = _value_bytes(dtype_bytes, c)
        f = max(feat_width, 1)
        per_edge = c.stream_row_factor * (
            _row_ns(c.xla_take_row_ns, c.xla_take_byte_ns, f, vb, c)
            + _row_ns(c.xla_segment_row_ns, c.xla_segment_byte_ns, f, vb, c))
        per_edge *= _row_factor(self.stats, feat_width, vb, c)
        return per_edge * self.stats.e_pad + chunks * c.stream_chunk_ns


def _weight_mm_ns(graph: ir.OpGraph, block: Sequence[int], n: int,
                  dtype_bytes: int, tflops: float, c: LatencyConstants,
                  with_bytes: bool) -> float:
    """The MM ops with a weight inside a kernel block, at ``tflops``."""
    t = 0.0
    for o in block:
        op = graph.by_id[o]
        if op.compute == ir.MM and op.extra.get("weight"):
            _, iw, ow = op.extra["weight"]
            flops = 2.0 * n * iw * ow / (tflops * 1e3)
            if with_bytes:
                byts = (n * (iw + ow) + iw * ow) * dtype_bytes
                t += max(flops, byts / c.hbm_gbps)
            else:
                t += flops
    return t


def block_ns(
    graph: ir.OpGraph,
    block: Sequence[int],
    tc: S.TileConfig,
    cost: GraphCost,
    dtype_bytes: int = 2,
) -> float:
    """Modelled latency of one block under its TileConfig.  Dispatch is the
    lowering's (``fusion.classify_block``), so the model prices what runs:
    a block the lowering runs op by op is priced op by op."""
    from ..graph import DENSEFULL_MAX_N
    from .fusion import classify_block
    c = cost.c

    def per_op() -> float:
        return sum(xla_op_ns(graph.by_id[o], graph, cost.stats,
                             dtype_bytes, c) for o in block)

    kind, plan = classify_block(graph, block, tc)
    drows = tc.dense_block or tc.block_rows
    dcols = tc.dense_block or tc.block_cols

    if kind == "xla":
        return per_op()
    if kind == "spmm":
        return cost.onehot_ns(tc, graph.width_of(plan.in_op), dtype_bytes)
    if kind == "spmm_grouped":
        return cost.grouped_ns(tc, graph.width_of(plan.in_op), dtype_bytes,
                               weighted=plan.weighted)
    if kind == "spmm_hybrid":
        thr = cost.threshold("spmm", drows, dcols)
        return cost.hybrid_ns(tc, graph.width_of(plan.in_op), thr,
                              dtype_bytes)
    if kind == "spmm_densefull":
        if cost.stats.n_node > DENSEFULL_MAX_N:
            return per_op()         # the lowering runs it op by op too
        n_pad = -(-cost.stats.n_node // 256) * 256
        f = max(graph.width_of(plan.in_op), 1)
        byts = (n_pad * n_pad * 2.0            # A bf16, read once
                + 2.0 * n_pad * f * dtype_bytes)
        flops = 2.0 * n_pad * n_pad * f
        return (max(byts / c.hbm_gbps,
                    flops / (_dense_tflops(dtype_bytes, c) * 1e3))
                + c.xla_op_const_ns)
    if kind == "spmm_stream":
        return cost.stream_ns(tc, graph.width_of(plan.in_op), dtype_bytes)
    if kind == "sddmm":
        fw = graph.width_of(plan.src_op)
        return cost.onehot_ns(tc, max(2 * fw, 8), dtype_bytes)
    if kind == "pair_agg":
        # K13 as a factor on the one-hot unit, per aggregator set; the
        # ramp once, unscaled; the MMs the matcher moves into the operands
        # as per-op products without their constant
        aggs = set(plan.gathers)
        pf = (c.pair_sum_factor if aggs == {ir.ADD} else
              (c.pair_max_factor if ir.MAX in aggs else c.pair_other_factor))
        t = (pf * cost.onehot_ns(tc, plan.width, dtype_bytes,
                                 include_ramp=False)
             + cost.ramp_ns(tc, plan.width))
        return t + _weight_mm_ns(graph, block, cost.stats.n_node,
                                 dtype_bytes, _mm_tflops(dtype_bytes, c), c,
                                 with_bytes=True)

    # GAT chain variants
    if kind == "gat_layer":
        mm = next(graph.by_id[o] for o in block
                  if graph.by_id[o].compute == ir.MM
                  and graph.by_id[o].extra.get("weight")
                  and graph.by_id[o].extra["weight"][0] == plan.w_name)
        hd = mm.out_width
        base = (c.layer_kernel_factor * c.gat_pass_factor
                * cost.onehot_ns(tc, hd, dtype_bytes, include_ramp=False)
                + cost.ramp_ns(tc, hd))
        return base + _weight_mm_ns(graph, block, cost.stats.n_node,
                                    dtype_bytes,
                                    _dense_tflops(dtype_bytes, c), c,
                                    with_bytes=False)
    hd = graph.width_of(plan.h_op)
    if kind == "gat_hybrid":
        thr = cost.threshold("gat", drows, dcols, heads=plan.heads,
                             head_dim=hd // max(plan.heads, 1))
        dense, tail = cost._hybrid_parts(tc, hd, thr, dtype_bytes,
                                         False, 1)
        nb, _ = cost._dense_count(drows, dcols, thr)
        return (c.gat_dense_factor * dense
                + c.gat_cell_ns * nb * drows * dcols * plan.heads
                + c.gat_pass_factor * tail
                + cost.ramp_ns(tc, hd, dense_threshold=thr))
    if kind == "gat_stream":
        return (c.gat_stream_factor * cost.stream_ns(tc, hd, dtype_bytes)
                + c.gat_stream_chunk_ns * cost.stream_chunks(tc))
    return (c.gat_pass_factor
            * cost.onehot_ns(tc, hd, dtype_bytes, include_ramp=False)
            + cost.ramp_ns(tc, hd))


def schedule_ns(
    graph: ir.OpGraph,
    sched: S.Schedule,
    cost: GraphCost,
    dtype_bytes: int = 2,
) -> float:
    """Modelled latency of a schedule: the sum over its blocks, which run
    one after another."""
    return sum(block_ns(graph, b, tc, cost, dtype_bytes)
               for b, tc in zip(sched.blocks, sched.tiles))


def spearman_rank(a: Sequence[float], b: Sequence[float]) -> float:
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    d = (ra * ra).sum() ** 0.5 * (rb * rb).sum() ** 0.5
    return float((ra * rb).sum() / d) if d else 0.0


def rank_stats(measured: Sequence[float],
               modelled: Sequence[float]) -> dict:
    """Spearman's rho between measured and modelled times, and the argmin
    regret: the measured time of the modelled pick over the fastest
    measured."""
    pick = int(np.argmin(modelled))
    return {"spearman": spearman_rank(measured, modelled),
            "argmin_regret": float(measured[pick]) / float(min(measured))}


def rank_check(memo_csv: str, graph_name: str, graph: ir.OpGraph,
               host_graph, dtype_bytes: int = 2,
               version: Optional[int] = None,
               constants: LatencyConstants = DEFAULT) -> Optional[dict]:
    """The model's ranking against the measured latencies of the port's
    own tuner memo (``tune.search.default_memo_path``, under
    ``build/tune/``), rows of the current ``KERNEL_VERSION`` only.
    Returns {rows: [(measured us, modelled us, key)], spearman,
    argmin_regret}, or None when the memo has no row for
    ``graph_name``."""
    import csv
    import os

    if version is None:
        from .fusion import KERNEL_VERSION
        version = KERNEL_VERSION
    prefix = f"v{version}|"
    if not os.path.exists(memo_csv):
        return None
    cost = GraphCost(host_graph, constants)
    rows = []
    with open(memo_csv) as f:
        for rec in csv.reader(f):
            if len(rec) != 2 or not rec[0].startswith(prefix):
                continue
            _, name, key = rec[0].split("|", 2)
            if name != graph_name:
                continue
            sched = S.Schedule.from_key(key)
            modelled = schedule_ns(graph, sched, cost, dtype_bytes) / 1e3
            rows.append((float(rec[1]) * 1e6, modelled, key))
    if not rows:
        return None
    rows.sort()
    out = rank_stats([r[0] for r in rows], [r[1] for r in rows])
    out["rows"] = rows
    return out


def priced_candidates(
    graph: ir.OpGraph,
    host_graph,
    *,
    tile_palette: Optional[Sequence[S.TileConfig]] = None,
    max_partitions: int = 64,
    dtype_bytes: int = 2,
    constants: LatencyConstants = DEFAULT,
    cost: Optional[GraphCost] = None,
) -> List[Tuple[S.Schedule, float]]:
    """(schedule, modelled ns) of every candidate of the tuner's pool
    (``tune.search._candidate_schedules``, the all-per-op schedule
    included) that the port's kernels run (``tune.search.
    schedule_is_feasible``, the shared-memory rule).  ``cost`` shares one
    :class:`GraphCost` of ``host_graph`` across calls (its constants are
    then the cost's)."""
    from ..tune.search import _candidate_schedules, schedule_is_feasible
    if tile_palette is None:
        from ..hwconfig import load_hw_config
        tile_palette = load_hw_config().palette()
    if cost is None:
        cost = GraphCost(host_graph, constants)
    return [(cand, schedule_ns(graph, cand, cost, dtype_bytes))
            for cand in _candidate_schedules(graph, max_partitions,
                                             tile_palette)
            if schedule_is_feasible(graph, cand, dtype_bytes)]


def min_latency_schedule(graph: ir.OpGraph, host_graph,
                         **kw) -> Tuple[S.Schedule, float]:
    """Compile-only pick: the argmin of the modelled latency over
    :func:`priced_candidates` (same keywords; ties: the first), as
    (schedule, modelled ns)."""
    return min(priced_candidates(graph, host_graph, **kw),
               key=lambda p: p[1])
