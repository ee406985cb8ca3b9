"""Fit the latency model's constants (``compiler/latency.LatencyConstants``)
on the card.

Counterpart of the JAX package's ``scripts/latency_fit.py``.  It measures,
with CUDA events:

1. the per-op path's row ops (``ops/primitives``: ``index_select`` for a
   scatter, ``index_add_`` for a gather, on float32 rows as the per-op path
   keeps them) at E in {16,384; 131,072; 1,048,576} x F in {128, 256}, N =
   8,192, as JAX does, plus the narrow rows of attention logits and the
   last layer (F in {1, 4, 41} at E in {1,048,576; 4,194,304}), two points
   past the L2 (N = 232,965) for the residency cliff, and one elementwise
   op for the byte rate;
2. the per-op X W (``primitives.dense_mm`` with bf16 operands: K16) and
   ``torch.mm`` in bf16 and float32 (the dense-block and densefull rate);
3. on the smoke's graph (``chip_smoke.py``'s generator, self loops,
   symmetric norm, the ``hubs+labels`` reorder), every candidate of the
   tuner's pool (``tune/search._candidate_schedules``, the shared-memory
   rule) for each layer of GCN-2l, GAT-2l (4 heads, 1 in the last
   layer), DGN-2l and PNA-2l at 602 / 128 / 41 features, each lowered once
   and timed whole (``utils/benchmark.time_layer_device``, bf16; DGN's and
   PNA's per-op layers do not fit the card at this size and are left
   out), and the kernels K1, K2, K3, K4, K9, K13 and K14 alone on those
   candidates' tilings and splits.

Then it fits (non-negative least squares of relative residuals, or
medians of ratios) the per-op terms from (1)-(2), K1's tile terms from
K1 alone, and every block-level term (the per-block launch and glue, the
dense-block constant, the GAT, whole-layer, pair and stream terms, the
grouped sub-tile cost) from the candidates' times less the modelled
per-op blocks around them, so that they price what a schedule pays (the
kernels' glue included; K2 alone is printed beside its block term),
prints each constant, each point's residual, and per layer the measured
against the modelled time of every candidate with Spearman's rho and the
argmin regret, and writes it all as JSON (``--out``).  Paste the printed
``LatencyConstants(...)`` as the defaults.

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.latency_fit \\
        [--edges 11461589] [--out build/latency_fit.json]

A CPU run (``--device cpu``, tiny sizes) rehearses the control flow with
host times; its numbers are not the card's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from .. import ir
from . import schedule as S
from .latency import (GraphCost, LatencyConstants, _row_factor, _row_ns,
                      rank_stats, xla_op_ns)

N_NODE, N_EDGE = 232_965, 11_461_589     # the smoke's graph
F_IN, HIDDEN, N_CLASS, HEADS = 602, 128, 41, 4
ROW_N = 8192
ROW_E = (16_384, 131_072, 1_048_576)
ROW_F = (128, 256)
# narrower rows, as the per-op path's attention logits and last layer
NARROW = tuple((e, f) for e in (1_048_576, 4_194_304) for f in (1, 4, 41))
CLIFF_E = (1_048_576, 4_194_304)
LANES = (8, 16, 32, 64, 128, 1 << 20)
TARGET_S = 0.03
DTYPE_BYTES = 2                           # the fit prices bf16 requests


def say(msg: str) -> None:
    print(msg, flush=True)


def _ms(fn: Callable[[], object], dev: torch.device) -> float:
    """Milliseconds of one call: CUDA events over 5 calls in a row, median
    of 5, on the card; the host clock on the CPU (a rehearsal)."""
    if dev.type == "cuda":
        from ..utils.benchmark import median_ms
        return median_ms(fn, device=dev, warmup=2, repeats=5, calls=5)
    fn()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# 1-2: per-op rows and products
# ---------------------------------------------------------------------------


def primitive_points(dev, scale: float) -> dict:
    from ..graph import build_graph
    from ..ops import primitives as P
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    rows = []
    pts = [(ROW_N, e, f, False) for e in ROW_E for f in ROW_F]
    pts += [(ROW_N, e, f, False) for e, f in NARROW]
    pts += [(N_NODE, e, 128, True) for e in CLIFF_E]
    for n, e, f, cliff in pts:
        n, e = max(int(n * scale), 64), max(int(e * scale), 256)
        s = rng.integers(0, n, e)
        r = np.sort(rng.integers(0, n, e))
        g = build_graph(s, r, n, device=dev)
        x = torch.randn((n, f), generator=gen, device=dev)
        ev = torch.randn((g.e_pad, f), generator=gen, device=dev)
        take = _ms(lambda: P.scatter_to_edges(x, g, "C"), dev)
        seg = _ms(lambda: P.gather_to_nodes(ev, g), dev)
        rows.append(dict(n=n, e_pad=g.e_pad, f=f, cliff=cliff, take_ms=take,
                         seg_ms=seg))
        say(f"  rows N={n} E={g.e_pad} F={f}: index_select {take:.4f} ms, "
            f"index_add_ {seg:.4f} ms")
        del g, x, ev
    e = max(int(4_194_304 * scale), 256)
    a = torch.randn((e, 128), generator=gen, device=dev)
    w = torch.randn((e, 1), generator=gen, device=dev)
    ew = _ms(lambda: P.binary_op(ir.MUL, a, w), dev)
    say(f"  elementwise [{e}, 128] x [{e}, 1] float32: {ew:.4f} ms")
    n = max(int(N_NODE * scale), 64)
    mm = {}
    for iw, ow in ((F_IN, HIDDEN), (HIDDEN, N_CLASS)):
        xx = torch.randn((n, iw), generator=gen, device=dev)
        ww = torch.randn((iw, ow), generator=gen, device=dev)
        mm[f"{iw}x{ow}"] = _ms(
            lambda: P.dense_mm(xx, ww, torch.bfloat16), dev)
        say(f"  dense_mm [{n}, {iw}] @ [{iw}, {ow}] (bf16 operands): "
            f"{mm[f'{iw}x{ow}']:.4f} ms")
    k = max(int(16_384 * scale), 256)
    tmm = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        aa = torch.randn((k, k), generator=gen, device=dev).to(dt)
        bb = torch.randn((k, 128), generator=gen, device=dev).to(dt)
        tmm[name] = _ms(lambda: torch.mm(aa, bb), dev)
        say(f"  torch.mm [{k}, {k}] @ [{k}, 128] {name}: {tmm[name]:.4f} ms")
    del a, w
    return dict(rows=rows, elementwise=dict(e=e, f=128, ms=ew),
                dense_mm=dict(n=n, ms=mm), torch_mm=dict(k=k, ms=tmm))


def _nnls_rel(a, b) -> np.ndarray:
    """Non-negative least squares of the relative residuals."""
    from scipy.optimize import nnls
    w = 1.0 / np.asarray(b, float)
    return nnls(np.asarray(a, float) * w[:, None], np.asarray(b) * w)[0]


def fit_primitives(pts: dict, l2_bytes: int) -> dict:
    """The per-op terms: take and segment rows (per group of
    ``xla_lane_width`` features and per byte, one shared constant) from the
    N = 8,192 points, the lane width the one of least residual; the cliff
    factor from the large-N points; the byte rate; the product rates."""
    small = [r for r in pts["rows"] if not r["cliff"]]
    big = [r for r in pts["rows"] if r["cliff"]]
    best = None
    for lane in LANES:
        a, b = [], []
        for r in small:
            e, f = r["e_pad"], r["f"]
            grp = e * -(-f // lane)
            a.append([1.0, grp, e * f * 4, 0.0, 0.0])
            b.append(r["take_ms"] * 1e6)
            a.append([1.0, 0.0, 0.0, grp, e * f * 4])
            b.append(r["seg_ms"] * 1e6)
        x = _nnls_rel(a, b)
        rel = (np.array(a) @ x - np.array(b)) / np.array(b)
        if best is None or (rel ** 2).mean() < best[0]:
            best = ((rel ** 2).mean(), lane, x)
    _, lane, (const, tr, tb, sr, sb) = best

    def model(e, f):
        g = -(-f // lane)
        return (e * (tr * g + tb * f * 4), e * (sr * g + sb * f * 4))
    ratios = []
    for r in big:
        mt, ms = model(r["e_pad"], r["f"])
        ratios += [(r["take_ms"] * 1e6 - const) / mt,
                   (r["seg_ms"] * 1e6 - const) / ms]
    ew = pts["elementwise"]
    hbm = 3.0 * ew["e"] * ew["f"] * 4 / (ew["ms"] * 1e6)
    n = pts["dense_mm"]["n"]
    t_mm = pts["dense_mm"]["ms"][f"{F_IN}x{HIDDEN}"] * 1e6 - const
    mxu = 2.0 * n * F_IN * HIDDEN / max(t_mm, 1.0) / 1e3
    k = pts["torch_mm"]["k"]
    fl = 2.0 * k * k * 128
    out = dict(xla_op_const_ns=const, xla_take_row_ns=tr,
               xla_take_byte_ns=tb, xla_segment_row_ns=sr,
               xla_segment_byte_ns=sb, xla_lane_width=lane,
               xla_nonresident_factor=max(float(np.median(ratios)), 1.0),
               xla_resident_bytes=int(l2_bytes), hbm_gbps=hbm,
               mxu_tflops_bf16=mxu, mxu_tflops_f32=mxu,
               dense_tflops_bf16=fl / (pts["torch_mm"]["ms"]["bf16"] * 1e9),
               dense_tflops_f32=fl / (pts["torch_mm"]["ms"]["f32"] * 1e9))
    say(f"  lane width {lane} features (least residual of {LANES})")
    for r in pts["rows"]:
        f = out["xla_nonresident_factor"] if r["cliff"] else 1.0
        mt, ms = model(r["e_pad"], r["f"])
        say(f"  residual rows N={r['n']} E={r['e_pad']} F={r['f']}: "
            f"index_select {r['take_ms']:.4f} vs {(const + mt * f) / 1e6:.4f}"
            f" ms, index_add_ {r['seg_ms']:.4f} vs "
            f"{(const + ms * f) / 1e6:.4f} ms")
    say(f"  residual dense_mm 602x128: {pts['dense_mm']['ms']['602x128']:.4f}"
        f" ms (fitted); 128x41: {pts['dense_mm']['ms']['128x41']:.4f} vs "
        f"{(2.0 * n * 128 * 41 / (mxu * 1e3) + const) / 1e6:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# 3: the candidates and kernels on the smoke's graph
# ---------------------------------------------------------------------------


def smoke_graph(edges: int, n_node: int):
    from .. import graph as G
    from ..data.datasets import synthetic_coo
    s, r, labels = synthetic_coo(n_node, edges, seed=1,
                                 communities=max(n_node * 1000 // N_NODE, 1),
                                 p_in=0.7)
    hg = G.build_host_graph(s, r, n_node, add_self_loops=True,
                            symmetric_norm=True)
    hg, _ = G.reorder_nodes(hg, "hubs+labels", labels=labels)
    return hg


def models(dev):
    from ..models.zoo import build_model
    gen = torch.Generator().manual_seed(0)
    kw = dict(hidden=HIDDEN, n_layers=2, generator=gen, device=dev)
    return {
        "GCN-2l": build_model("GCN", F_IN, N_CLASS, reorder=True, **kw),
        "GAT-2l": build_model("GAT", F_IN, N_CLASS, heads=HEADS, **kw),
        "DGN-2l": build_model("DGN", F_IN, N_CLASS, **kw),
        "PNA-2l": build_model("PNA", F_IN, N_CLASS, **kw),
    }


def kernel_kinds(graph: ir.OpGraph, sched: S.Schedule) -> List[str]:
    from .fusion import classify_block
    return [classify_block(graph, b, tc)[0]
            for b, tc in zip(sched.blocks, sched.tiles)]


def _kernel_times(kind: str, data, plan, graph, params, x, dev,
                  seen: set) -> List[dict]:
    """The kernels of one lowered block, alone at the block's widths, once
    per (kernel, structure, width)."""
    from ..ops import dense as D
    from ..ops import gat as A
    from ..ops import pairagg as PA
    from ..ops import spmm as SP
    gen = torch.Generator(device=dev).manual_seed(5)
    n = x.shape[0]
    out = []

    def rnd(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def add(name, key, fn, **geo):
        if key in seen:
            return
        seen.add(key)
        ms = _ms(fn, dev)
        out.append(dict(kernel=name, ms=ms, **geo))
        say(f"    {name} {geo}: {ms:.4f} ms")

    def tile_geo(tg):
        return dict(rows=tg.block_rows, cols=tg.block_cols,
                    et=tg.tile_edges, tiles=tg.n_tiles,
                    edges=int((tg.weight != 0).sum()))

    if kind in ("spmm", "spmm_hybrid"):
        F = graph.width_of(plan.in_op)
        xs = rnd(n, F)
        tg = data if kind == "spmm" else data.tiles
        add("K1", ("K1", id(tg), F),
            lambda: SP.spmm_tiles(tg, xs, tg.weight), f=F, part=kind,
            **tile_geo(tg))
        if kind == "spmm_hybrid" and data.dense is not None:
            bg = data.dense
            xp = D._aligned_rows(xs)
            add("K2", ("K2", id(bg), F),
                lambda: D.spmm_dense_blocks(bg, xp, bg.values), f=F,
                blocks=bg.n_blocks, rows=bg.block_rows)
    elif kind == "spmm_grouped":
        F = graph.width_of(plan.in_op)
        xs = rnd(n, F)
        add("K9", ("K9", id(data), F),
            lambda: SP.spmm_grouped(data, xs, data.weight), f=F,
            rows=data.block_rows, cols=data.block_cols,
            et=data.tile_edges, live=int(data.live_sub.numel()),
            chunks=data.n_chunks)
    elif kind in ("gat", "gat_hybrid"):
        HD, H = graph.width_of(plan.h_op), plan.heads
        h = rnd(n, HD)
        a_s = rnd(n, H, dt=torch.float32)
        a_d = rnd(n, H, dt=torch.float32)
        ms = a_s.amax(dim=0, keepdim=True)
        tg = data if kind == "gat" else data.tiles
        add("K3", ("K3", id(tg), HD),
            lambda: A.gat_tiles(tg, h, tg.weight, a_d, ms, a_src=a_s,
                                normalize=False),
            hd=HD, heads=H, part=kind, **tile_geo(tg))
        if kind == "gat_hybrid" and data.dense is not None:
            bg = data.dense
            add("K4", ("K4", id(bg), HD),
                lambda: D.gat_dense_blocks(bg, h, bg.values, a_s, a_d, ms),
                hd=HD, heads=H, blocks=bg.n_blocks, rows=bg.block_rows)
    elif kind == "gat_layer":
        F = x.shape[1]
        w, ws, wd = (params[k].to(torch.bfloat16)
                     for k in (plan.w_name, plan.was_name, plan.wad_name))
        xb = x.to(torch.bfloat16)
        add("K14", ("K14", id(data), F),
            lambda: A.gat_layer_tiles(data, xb, w, ws, wd,
                                      negative_slope=plan.negative_slope,
                                      final_sf=plan.final_sf),
            f=F, hd=w.shape[1], heads=ws.shape[1], **tile_geo(data))
    elif kind == "pair_agg":
        u, v = rnd(n, plan.width), rnd(n, plan.width)
        add("K13", ("K13", id(data), plan.width, graph.name),
            lambda: PA.pair_agg(data, u, v, sf=plan.sf, slope=plan.slope,
                                want_max=ir.MAX in plan.gathers),
            width=plan.width, graph=graph.name, **tile_geo(data))
    return out


def candidate_points(hg, dev, target_s: float) -> dict:
    """Every feasible candidate of each layer, lowered and timed whole, and
    the kernels alone on their structures."""
    from ..tune.search import (TILE_PALETTE, _candidate_schedules,
                               schedule_is_feasible)
    from ..utils.benchmark import time_layer_device
    from .fusion import classify_block, lower_schedule
    g = hg.to_device(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    cands, kernels = [], []
    for mname, model in models(dev).items():
        cache: dict = {}
        seen: set = set()
        params = dict(model.params)
        for li, layer in enumerate(model.layers):
            x = torch.randn((hg.n_node, layer.in_width), generator=gen,
                            device=dev)
            pool = [c for c in _candidate_schedules(layer, 64, TILE_PALETTE)
                    if schedule_is_feasible(layer, c, DTYPE_BYTES)]
            for cand in pool:
                kinds = kernel_kinds(layer, cand)
                if mname in ("DGN-2l", "PNA-2l") and set(kinds) == {"xla"}:
                    continue                 # per-op: too large for the card
                t0 = time.perf_counter()
                fn = lower_schedule(layer, cand, hg, torch.bfloat16,
                                    device=dev, tile_cache=cache)
                build_s = time.perf_counter() - t0
                sec = time_layer_device(fn, params, g, x, target_s=target_s,
                                        device=dev)
                cands.append(dict(model=mname, layer=li, key=cand.key(),
                                  kinds=kinds, ms=sec * 1e3,
                                  build_s=build_s))
                say(f"  {mname} l{li} {sec * 1e3:9.4f} ms "
                    f"(lowered {build_s:.1f} s) {kinds} "
                    f"{cand.key()[-44:]}")
                for (kind, block, data, _), tc in zip(fn.plans, cand.tiles):
                    if kind == "xla":
                        continue
                    plan = classify_block(layer, block, tc)[1]
                    with torch.inference_mode():
                        kernels += [dict(model=mname, layer=li, **k)
                                    for k in _kernel_times(
                                        kind, data, plan, layer, params, x,
                                        dev, seen)]
                del fn
            del x
        del cache
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return dict(candidates=cands, kernels=kernels)


# ---------------------------------------------------------------------------
# the fit of the kernel and block terms
# ---------------------------------------------------------------------------


def _layers(dev_models) -> Dict[tuple, ir.OpGraph]:
    return {(m, li): layer for m, model in dev_models.items()
            for li, layer in enumerate(model.layers)}


def fit_blocks(hg, meas: dict, c: LatencyConstants,
               layers: Dict[tuple, ir.OpGraph]) -> LatencyConstants:
    """K1's tile terms and K2's block constant from the kernels alone,
    then the block-level terms from each candidate's time less its
    modelled per-op blocks."""
    from .fusion import classify_block
    cost = GraphCost(hg, c)
    st = cost.stats

    # K1: tiles * grid_const + edges * (edge_ns + edge_byte_ns * F * 2),
    # over the full graph's tilings and the hybrid tails
    k1 = [k for k in meas["kernels"] if k["kernel"] == "K1"]
    a = [[k["tiles"], k["edges"], k["edges"] * k["f"] * DTYPE_BYTES]
         for k in k1]
    gc, en, eb = (_nnls_rel(a, [k["ms"] * 1e6 for k in k1])
                  if k1 else (0.0, 0.0, 0.0))
    c = dataclasses.replace(c, tile_grid_const_ns=gc, tile_edge_ns=en,
                            tile_edge_byte_ns=eb, tile_slot_ns=0.0,
                            tile_surcharge_ns=0.0, ramp_run_ns=0.0,
                            ramp_tile_ns=0.0, kernel_call_ns=0.0,
                            tile_panel_gbps=float("inf"))
    cost = GraphCost(hg, c)
    for k in k1:
        mod = k["tiles"] * gc + k["edges"] * (en + eb * k["f"] * DTYPE_BYTES)
        say(f"  residual K1 {k['part']} {k['rows']}x{k['cols']}x{k['et']} "
            f"F={k['f']}: {k['ms']:.4f} vs {mod / 1e6:.4f} ms")

    def block_parts(rec):
        """(kernel block kind, tc, plan, graph, measured block ns): the
        candidate's time less its modelled per-op blocks."""
        layer = layers[(rec["model"], rec["layer"])]
        sched = S.Schedule.from_key(rec["key"])
        t = rec["ms"] * 1e6
        out = None
        for blk, tc in zip(sched.blocks, sched.tiles):
            kind, plan = classify_block(layer, blk, tc)
            if kind == "xla":
                t -= sum(xla_op_ns(layer.by_id[o], layer, st, DTYPE_BYTES, c)
                         for o in blk)
            else:
                out = (kind, tc, plan, layer, blk)
        return None if out is None else out + (t,)

    parts = [p for p in (block_parts(r) for r in meas["candidates"])
             if p is not None]

    def med(vals, default):
        vals = [v for v in vals if np.isfinite(v)]
        return float(np.median(vals)) if vals else default

    # the launch and glue of a kernel block, from the one-hot spmm blocks
    calls = [t - cost.onehot_ns(tc, layer.width_of(plan.in_op), DTYPE_BYTES)
             for kind, tc, plan, layer, blk, t in parts if kind == "spmm"]
    c = dataclasses.replace(c, kernel_call_ns=max(med(calls, 0.0), 0.0),
                            dense_block_const_ns=0.0)
    cost = GraphCost(hg, c)
    call = c.kernel_call_ns
    # per dense block, from the spmm_hybrid blocks: what their split's
    # bytes, products and tail leave (K2 alone is printed beside it)
    per_blk = []
    for kind, tc, plan, layer, blk, t in parts:
        if kind == "spmm_hybrid":
            thr = cost.threshold("spmm", tc.dense_block or tc.block_rows,
                                 tc.dense_block or tc.block_cols)
            nb, _ = cost._dense_count(tc.dense_block or tc.block_rows,
                                      tc.dense_block or tc.block_cols, thr)
            if nb:
                per_blk.append((t - cost.hybrid_ns(
                    tc, layer.width_of(plan.in_op), thr, DTYPE_BYTES)) / nb)
    for k in meas["kernels"]:
        if k["kernel"] == "K2" and k["blocks"]:
            r = k["rows"]
            pb = max((r * r + r * k["f"] * DTYPE_BYTES) / c.hbm_gbps,
                     2.0 * r * r * k["f"] / (c.dense_tflops_bf16 * 1e3))
            say(f"  K2 alone {r}^2 F={k['f']}: {k['ms']:.4f} ms for "
                f"{k['blocks']} blocks, {k['ms'] * 1e6 / k['blocks'] - pb:.1f}"
                " ns a block beyond its bytes and products")
    c = dataclasses.replace(c, dense_block_const_ns=max(med(per_blk, 0.0),
                                                        0.0))
    cost = GraphCost(hg, c)

    def unit(tc, w):
        return cost.onehot_ns(tc, w, DTYPE_BYTES, include_ramp=False)

    gp = [(t - call) / unit(tc, layer.width_of(plan.h_op))
          for kind, tc, plan, layer, blk, t in parts if kind == "gat"]
    c = dataclasses.replace(c, gat_pass_factor=max(med(gp, 1.0), 0.0))
    gd, gl, gs, pf_sum, pf_max, stream_pts, gst = [], [], [], [], [], [], []
    for kind, tc, plan, layer, blk, t in parts:
        if kind == "gat_hybrid":
            hd = layer.width_of(plan.h_op)
            thr = cost.threshold("gat", tc.dense_block or tc.block_rows,
                                 tc.dense_block or tc.block_cols,
                                 heads=plan.heads,
                                 head_dim=hd // max(plan.heads, 1))
            dense, tail = cost._hybrid_parts(tc, hd, thr, DTYPE_BYTES,
                                             False, 1)
            r = tc.dense_block or tc.block_rows
            nb, _ = cost._dense_count(r, tc.dense_block or tc.block_cols,
                                      thr)
            if nb:
                gd.append(([dense, nb * r * r * plan.heads],
                           t - call - c.gat_pass_factor * tail))
        elif kind == "gat_layer":
            hd = max(layer.by_id[o].out_width for o in blk
                     if layer.by_id[o].compute == ir.MM)
            mm = _mm_in_block(layer, blk, st.n_node,
                              c.dense_tflops_bf16)
            gl.append((t - call - mm)
                      / (c.gat_pass_factor * unit(tc, hd)))
        elif kind == "spmm_grouped":
            hist = cost._hist(tc.block_rows, tc.block_cols)
            live = float(np.ceil(hist / tc.tile_edges).sum())
            f = layer.width_of(plan.in_op)
            e = float(hist.sum())
            gs.append((t - call - e * (c.tile_edge_ns + c.tile_edge_byte_ns
                                       * f * DTYPE_BYTES)) / live)
        elif kind == "pair_agg":
            mm = _mm_in_block(layer, blk, st.n_node, c.mxu_tflops_bf16)
            r = (t - call - mm) / unit(tc, plan.width)
            (pf_max if ir.MAX in plan.gathers else pf_sum).append(r)
        elif kind == "spmm_stream":
            f = layer.width_of(plan.in_op)
            vb = c.xla_value_bytes or DTYPE_BYTES
            rows = st.e_pad * (
                _row_ns(c.xla_take_row_ns, c.xla_take_byte_ns, f, vb, c)
                + _row_ns(c.xla_segment_row_ns, c.xla_segment_byte_ns, f,
                          vb, c)) * _row_factor(st, f, vb, c)
            stream_pts.append(([rows, cost.stream_chunks(tc)], t))
        elif kind == "gat_stream":
            gst.append((tc, layer.width_of(plan.h_op), t))
    if stream_pts:
        rf, cc = _nnls_rel([p[0] for p in stream_pts],
                           [p[1] for p in stream_pts])
    else:
        rf, cc = c.stream_row_factor, c.stream_chunk_ns
    gdf, gcell = (_nnls_rel([p[0] for p in gd], [p[1] for p in gd])
                  if gd else (c.gat_pass_factor, 0.0))
    c = dataclasses.replace(
        c, gat_dense_factor=gdf, gat_cell_ns=gcell,
        layer_kernel_factor=max(med(gl, 1.0), 0.0),
        grouped_sub_ns=max(med(gs, 0.0), 0.0),
        grouped_chunk_ns=0.0, grouped_weighted_ns=0.0,
        grouped_tflops_bf16=float("inf"), grouped_tflops_f32=float("inf"),
        pair_sum_factor=max(med(pf_sum, 1.0), 0.0),
        pair_max_factor=max(med(pf_max, 1.0), 0.0),
        pair_other_factor=max(med(pf_sum + pf_max, 1.0), 0.0),
        stream_row_factor=rf, stream_chunk_ns=cc)
    cost = GraphCost(hg, c)
    if gst:
        gf, gc = _nnls_rel([[cost.stream_ns(tc, hd, DTYPE_BYTES),
                             cost.stream_chunks(tc)] for tc, hd, _ in gst],
                           [t for _, _, t in gst])
        c = dataclasses.replace(c, gat_stream_factor=gf,
                                gat_stream_chunk_ns=gc)
    return c


def _mm_in_block(layer, blk, n, tflops) -> float:
    t = 0.0
    for o in blk:
        op = layer.by_id[o]
        if op.compute == ir.MM and op.extra.get("weight"):
            _, iw, ow = op.extra["weight"]
            t += 2.0 * n * iw * ow / (tflops * 1e3)
    return t


def report(hg, meas: dict, c: LatencyConstants,
           layers: Dict[tuple, ir.OpGraph]) -> List[dict]:
    """Per layer: measured against modelled of every timed candidate,
    Spearman's rho and the argmin regret."""
    from .latency import schedule_ns
    cost = GraphCost(hg, c)
    out = []
    by = {}
    for r in meas["candidates"]:
        by.setdefault((r["model"], r["layer"]), []).append(r)
    for (m, li), recs in by.items():
        layer = layers[(m, li)]
        mod = [schedule_ns(layer, S.Schedule.from_key(r["key"]), cost,
                           DTYPE_BYTES) / 1e6 for r in recs]
        meas_ms = [r["ms"] for r in recs]
        st = rank_stats(meas_ms, mod)
        say(f"  {m} l{li}: {len(recs)} candidates, rho {st['spearman']:.3f}, "
            f"argmin regret {st['argmin_regret']:.3f}")
        for r, t in sorted(zip(recs, mod), key=lambda p: p[0]["ms"]):
            say(f"    measured {r['ms']:9.4f} ms, modelled {t:9.4f} ms  "
                f"{r['kinds']} {r['key'][-40:]}")
        out.append(dict(model=m, layer=li, n=len(recs), **st))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edges", type=int, default=N_EDGE)
    ap.add_argument("--nodes", type=int, default=N_NODE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--target-s", type=float, default=TARGET_S)
    ap.add_argument("--out", default=os.path.join("build",
                                                  "latency_fit.json"))
    ap.add_argument("--refit", default=None,
                    help="fit again from this JSON of an earlier run's "
                         "measurements (on the host: no card needed)")
    args = ap.parse_args(argv)
    if args.refit:
        with open(args.refit) as f:
            old = json.load(f)
        card, l2, prim = old["card"], old["l2_bytes"], old["primitives"]
        meas = dict(candidates=old["candidates"], kernels=old["kernels"])
        say(f"refit of {args.refit}: measured on {card}")
        return fit_and_report(prim, meas, card, l2, args, time.perf_counter())
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("latency_fit: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    else:
        card, l2 = "cpu (a rehearsal: host times)", 50 << 20
    say(f"card: {card}; L2 {l2} bytes; torch {torch.__version__}")
    scale = args.nodes / N_NODE
    t0 = time.perf_counter()
    say("== per-op rows and products")
    prim = primitive_points(dev, scale)
    say("== candidates on the smoke's graph")
    hg = smoke_graph(args.edges, args.nodes)
    say(f"  graph: N={hg.n_node} E={hg.n_edge}")
    meas = candidate_points(hg, dev, args.target_s)
    return fit_and_report(prim, meas, card, l2, args, t0, hg)


def fit_and_report(prim, meas, card, l2, args, t0, hg=None) -> int:
    """Fit, print the constants and residuals, write the JSON."""
    if hg is None:
        hg = smoke_graph(args.edges, args.nodes)
    say("== fit")
    c = dataclasses.replace(LatencyConstants(), xla_value_bytes=4,
                            **fit_primitives(prim, l2))
    layers = _layers(models("cpu"))
    c = fit_blocks(hg, meas, c, layers)
    say("== measured against modelled, per layer")
    ranks = report(hg, meas, c, layers)
    fields = {f.name: (int(v) if isinstance(v, (int, np.integer))
                       else float(v))
              for f in dataclasses.fields(c)
              for v in [getattr(c, f.name)]}
    say("LatencyConstants(")
    for k, v in fields.items():
        say(f"    {k}={v!r},")
    say(f")  # {card}, {time.strftime('%Y-%m-%d')}")
    say(f"latency_fit took {time.perf_counter() - t0:.1f} s")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, l2_bytes=l2, primitives=prim, **meas,
                       constants={k: (v if np.isfinite(v) else str(v))
                                  for k, v in fields.items()},
                       ranks=ranks), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
