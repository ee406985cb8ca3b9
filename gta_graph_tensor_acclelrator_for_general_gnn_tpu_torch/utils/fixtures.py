"""A small graph that reaches every edge case of the kernels, and the
kernel-against-plain-version cases run on it.

Shared by the CPU parity tests, the card's kernel tests
(``tests/test_torch_cuda.py``) and the on-card checks of ``chip_smoke.py``.  Nodes 0..511 form four 128-node communities (dense
diagonal blocks at a 128 grid); one pair repeats past the int8 count
maximum; the last row block has no dense block and most of its rows no
in-edge; its last row draws only from two sources whose a_src the caller
may push far below the rest, past the shift-bound gap.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np

from .. import ir

N_NODE = 600
HOT_PAIR = (5, 7)          # sender, receiver
HOT_COPIES = 200           # > 127: int8 counts saturate
GAP_ROW = 599
GAP_SOURCES = (597, 598)   # the only senders into GAP_ROW

# Bound on |kernel - plain| in each row, relative to the row's scale
# (kernel_error).  Kernel and plain version round at the same points, so
# they differ in two ways only.  (1) f32 summation order (atomics,
# tensor-core accumulation): reordering a sum of n terms moves it by about
# sqrt(n) u of its size (u = 2^-24, the probabilistic bound of Higham), so
# a row that sums n terms is allowed SUM_ORDER sqrt(n) u where that exceeds
# the dtype's tolerance, i.e. rows of more than 1,759 terms: the hubs.
# That estimate needs rounding errors of random sign; a row that repeats
# one term (a multigraph's copies of one edge) makes the same rounding at
# every add, up to ~n/4 ulps: K1 and K9 sum each receiver's run of slots
# in registers (the drift then spans a run, not the row), and their plain
# version sums in float64.  (2) In bfloat16, flips of
# one rounded product or p by one bf16 ulp where an f32 input differs in
# its last bit (derive mode sums a_s in another order).  A flip moves one
# term by at most 2^-7 (7.8e-3) of itself, and no term exceeds its row's
# scale: the bf16 tolerance covers one flip per row.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SUM_ORDER = 4.0
# rows whose scale is below this share of their group's largest take it
ROW_FLOOR = 1e-6
# K17 (GATv2's attention) against its plain version: each row's error over
# the row's sum of alpha |u_j| (the plain version's ``magnitude``).  Both
# take the same rounded u and v and return float32 in either dtype; the
# kernel's float32 scores, __expf and sums in another order move alpha by
# a few 1e-6 relative, and a hub row merges thousands of chunk partials in
# float32
K17_TOL = 1e-4


class KernelCase(NamedTuple):
    """One kernel-against-plain comparison.  ``split``: the width of the
    first column group of the output (num of [num | den], das of [das |
    dh]); ``terms``: the terms each output row sums (:func:`row_terms`);
    ``scale``: per-element magnitudes that replace |ref| as the scale (the
    sums of |term| of the backward kernels, whose sums cancel)."""
    kernel: str
    case: str
    dtype_name: str
    out: Any
    ref: Any
    split: Optional[int] = None
    terms: Any = None
    scale: Any = None


def row_terms(graph):
    """Terms each output row of a kernel sums, float32: the live slots of a
    ``TiledGraph`` or ``GroupedTiledGraph`` per node, or the nonzero cells
    of a ``DenseBlockGraph``'s blocks per padded row."""
    import torch

    from ..graph import DenseBlockGraph
    from ..ops.spmm import _geometry, _live_slots, _unit_steps
    R = graph.block_rows
    if isinstance(graph, DenseBlockGraph):
        nz = (graph.values != 0).sum(
            dim=1 if graph.values_layout == "cr" else 2)       # [B, R]
        acc = torch.zeros((graph.n_row_blocks, R), device=nz.device)
        return acc.index_add_(0, graph.blk_rb.long(), nz.float()).view(-1)
    rows = _geometry(graph)[1]
    acc = torch.zeros(rows, device=graph.src_local.device)
    for u0, u1 in _unit_steps(graph, 1):
        acc += torch.bincount(_live_slots(graph, u0, u1)[2], minlength=rows)
    return acc[: graph.n_node]


def kernel_error(c: KernelCase) -> Tuple[float, float]:
    """(max |out - ref|, largest share of its bound that a row's error
    takes; the case passes at or below 1).

    A row's bound is its scale times max(KERNEL_TOL, SUM_ORDER sqrt(terms)
    u).  The scale is max |ref| (or ``c.scale``) over the row's column
    group: the whole row, or with ``split`` the two groups apart, since den
    runs orders of magnitude above num.  A scale below ``ROW_FLOOR`` of the
    group's largest (or of 1) is raised to it, so an all-zero row must come
    out zero.  Against a sum of |term| scale the bf16 tolerance covers any
    number of one-ulp flips of rounded terms (each at most 2^-8 of its
    term)."""
    import torch
    if c.out.numel() == 0:
        return 0.0, 0.0
    err = (c.out.float() - c.ref.float()).abs()
    mag = (c.ref if c.scale is None else c.scale).float().abs()
    tol = torch.full((mag.shape[0],), KERNEL_TOL[c.dtype_name],
                     device=mag.device)
    if c.terms is not None:
        tol = torch.maximum(tol, SUM_ORDER * 2.0 ** -24
                            * c.terms.float().to(mag.device).sqrt())
    groups = ([slice(None)] if c.split is None
              else [slice(0, c.split), slice(c.split, None)])
    share = 0.0
    for cols in groups:
        row_scale = mag[:, cols].amax(dim=1)
        floor = ROW_FLOOR * max(1.0, float(row_scale.max()))
        bound = row_scale.clamp(min=floor) * tol
        share = max(share, float((err[:, cols].amax(dim=1) / bound).max()))
    return float(err.max()), share


def k17_error(got, want, mag, rows=None) -> float:
    """The largest |K17 - plain| over each row's magnitude ``mag`` (see
    ``K17_TOL``), over ``rows`` where given; raise unless a row of
    magnitude 0 is exactly 0."""
    if rows is not None:
        got, want, mag = got[rows], want[rows], mag[rows]
    scale = mag.abs().amax(1, keepdim=True)
    err = (got - want).abs()
    if not bool((err[scale[:, 0] == 0] == 0).all()):
        raise AssertionError("K17: a row without weight is not 0")
    return float((err / scale.clamp(min=1e-30)).amax())


def check_kernel(c: KernelCase) -> Tuple[float, float]:
    """Raise AssertionError unless ``c.out`` has ``c.ref``'s shape, is
    finite and lies within its bound by :func:`kernel_error`; returns
    (max abs error, share of the bound)."""
    import torch
    what = f"{c.kernel} {c.case} {c.dtype_name}"
    if c.out.shape != c.ref.shape:
        raise AssertionError(f"{what}: shape {tuple(c.out.shape)} != "
                             f"{tuple(c.ref.shape)}")
    if not bool(torch.isfinite(c.out).all()):
        raise AssertionError(f"{what}: non-finite output")
    err, share = kernel_error(c)
    if not share <= 1.0:
        raise AssertionError(f"{what}: max abs error {err:.3e}; a row's "
                             f"error is {share:.3f} of its bound")
    return err, share


def edge_case_graph(seed: int = 0, n_edge: int = 4000
                    ) -> Tuple[np.ndarray, np.ndarray, int, Dict]:
    """(senders, receivers, n_node, meta) as int32 COO arrays."""
    rng = np.random.default_rng(seed)
    com = rng.integers(0, 4, size=n_edge)
    intra = rng.random(n_edge) < 0.7
    r = com * 128 + rng.integers(0, 128, size=n_edge)
    s = np.where(intra, com * 128 + rng.integers(0, 128, size=n_edge),
                 rng.integers(0, 512, size=n_edge))
    keep = s != r
    s, r = s[keep], r[keep]
    s = np.concatenate([s, np.full(HOT_COPIES, HOT_PAIR[0]),
                        np.asarray(GAP_SOURCES)])
    r = np.concatenate([r, np.full(HOT_COPIES, HOT_PAIR[1]),
                        np.full(len(GAP_SOURCES), GAP_ROW)])
    meta = dict(gap_row=GAP_ROW, empty_row_block_start=512)
    return s.astype(np.int32), r.astype(np.int32), N_NODE, meta


def gap_a_src(rng: np.random.Generator, n_node: int, heads: int,
              drop: float = 1000.0) -> np.ndarray:
    """Source logits [n_node, heads] with the gap row's sources ``drop``
    below the rest.  leaky_relu scales negative logits by its slope, so the
    drop must exceed ~85 / slope for that row's attention to underflow to
    zero under the global shift bound, as it does in the TPU kernels."""
    a = rng.normal(size=(n_node, heads)).astype(np.float32)
    a[list(GAP_SOURCES)] -= drop
    return a


# K1 and K2 widths: tiny, the 41 logits (odd, unaligned), aligned, a full
# 128-feature tile, and several feature tiles with a ragged last one
SPMM_WIDTHS = (8, 41, 48, 128, 300)
HUB_NODE = 0
HUB_COPIES = 300           # copies of one pair into the hub: runs > ET
# dense blocks in row blocks 0-3 of seg_block_graph: both sides of the cuts
# of DenseBlockGraph.segments (8 a run) and .wide_segments (16 a run)
SEG_COUNTS = (8, 9, 16, 17)


def hub_graph(seed: int = 0, n_node: int = 2048, n_edge: int = 4000,
              hub_edges: int = 6000) -> Tuple[np.ndarray, np.ndarray, int]:
    """(senders, receivers, n_node) as int32 COO arrays: random edges plus
    ``hub_edges`` from the first 128 columns into the first 128 rows, half
    of them into ``HUB_NODE``, and ``HUB_COPIES`` copies of one pair into
    it.  At 128-wide blocks and 32-slot tiles, row block 0 then owns some
    200 full tiles, and one receiver's run of slots fills whole tiles."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_node, n_edge)
    r = rng.integers(0, n_node, n_edge)
    hs = rng.integers(0, 128, hub_edges)
    hr = np.where(rng.random(hub_edges) < 0.5, HUB_NODE,
                  rng.integers(0, 128, hub_edges))
    s = np.concatenate([s, hs, np.full(HUB_COPIES, 5)])
    r = np.concatenate([r, hr, np.full(HUB_COPIES, HUB_NODE)])
    return s.astype(np.int32), r.astype(np.int32), n_node


def hub_tiling(device, seed: int = 0, unit_weight: bool = False):
    """The symmetric-norm tiling of :func:`hub_graph` at 128-wide blocks and
    32-slot tiles; with ``unit_weight`` the attention kernels' unit-weight
    tiling, whose slot weights are the copy counts of merged pairs."""
    from .. import graph as G
    s, r, n = hub_graph(seed=seed)
    hg = G.build_host_graph(s, r, n, symmetric_norm=not unit_weight,
                            edge_pad_multiple=128)
    return G.tile_graph(hg, block_rows=128, block_cols=128, tile_edges=32,
                        unit_weight=unit_weight, device=device)


def seg_block_graph(device, seed: int = 0):
    """A :class:`DenseBlockGraph` of 64-wide blocks whose row blocks 0-3
    own ``SEG_COUNTS`` dense blocks (random int8 counts 0-3, in shuffled
    order) and whose last row block owns none."""
    import torch

    from .. import graph as G
    block = 64
    rng = np.random.default_rng(seed)
    n_blk = max(SEG_COUNTS) + 1
    rb = np.repeat(np.arange(len(SEG_COUNTS)), SEG_COUNTS)
    cb = np.concatenate([rng.permutation(n_blk)[:c] for c in SEG_COUNTS])
    perm = rng.permutation(len(rb))
    vals = rng.integers(0, 4, (len(rb), block, block)).astype(np.int8)

    def dev(v):
        return torch.as_tensor(v, device=device)

    return G.DenseBlockGraph(
        blk_rb=dev(rb[perm].astype(np.int32)),
        blk_cb=dev(cb[perm].astype(np.int32)), values=dev(vals),
        row_mask=dev(np.arange(n_blk) < len(SEG_COUNTS)), block_rows=block,
        block_cols=block, n_node=n_blk * block, n_row_blocks=n_blk,
        n_col_blocks=n_blk)


def kernel_cases(device, seed: int = 0) -> Iterator[KernelCase]:
    """K1-K4 on the edge-case graph, in float32 and bfloat16: yields
    :class:`KernelCase` items (no row here sums enough terms for
    ``terms`` to matter).  On a CPU device both sides are the plain
    version.  Cases: a dead tile (cb = -1)
    whose slots look live; int8 counts in supergroup order with a row block
    that no dense block visits (its stripe must read 0); more than 127
    copies of one pair (count 127 dense plus a merged tail slot); a row past
    the shift-bound gap; both dense layouts; derive and values modes; raw
    and normalized output.  Each at two widths: 16-byte-aligned rows (F =
    48; 4 heads of 32) and the unaligned, partial-tile width of a last
    layer (F = 41; 1 head of 41), which take separate code in the
    kernels.  K1 and K2 also at every ``SPMM_WIDTHS``; K2 with float
    values (of x's dtype) and on :func:`seg_block_graph` (row blocks of 8,
    9, 16 and 17 dense blocks); K1 on :func:`hub_tiling` (full tiles, runs
    longer than a tile).  K3 in each of its a_s forms: float32 per-node
    logits (the hybrid path's), derive mode (its per-node pass) and values
    mode, on the hybrid tails, on a tail with a dead tile and on the
    unit-weight hub tiling (full tiles, a run of 300 copies); and at 1 head
    of 128 and 2 of 64, whose [num | den] rows are not 16-byte aligned."""
    import torch

    import dataclasses

    from .. import graph as G
    from ..ops import dense as D
    from ..ops import gat as A
    from ..ops import spmm as SP

    s, r, n, meta = edge_case_graph(seed=seed)
    hg = G.build_host_graph(s, r, n, symmetric_norm=True,
                            edge_pad_multiple=128)
    hg_u = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    tg = _dead_tile(G.tile_graph(hg, block_rows=128, block_cols=128,
                                 tile_edges=128, device=device))
    bg = G.hybrid_graph(hg, block_rows=128, block_cols=128, tile_edges=128,
                        min_nnz=64, supergroup=16, values_dtype=np.int8,
                        device=device).dense
    hys = {layout: G.hybrid_graph(hg_u, block_rows=128, block_cols=128,
                                  tile_edges=128, min_nnz=64,
                                  unit_weight=True, values_dtype=np.int8,
                                  block_layout=layout, device=device)
           for layout in ("cr", "rc")}
    if float(hys["cr"].tiles.weight.float().max()) <= 1.0:
        raise AssertionError("fixture lost its merged multi-edge slot")
    bg_v = G.hybrid_graph(hg, block_rows=128, block_cols=128,
                          tile_edges=128, min_nnz=64, device=device).dense
    bg_vcr = G.hybrid_graph(hg, block_rows=128, block_cols=128,
                            tile_edges=128, min_nnz=64, block_layout="cr",
                            device=device).dense
    hub, seg = hub_tiling(device, seed), seg_block_graph(device, seed)
    hub_u = hub_tiling(device, seed, unit_weight=True)
    hub_terms = row_terms(hub_u)
    dead_tail = _dead_tile(hys["cr"].tiles)
    seg_cr = dataclasses.replace(seg, values_layout="cr")
    rng = np.random.default_rng(seed)
    K = KernelCase
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for F in SPMM_WIDTHS:
            x = torch.tensor(rng.standard_normal((n, F)), dtype=dt,
                             device=device)
            yield K("spmm_tiles", f"dead tile F={F}", name,
                    SP.spmm_tiles(tg, x, tg.weight),
                    SP._spmm_reference(tg, x))
            y = D.spmm_dense_blocks(bg, x, bg.values)
            yield K("spmm_dense_blocks", f"int8 sg16 F={F}", name, y,
                    D._spmm_dense_reference(bg, x, bg.values))
            stripe = y[meta["empty_row_block_start"]:]
            yield K("spmm_dense_blocks", f"unvisited stripe is 0 F={F}",
                    name, stripe, torch.zeros_like(stripe))
        for F in (41, 48):
            x = torch.tensor(rng.standard_normal((n, F)), dtype=dt,
                             device=device)
            v = bg_v.values.to(dt)
            yield K("spmm_dense_blocks", f"{name} values F={F}", name,
                    D.spmm_dense_blocks(bg_v, x, v),
                    D._spmm_dense_reference(bg_v, x, v))
            xh = torch.tensor(rng.standard_normal((hub.n_node, F)),
                              dtype=dt, device=device)
            yield K("spmm_tiles", f"hub, full tiles F={F}", name,
                    SP.spmm_tiles(hub, xh, hub.weight),
                    SP._spmm_reference(hub, xh))
            xg = torch.tensor(rng.standard_normal((seg.n_node, F)),
                              dtype=dt, device=device)
            yield K("spmm_dense_blocks", f"blocks per row block "
                    f"{SEG_COUNTS} F={F}", name,
                    D.spmm_dense_blocks(seg, xg, seg.values),
                    D._spmm_dense_reference(seg, xg, seg.values))
        for H, HD in ((4, 128), (1, 41)):
            h = torch.tensor(rng.standard_normal((n, HD)), dtype=dt,
                             device=device)
            a_s = torch.tensor(gap_a_src(rng, n, H), device=device)
            a_d = torch.tensor(rng.standard_normal((n, H)), dtype=dt,
                               device=device).float()
            w = torch.tensor(rng.standard_normal((HD, H)) / np.sqrt(HD),
                             dtype=dt, device=device)
            ms = a_s.amax(0, keepdim=True)
            ms_w = (h.float() @ w.float()).amax(0, keepdim=True)
            a_sv = a_s.to(dt).contiguous()
            for layout, hy in hys.items():
                tt, bd = hy.tiles, hy.dense
                tag = f"{layout} H={H} HD={HD}"
                for norm in (False, True):
                    yield K("gat_tiles", f"values gap {tag} norm={norm}", name,
                            A.gat_tiles(tt, h, tt.weight, a_d, ms, a_src=a_sv,
                                        normalize=norm),
                            A._gat_tiles_reference(tt, h, tt.weight, a_d, ms,
                                                   a_src=a_sv, normalize=norm),
                            None if norm else HD)
                yield K("gat_tiles", f"derive raw {tag}", name,
                        A.gat_tiles(tt, h, tt.weight, a_d, ms_w, w_asrc=w,
                                    normalize=False),
                        A._gat_tiles_reference(tt, h, tt.weight, a_d, ms_w,
                                               w_asrc=w, normalize=False), HD)
                yield K("gat_tiles", f"a_s f32 gap {tag}", name,
                        A.gat_tiles(tt, h, tt.weight, a_d, ms, a_src=a_s,
                                    normalize=False),
                        A._gat_tiles_reference(tt, h, tt.weight, a_d, ms,
                                               a_src=a_s, normalize=False),
                        HD)
                yield K("gat_dense_blocks", f"int8 {tag}", name,
                        D.gat_dense_blocks(bd, h, bd.values, a_s, a_d, ms),
                        D._gat_dense_reference(bd, h, bd.values, a_s, a_d,
                                               ms), HD)
            for form, kw, msf in (("derive", dict(w_asrc=w), ms_w),
                                  ("a_s f32", dict(a_src=a_s), ms)):
                for tag, tt in (("dead tile", dead_tail),
                                ("hub, full tiles", hub_u)):
                    if tt is hub_u:
                        h_t = torch.tensor(
                            rng.standard_normal((tt.n_node, HD)), dtype=dt,
                            device=device)
                        a_dt = torch.tensor(
                            rng.standard_normal((tt.n_node, H)), dtype=dt,
                            device=device).float()
                        kw_t = dict(kw) if "w_asrc" in kw else dict(
                            a_src=torch.tensor(gap_a_src(rng, tt.n_node, H),
                                               device=device))
                        ms_t = ((h_t.float() @ w.float()) if "w_asrc" in kw
                                else kw_t["a_src"]).amax(0, keepdim=True)
                    else:
                        h_t, a_dt, kw_t, ms_t = h, a_d, kw, msf
                    case = f"{form} {tag} H={H} HD={HD}"
                    yield K("gat_tiles", case, name,
                            A.gat_tiles(tt, h_t, tt.weight, a_dt, ms_t,
                                        normalize=False, **kw_t),
                            A._gat_tiles_reference(tt, h_t, tt.weight, a_dt,
                                                   ms_t, normalize=False,
                                                   **kw_t), HD,
                            hub_terms if tt is hub_u else None)
        # K3 where each head's features take vector loads (D % 4 == 0) but
        # the [num | den] rows (HD + H floats) are not 16-byte aligned, so
        # a run's flush adds float by float: 1 head of 128, 2 of 64, in both
        # a_s forms, on a hybrid tail and on the hub tiling (own generator:
        # the cases above keep their data)
        rng3 = np.random.default_rng(seed + 1)
        for H, HD in ((1, 128), (2, 64)):
            w = torch.tensor(rng3.standard_normal((HD, H)) / np.sqrt(HD),
                             dtype=dt, device=device)
            for tag, tt in (("cr tail", hys["cr"].tiles),
                            ("hub, full tiles", hub_u)):
                h_t = torch.tensor(rng3.standard_normal((tt.n_node, HD)),
                                   dtype=dt, device=device)
                a_dt = torch.tensor(rng3.standard_normal((tt.n_node, H)),
                                    dtype=dt, device=device).float()
                a_st = torch.tensor(gap_a_src(rng3, tt.n_node, H),
                                    device=device)
                for form, kw, ms_t in (
                        ("derive", dict(w_asrc=w),
                         (h_t.float() @ w.float()).amax(0, keepdim=True)),
                        ("a_s f32", dict(a_src=a_st),
                         a_st.amax(0, keepdim=True))):
                    yield K("gat_tiles", f"{form} unaligned rows {tag} H={H} "
                            f"HD={HD}", name,
                            A.gat_tiles(tt, h_t, tt.weight, a_dt, ms_t,
                                        normalize=False, **kw),
                            A._gat_tiles_reference(tt, h_t, tt.weight, a_dt,
                                                   ms_t, normalize=False,
                                                   **kw), HD,
                            hub_terms if tt is hub_u else None)
        # K4 alone: more head shapes (2 heads of 32; 8 heads of 8), values
        # of h's dtype in 'cr' blocks, and row blocks of 8, 9, 16 and 17
        # dense blocks (both sides of the 8- and 16-block run cuts), in
        # both layouts
        for H, HD, tag, bd in (
                (2, 64, "int8 cr", hys["cr"].dense),
                (2, 64, "int8 rc", hys["rc"].dense),
                (8, 64, "int8 cr", hys["cr"].dense),
                (8, 64, "int8 rc", hys["rc"].dense),
                (4, 128, f"{name} values cr", bg_vcr),
                (1, 41, f"{name} values cr", bg_vcr),
                (4, 128, f"blocks per row block {SEG_COUNTS} rc", seg),
                (4, 128, f"blocks per row block {SEG_COUNTS} cr", seg_cr),
                (1, 41, f"blocks per row block {SEG_COUNTS} cr", seg_cr)):
            nb = bd.n_col_blocks * bd.block_cols
            h = torch.tensor(rng.standard_normal((nb, HD)), dtype=dt,
                             device=device)
            a_s = torch.tensor(gap_a_src(rng, nb, H), device=device)
            a_d = torch.tensor(rng.standard_normal((nb, H)), dtype=dt,
                               device=device).float()
            ms = a_s.amax(0, keepdim=True)
            v = bd.values if bd.values.dtype == torch.int8 else \
                bd.values.to(dt)
            yield K("gat_dense_blocks", f"{tag} H={H} HD={HD}", name,
                    D.gat_dense_blocks(bd, h, v, a_s, a_d, ms),
                    D._gat_dense_reference(bd, h, v, a_s, a_d, ms), HD)


GROUPED_KERNELS = ("spmm_grouped", "gat_grouped")
# K9 widths: tiny, the 41 logits, aligned, a full 128-feature pass, and
# several passes with a ragged last one
GROUPED_WIDTHS = (8, 41, 48, 128, 300)


def hub_grouped(device, seed: int = 0):
    """The unit-weight grouped tiling of :func:`hub_graph` at 128-wide
    blocks, 32-slot sub-tiles in groups of 4: the hub row's block spills
    into dozens of levels, each a chunk whose other sub-tiles are mostly
    empty."""
    from .. import graph as G
    s, r, n = hub_graph(seed=seed)
    hg = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    return G.tile_graph_grouped(hg, block_rows=128, block_cols=128,
                                tile_edges=32, group=4, unit_weight=True,
                                device=device)


def grouped_tilings(device, seed: int = 0) -> Dict[str, Any]:
    """name -> GroupedTiledGraph, the tilings K9 and K10 are checked on:
    the whole edge-case graph with symmetric-norm weights at 32-row blocks
    in groups of 2 (a stripe group without edges gets a chunk of padding;
    most sub-tiles are empty); the whole graph with unit weights at 128-row
    blocks in groups of 4 (no weight stream); the grouped tails of the
    bench's two hybrid recipes at 128-wide blocks, the 'rc' int8
    supergroup-16 split with weighted tail slots and the 'cr' int8 unit
    split, whose tail holds the merged slot of more than 127 copies (its
    weight, the copy count, scales p); and :func:`hub_grouped` (deep spill
    levels)."""
    from .. import graph as G

    s, r, n, _ = edge_case_graph(seed=seed)
    hg = G.build_host_graph(s, r, n, symmetric_norm=True,
                            edge_pad_multiple=128)
    hg_u = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    split = dict(block_rows=128, block_cols=128, tile_edges=64, min_nnz=64,
                 values_dtype=np.int8, tail_format="grouped", tail_group=4,
                 device=device)
    tilings = {
        "weighted R32 G2": G.tile_graph_grouped(
            hg, block_rows=32, block_cols=64, tile_edges=32, group=2,
            device=device),
        "unit R128 G4": G.tile_graph_grouped(
            hg_u, block_rows=128, block_cols=128, tile_edges=64, group=4,
            unit_weight=True, device=device),
        "rc int8 sg16 tail": G.hybrid_graph(hg, supergroup=16,
                                            **split).tiles,
        "cr int8 unit tail": G.hybrid_graph(hg_u, unit_weight=True,
                                            block_layout="cr", **split).tiles,
        "hub R128 G4 ET32": hub_grouped(device, seed),
    }
    t32 = tilings["weighted R32 G2"]
    has_edges = (t32.dst_local < t32.block_rows).flatten(1).any(1)
    empty = set(range(t32.n_groups)) - set(t32.chunk_grp[has_edges].tolist())
    if not empty or float(tilings["cr int8 unit tail"].weight.max()) <= 1.0:
        raise AssertionError("fixture lost its padding chunk or its merged "
                             "multi-edge slot")
    return tilings


def grouped_kernel_cases(device, seed: int = 0) -> Iterator[KernelCase]:
    """K9 and K10 on :func:`grouped_tilings`, in float32 and bfloat16,
    against their plain versions: K9 at every ``GROUPED_WIDTHS`` (weighted
    tilings with the weight stream, unit ones without); K10 at 4 heads of
    32, 1 head of 41 and 16 heads of 1, in both forms of a_s: derive mode
    (``w_asrc``) and the float32 per-node array (``a_src``, the grouped
    hybrid path's)."""
    import torch

    from ..ops import gat as A
    from ..ops import spmm as SP

    tilings = grouped_tilings(device, seed)
    rng = np.random.default_rng(seed)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for tag, tg in tilings.items():
            n = tg.n_node
            for F in GROUPED_WIDTHS:
                x = torch.tensor(rng.standard_normal((n, F)), dtype=dt,
                                 device=device)
                w = None if tg.weight_all_unit else tg.weight
                yield KernelCase("spmm_grouped", f"{tag} F={F}", name,
                                 SP.spmm_grouped(tg, x, w),
                                 SP._spmm_grouped_reference(tg, x))
            for H, HD in ((4, 128), (1, 41), (16, 16)):
                h = torch.tensor(rng.standard_normal((n, HD)), dtype=dt,
                                 device=device)
                w_as = torch.tensor(rng.standard_normal((HD, H))
                                    / np.sqrt(HD), dtype=dt, device=device)
                a_d = torch.tensor(rng.standard_normal((n, H)),
                                   dtype=torch.float32, device=device)
                a_s = h.float() @ w_as.float()
                ms = a_s.amax(0, keepdim=True)
                yield KernelCase(
                    "gat_grouped", f"{tag} H={H} HD={HD}", name,
                    A.gat_grouped(tg, h, a_d, ms, w_as),
                    A._gat_grouped_reference(tg, h, a_d, ms, w_as), HD)
                yield KernelCase(
                    "gat_grouped", f"{tag} H={H} HD={HD} a_src", name,
                    A.gat_grouped(tg, h, a_d, ms, a_src=a_s),
                    A._gat_tiles_reference(tg, h, tg.weight, a_d, ms,
                                           a_src=a_s, normalize=False), HD)


SDDMM_KERNELS = ("sddmm_tiles", "sddmm_grouped")
# (heads, per-head width P): MUL's heads = F (P = 1), the ADD augmentation
# (P = 2) at 4 heads and 1, heads of a warp's width, one head of 128, and a
# width past a warp that is no multiple of it.  The walk of K11 and K12
# (csrc/tile_walk.cuh sddmm_config) cuts at rows of 32 bytes and at
# SDDMM_MAXH = 8 heads: 8 heads of 2 (bf16 a lane a slot, float32 lane
# groups), 3 of 4 (bf16 a lane a slot one feature at a time, float32 lane
# groups), 9 of 2 (past 8 heads that straddle loads: a lane a slot, one
# feature at a time), 16 of 4 (past 8 heads, each within a load) and 5 of
# 1 (a lane a slot, F no power of two)
SDDMM_SHAPES = ((128, 1), (4, 2), (1, 2), (4, 32), (1, 128), (2, 41),
                (8, 2), (3, 4), (9, 2), (16, 4), (5, 1))
# K11 and K12 on rows one element off their allocation's alignment: the
# narrow rows' whole-row loads and the wide rows' vector loads give way to
# narrower ones
SDDMM_UNALIGNED = ((1, 2), (4, 2), (1, 128), (128, 1))


def _slots(e):
    """[heads, units, slots] -> [all slots, heads]: one check row a slot."""
    return e.reshape(e.shape[0], -1).t()


def _dead_tile(tg, t: int = 1):
    """``tg`` with tile ``t`` marked dead (cb = -1); its slots look live."""
    import dataclasses
    cb = tg.tile_cb.clone()
    cb[t] = -1
    return dataclasses.replace(tg, tile_cb=cb)


def _dead_chunk(tg):
    """(``tg`` with its first chunk that holds an edge marked dead (cb =
    -1), that chunk): its slots look live, and its sub-tiles stay on the
    work list (``live_sub`` reads slot 0 only)."""
    import dataclasses
    c = int(tg.live_sub[0]) // tg.group
    cb = tg.chunk_cb.clone()
    cb[c] = -1
    return dataclasses.replace(tg, chunk_cb=cb), c


def _unaligned(x):
    """``x`` copied into rows that start one element past an aligned
    allocation (contiguous, so the wrappers take it)."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _over_nan(shape, device, run):
    """``run()``'s output, which it must allocate over a freed block of NaN
    of its own size: K11 and K12 write every slot of an unfilled output, so
    a slot they miss reads NaN (which the check rejects), not the zeros of
    fresh memory or an earlier call's result.  The allocator's pool is as
    it was before the NaN block, so the output takes that block; raise if
    not."""
    import torch
    nan = torch.full(shape, float("nan"), dtype=torch.float32, device=device)
    ptr = nan.data_ptr()
    del nan
    out = run()
    if out.data_ptr() != ptr:
        raise AssertionError("the kernel's output did not take the NaN block")
    return out


def _prefix_cases(tg, ET: int) -> None:
    """Raise unless ``tg`` (per-tile or grouped) holds a full tile or
    sub-tile (ET live slots) and one whose edge prefix ends inside a
    window of 32 slots."""
    from ..graph import GroupedTiledGraph
    alive = (tg.chunk_cb.repeat_interleave(tg.group)
             if isinstance(tg, GroupedTiledGraph) else tg.tile_cb) >= 0
    src, dst = tg.src_local.reshape(-1, ET), tg.dst_local.reshape(-1, ET)
    n = ((src < tg.block_cols) & (dst < tg.block_rows) & alive[:, None]).sum(1)
    if not (bool((n == ET).any()) and bool(((n % 32) != 0).any())):
        raise AssertionError("the SDDMM fixture tiling lost its full tile or "
                             "its prefix that ends mid-window")


def sddmm_kernel_cases(device, seed: int = 0) -> Iterator[KernelCase]:
    """K11 and K12 against their plain versions on the edge-case graph, in
    float32 and bfloat16, at every (heads, P) of ``SDDMM_SHAPES``.  K11:
    the whole graph at 128-wide blocks, ET 64, with a dead tile whose slots
    look live (it must read exact zeros), and at ET 50 (no multiple of 4
    or 32: the last window of a tile runs past ET, and the zeros past the
    edge prefix go a float at a time).  K12: grouped tilings at 32-row
    blocks in groups of 2, ET 32 (a chunk of padding, mostly empty
    sub-tiles off the work list), at 128-row blocks in groups of 4, ET 64,
    with a dead chunk whose slots look live (exact zeros), and at 64-wide
    blocks in groups of 2, ET 50.  Every tiling holds full (sub-)tiles and
    ones whose prefix ends mid-window (:func:`_prefix_cases`); both
    kernels also run at ``SDDMM_UNALIGNED`` on their dead-unit tilings,
    with rows off the vector loads' alignment.  On the card each output
    lies over NaN (:func:`_over_nan`), so each slot checked is one the
    kernel wrote.  Each slot is a check row scaled by its heads' sums of
    |product|, since a dot may cancel."""
    import torch

    from .. import graph as G
    from ..ops import sddmm as SD
    from ..ops.spmm import _geometry

    s, r, n, _ = edge_case_graph(seed=seed)
    hg = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    tiles = {ET: G.tile_graph(hg, block_rows=128, block_cols=128,
                              tile_edges=ET, unit_weight=True, device=device)
             for ET in (64, 50)}
    grouped = {
        "R32 G2": G.tile_graph_grouped(hg, block_rows=32, block_cols=64,
                                       tile_edges=32, group=2, device=device),
        "R128 G4": G.tile_graph_grouped(hg, block_rows=128, block_cols=128,
                                        tile_edges=64, group=4,
                                        device=device),
        "ET 50 G2": G.tile_graph_grouped(hg, block_rows=64, block_cols=64,
                                         tile_edges=50, group=2,
                                         device=device),
    }
    for t in (*tiles.values(), *grouped.values()):
        _prefix_cases(t, t.tile_edges)
    tg = _dead_tile(tiles[64])
    gd, dead_c = _dead_chunk(grouped["R128 G4"])
    k11 = ("sddmm_tiles", SD.sddmm_tiles, SD._sddmm_reference)
    k12 = ("sddmm_grouped", SD.sddmm_grouped, SD._sddmm_grouped_reference)
    # (kernel, wrapper, plain version, tag, tiling, the dead unit or None)
    runs = [(*k11, "dead tile", tg, 1), (*k11, "ET 50", tiles[50], None),
            (*k12, "R32 G2", grouped["R32 G2"], None),
            (*k12, "R128 G4 dead chunk", gd, dead_c),
            (*k12, "ET 50 G2", grouped["ET 50 G2"], None)]

    def case(kernel, kern, plain, tag, t, dead, xs, xd, H):
        if xs.device.type == "cuda":
            n_units, _, per_unit = _geometry(t)
            out = _over_nan((H, n_units, per_unit), xs.device,
                            lambda: kern(t, xs, xd, H))
        else:
            out = kern(t, xs, xd, H)
        yield KernelCase(kernel, tag, name, _slots(out),
                         _slots(plain(t, xs, xd, H)),
                         scale=_slots(plain(t, xs.abs(), xd.abs(), H)))
        if dead is not None:
            what = "tile" if kernel == "sddmm_tiles" else "chunk"
            yield KernelCase(kernel, f"{tag}: dead {what} is 0", name,
                             out[:, dead], torch.zeros_like(out[:, dead]))

    rng = np.random.default_rng(seed)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for H, P in SDDMM_SHAPES:
            xs, xd = (torch.tensor(rng.standard_normal((n, H * P)), dtype=dt,
                                   device=device) for _ in range(2))
            for kernel, kern, plain, tag, t, dead in runs:
                yield from case(kernel, kern, plain, f"{tag} H={H} P={P}", t,
                                dead, xs, xd, H)
            if (H, P) in SDDMM_UNALIGNED:
                ua, ub = _unaligned(xs), _unaligned(xd)
                for kernel, kern, plain, tag, t, dead in runs:
                    if dead is not None:
                        yield from case(kernel, kern, plain,
                                        f"{tag} H={H} P={P} unaligned", t,
                                        dead, ua, ub, H)


PAIR_KERNELS = ("pair_agg",)
NEG_ROW = 300      # a receiver whose z the pair-agg cases push below 0
# PNA-4x3's aggregates in its op order
PNA_LAYOUT = (ir.MEAN, ir.MIN, ir.MAX, ir.STD)


def pair_layout_glue(tg, u, v, layout, *, sf=None, slope: float = 0.2):
    """K13's final layout (``pair_agg(..., layout=)``: (aggregates, count))
    and what the path before it computed from K13's moments in PyTorch:
    mean = sum / c, std = sqrt(relu(sq / c - mean^2) + STD_EPS), c =
    max(count, 1), concatenated in ``layout``'s order; then (layout,
    count, glue, moments' count, {reduce: glue's aggregate})."""
    import torch

    from ..ops import pairagg as PA

    kw = dict(sf=sf, slope=slope, want_min_sq=True)
    got, cnt = PA.pair_agg(tg, u, v, layout=layout, **kw)
    y_sum, y_max, c0, y_min, y_sq = PA.pair_agg(tg, u, v, **kw)
    c = c0.clamp(min=1.0)
    mean = y_sum / c
    parts = {ir.ADD: y_sum, ir.MEAN: mean, ir.MAX: y_max, ir.MIN: y_min,
             ir.STD: torch.sqrt(torch.relu(y_sq / c - mean * mean)
                                + ir.STD_EPS)}
    return got, cnt, torch.cat([parts[r] for r in layout], 1), c0, parts


def pair_layout_gaps(tg, u, v, layout, *, sf=None, slope: float = 0.2):
    """:func:`pair_layout_glue` compared: {"one_chunk": the rows of one
    chunk of K13's work list equal bit for bit, "exact": every count and
    the cut rows' min and max equal, "cut_err": the cut rows' worst error
    in the sum, mean or std over its bound, "cut_rows": how many rows are
    cut}.  A cut row's chunks meet by float32 atomics in an order that
    varies by run, so each of the two runs' sums of n terms lies within
    ``SUM_ORDER`` sqrt(n) 2^-24 of its terms' magnitudes (the rule of
    :func:`kernel_error`): with q the row's mean square (sq / c), the
    mean's terms weigh at most sqrt(q) and the sum's c sqrt(q), and std^2
    = q - mean^2 moves by at most three such shares of q, so the std by
    that over 2 std."""
    import torch

    from ..ops import pairagg as PA

    got, cnt, want, c0, parts = pair_layout_glue(tg, u, v, layout, sf=sf,
                                                 slope=slope)
    n, D = u.shape
    cut = torch.zeros(n, dtype=torch.bool, device=u.device)
    cut[PA.pair_work(tg, n).split_rows] = True
    c = c0[cut].clamp(min=1.0)
    share = 2 * SUM_ORDER * 2.0 ** -24 * c.sqrt()      # two runs' orders
    mean, std = parts[ir.MEAN][cut], parts[ir.STD][cut]
    q = (std * std - ir.STD_EPS).clamp(min=0.0) + mean * mean
    bound = {ir.ADD: share * c * q.sqrt(), ir.MEAN: share * q.sqrt(),
             ir.STD: 3 * share * q / (2 * std)}
    exact, err = torch.equal(cnt, c0), 0.0
    for i, r in enumerate(layout):
        a, b = got[cut, i * D:(i + 1) * D], want[cut, i * D:(i + 1) * D]
        if r in (ir.MIN, ir.MAX):
            exact = exact and torch.equal(a, b)
        elif a.numel():
            err = max(err, float(((a - b).abs()
                                  / bound[r].clamp(min=ROW_FLOOR)).max()))
    return {"one_chunk": torch.equal(got[~cut], want[~cut]), "exact": exact,
            "cut_err": err, "cut_rows": int(cut.sum())}


def pair_agg_kernel_cases(device, seed: int = 0) -> Iterator[KernelCase]:
    """K13 against its plain version on the edge-case graph's 128-wide
    tiling at ET 64, in float32 and bfloat16: sf none and leaky_relu, with
    and without the max, at D = 48, 41 (unaligned) and 300 (three passes of
    the kernel's 128 features), and the instantiation of PNA's four
    aggregators (min and sum of squares too) at D = 48, 41 and 300 with
    the first 8 features of u and v -0.0 (z is -0.0 there but in row
    ``NEG_ROW``).  The graph has empty rows, a hub row whose 200 copies
    of one pair span several tiles (ties in the max) and are
    cut into two chunks of K13's work list (``PAIR_CHUNK`` 128: its rows
    meet by atomics), and a dead tile whose slots look live (read from
    column block 0, as on the TPU); row ``NEG_ROW`` gets only negative z.  Sum, max and count are separate
    cases: the sum scaled by its row's sum of |term| (terms may cancel),
    the max and count by themselves.  The four-aggregator cases also hold
    K13's final layout (mean, min, max, std in PNA's order) to the
    PyTorch formulas over its moments (:func:`pair_layout_glue`)."""
    import torch

    from .. import graph as G
    from ..ops import pairagg as PA

    s, r, n, _ = edge_case_graph(seed=seed)
    hg = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    tg = _dead_tile(G.tile_graph(hg, block_rows=128, block_cols=128,
                                 tile_edges=64, unit_weight=True,
                                 device=device))
    work = PA.pair_work(tg, n)
    if HOT_PAIR[1] not in work.split_rows.tolist():
        raise AssertionError("fixture's hub row is no longer cut into chunks")
    rng = np.random.default_rng(seed)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for D, sf, want_max, minsq in (
                (48, None, True, False), (48, "leaky_relu", True, False),
                (41, "leaky_relu", True, False), (41, None, False, False),
                (300, "leaky_relu", True, False), (48, None, True, True),
                (41, "leaky_relu", True, True), (300, None, True, True)):
            u, v = (rng.standard_normal((n, D)).astype(np.float32)
                    for _ in range(2))
            if minsq:
                u[:, :8] = v[:, :8] = -0.0
            v[NEG_ROW] = -50.0 - np.abs(v[NEG_ROW])
            u, v = (torch.tensor(a, dtype=dt, device=device) for a in (u, v))
            kw = dict(sf=sf, want_max=want_max, want_min_sq=minsq)
            out = PA.pair_agg(tg, u, v, **kw)
            ref = PA._pair_agg_reference(tg, u, v, **kw)
            mag = PA._pair_agg_reference(tg, u, v, magnitude=True, **kw)[0]
            if not (float(ref[2][NEG_ROW, 0]) > 0 and (
                    not want_max or float(ref[1][NEG_ROW].max()) < 0)):
                raise AssertionError("fixture lost its all-negative row")
            tag = f"D={D} sf={sf}"
            yield KernelCase("pair_agg", f"sum {tag}", name, out[0], ref[0],
                             terms=ref[2][:, 0], scale=mag)
            if want_max:
                yield KernelCase("pair_agg", f"max {tag}", name, out[1],
                                 ref[1])
            elif out[1] is not None:
                raise AssertionError("want_max=False returned a max")
            yield KernelCase("pair_agg", f"count {tag}", name, out[2],
                             ref[2])
            if minsq:
                tag += " four"
                yield KernelCase("pair_agg", f"min {tag}", name, out[3],
                                 ref[3])
                # every term is a square: the sum is its own scale
                yield KernelCase("pair_agg", f"sum of squares {tag}", name,
                                 out[4], ref[4], terms=ref[2][:, 0],
                                 scale=ref[4])
                got, cnt, glue, c0, _ = pair_layout_glue(
                    tg, u, v, PNA_LAYOUT, sf=sf)
                yield KernelCase("pair_agg", f"final layout {tag}", name,
                                 torch.cat([got, cnt], 1),
                                 torch.cat([glue, c0], 1))


BWD_KERNELS = ("gat_bwd_tiles_dad", "gat_bwd_tiles_src", "gat_dense_bwd_dad",
               "gat_dense_bwd_src")


def bwd_side(rng: np.random.Generator, n: int, heads: int, dtype,
             device, a_s=None):
    """A side panel [n, 4H] float32 [a_s | a_d | 1/den | s2] of plausible
    magnitudes, rounded to ``dtype`` (what the tail kernels read)."""
    import torch
    a_s = rng.normal(size=(n, heads)) if a_s is None else a_s
    den = rng.uniform(0.5, 40.0, size=(n, heads))
    vals = np.concatenate([a_s, rng.normal(size=(n, heads)), 1.0 / den,
                           rng.normal(size=(n, heads))], axis=1)
    return torch.tensor(vals, dtype=dtype, device=device).float()


def bwd_runs(tg, tg_t, bg, bg_t, h, gbar, side, msrc):
    """{kernel: (kernel call, plain call, magnitude call, split)} of K5-K8
    on one forward / transposed pair of tail tilings and dense splits."""
    from ..ops import dense as D
    from ..ops import gat as A
    H = msrc.shape[1]
    # packed once, as the backward does for K5 and K6 together
    packed = A.pack_side(side) if side.is_cuda else None

    def tail(tgx, src):
        kern = A.gat_bwd_tiles_src if src else A.gat_bwd_tiles_dad
        return (lambda: kern(tgx, h, gbar, side, msrc, packed=packed),
                lambda: A._gat_bwd_tiles_reference(tgx, h, gbar, side, msrc,
                                                   src_mode=src),
                lambda: A._gat_bwd_tiles_reference(tgx, h, gbar, side, msrc,
                                                   src_mode=src,
                                                   magnitude=True),
                H if src else None)

    def dense(bgx, src):
        kern = D.gat_dense_bwd_src if src else D.gat_dense_bwd_dad
        return (lambda: kern(bgx, h, gbar, bgx.values, side, msrc),
                lambda: D._gat_dense_bwd_reference(bgx, h, gbar, bgx.values,
                                                   side, msrc, src_mode=src),
                lambda: D._gat_dense_bwd_reference(bgx, h, gbar, bgx.values,
                                                   side, msrc, src_mode=src,
                                                   magnitude=True),
                H if src else None)

    return {"gat_bwd_tiles_dad": tail(tg, False),
            "gat_bwd_tiles_src": tail(tg_t, True),
            "gat_dense_bwd_dad": dense(bg, False),
            "gat_dense_bwd_src": dense(bg_t, True)}


# (H, HD) of the backward cases: the two layers of GAT-2l (4 heads of 32,
# 1 of 41 -> 48 on the wgmma paths), the other head shapes of K7's and K8's
# wgmma paths (1 head of 128, 2 of 64, 2 of 32, 8 of 8) and 16 heads of 1
# (the dense walk; one feature a head in K6's walk)
BWD_SHAPES = ((4, 128), (1, 41), (1, 128), (2, 128), (2, 64), (8, 64), (16, 16))
# the shapes of the wgmma paths taken with values in h's dtype too
BWD_VALUE_SHAPES = ((4, 128), (1, 41), (1, 128), (2, 128), (8, 64))


def bwd_kernel_cases(device, seed: int = 0) -> Iterator[KernelCase]:
    """K5-K8 on the edge-case graph and its transpose, in float32 and
    bfloat16, at every head shape of ``BWD_SHAPES``: the hybrid split's
    tails (a merged slot of more than 127 copies, pad slots, a dead tile
    made by hand in each tiling) and 'cr' int8 count blocks with an
    unvisited row block, whose dense block holds the pair past the int8
    maximum at count 127; the gap row's sources sit past the shift-bound
    gap.  K7 and K8 also with block values in h's dtype (bf16 values on the
    wgmma paths) at ``BWD_VALUE_SHAPES``, and on :func:`seg_block_graph`
    (row blocks of 8, 9, 16 and 17 dense blocks: both sides of the run
    cuts), with the row stripes no dense block visits held to exact zeros.
    Checked against the plain versions, scaled by each output cell's sum
    of elementary-term magnitudes (the plain versions' ``magnitude``
    mode)."""
    import dataclasses

    import torch

    from .. import graph as G
    s, r, n, _ = edge_case_graph(seed=seed)
    hg = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    hg_t, _ = G.transpose_host_graph(hg)
    # min_nnz 100: the four community blocks go dense, the cross blocks
    # stay in the tails
    kw = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=100,
              unit_weight=True, values_dtype=np.int8, block_layout="cr",
              device=device)
    hy, hy_t = G.hybrid_graph(hg, **kw), G.hybrid_graph(hg_t, **kw)
    if float(hy.tiles.weight.float().max()) <= 1.0 or float(
            hy_t.tiles.weight.float().max()) <= 1.0:
        raise AssertionError("fixture lost its merged multi-edge slot")
    for d in (hy.dense, hy_t.dense):
        if int(d.values.max()) != 127:
            raise AssertionError("fixture lost its saturated dense cell")

    tg, tg_t = _dead_tile(hy.tiles, 0), _dead_tile(hy_t.tiles, 0)
    terms = {"gat_bwd_tiles_dad": row_terms(tg),
             "gat_bwd_tiles_src": row_terms(tg_t),
             "gat_dense_bwd_dad": row_terms(hy.dense)[:n],
             "gat_dense_bwd_src": row_terms(hy_t.dense)[:n]}
    rng = np.random.default_rng(seed)

    def inputs(nn, H, HD, dt):
        """(h, gbar, a_s, msrc): a_s with the gap row's sources pushed
        past the shift-bound gap."""
        h, gbar = (torch.tensor(rng.standard_normal((nn, HD)), dtype=dt,
                                device=device) for _ in range(2))
        a_s = gap_a_src(rng, nn, H)
        msrc = torch.tensor(a_s.max(0, keepdims=True), device=device)
        return h, gbar, a_s, msrc

    def stripes(kernel, case, name, bgx, out):
        """The output rows of the row blocks no dense block visits."""
        R = bgx.block_rows
        visited = torch.zeros(bgx.n_row_blocks, dtype=torch.bool,
                              device=device)
        visited[bgx.blk_rb.long()] = True
        stripe = out[~visited.repeat_interleave(R)[:out.shape[0]]]
        return KernelCase(kernel, f"{case}: unvisited stripes are 0", name,
                          stripe, torch.zeros_like(stripe))

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for H, HD in BWD_SHAPES:
            h, gbar, a_s, msrc = inputs(n, H, HD, dt)
            # the tail kernels read side values rounded to the compute
            # dtype, the dense kernels float32 ones
            for tail, side_dt in ((True, dt), (False, torch.float32)):
                side = bwd_side(rng, n, H, side_dt, device, a_s=a_s)
                runs = bwd_runs(tg, tg_t, hy.dense, hy_t.dense, h, gbar,
                                side, msrc)
                for k, (kern, plain, mag, split) in runs.items():
                    if k.startswith("gat_bwd_tiles") == tail:
                        yield KernelCase(k, f"H={H} HD={HD}", name, kern(),
                                         plain(), split, terms[k], mag())
        # K5 and K6 with h and gbar rows off their vector loads' alignment
        # (one element past an aligned start): the walk's one-feature-a-
        # lane path at D % 4 == 0
        for H, HD in ((4, 128), (1, 128)):
            h, gbar, a_s, msrc = inputs(n, H, HD, dt)
            h, gbar = (torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(
                n, HD) for x in (h, gbar))
            side = bwd_side(rng, n, H, dt, device, a_s=a_s)
            runs = bwd_runs(tg, tg_t, hy.dense, hy_t.dense, h, gbar, side,
                            msrc)
            for k in ("gat_bwd_tiles_dad", "gat_bwd_tiles_src"):
                kern, plain, mag, split = runs[k]
                yield KernelCase(k, f"rows off alignment H={H} HD={HD}",
                                 name, kern(), plain(), split, terms[k],
                                 mag())
        # K7 and K8: block values in h's dtype, and the run cuts
        seg_cr = dataclasses.replace(seg_block_graph(device, seed),
                                     values_layout="cr")
        cases = [(H, HD, "values in h's dtype", b, b.dense)
                 for H, HD in BWD_VALUE_SHAPES for b in (hy, hy_t)]
        cases += [(H, HD, f"blocks per row block {SEG_COUNTS}", None, seg_cr)
                  for H, HD in ((4, 128), (1, 41))]
        for H, HD, tag, hyb, bgx in cases:
            if hyb is not None:
                bgx = dataclasses.replace(bgx, values=bgx.values.to(dt))
            nn = n if hyb is not None else bgx.n_col_blocks * bgx.block_cols
            h, gbar, a_s, msrc = inputs(nn, H, HD, dt)
            side = bwd_side(rng, nn, H, torch.float32, device, a_s=a_s)
            runs = bwd_runs(tg, tg_t, bgx, bgx, h, gbar, side, msrc)
            kinds = (("gat_dense_bwd_src",) if hyb is hy_t else
                     ("gat_dense_bwd_dad",) if hyb is hy else
                     ("gat_dense_bwd_dad", "gat_dense_bwd_src"))
            for k in kinds:
                kern, plain, mag, split = runs[k]
                out = kern()
                case = f"{tag} H={H} HD={HD}"
                yield KernelCase(k, case, name, out, plain(), split,
                                 row_terms(bgx)[:nn], mag())
                yield stripes(k, case, name, bgx, out)


LAYER_KERNELS = ("gat_layer", "gat_dense_panel")
SFS = ("identity", "relu", "elu", "leaky_relu")
CLAMP_ROW = HOT_PAIR[1]    # K14 cases: its logits pushed above the clamp
KNOB = 100.0               # a_d of head 0 moved per unit of the knob feature


def layer_inputs(rng: np.random.Generator, n: int, F: int, HD: int, H: int,
                 knobs: Optional[Dict[int, float]] = None):
    """(x [n, F], w [F, HD], wa_src, wa_dst [HD, H]) float32 numpy inputs of
    K14 with logits of order 1.  The last feature is a knob: w's last row
    is KNOB wa_d[:, 0] / |wa_d[:, 0]|², so a node whose knob value is t
    (``knobs``, else 0) has its a_d of head 0 moved by about KNOB t."""
    x = rng.standard_normal((n, F)).astype(np.float32)
    w = (rng.standard_normal((F, HD)) / np.sqrt(F)).astype(np.float32)
    wa_s, wa_d = ((rng.standard_normal((HD, H)) / np.sqrt(HD)).astype(
        np.float32) for _ in range(2))
    x[:, -1] = 0.0
    for node, t in (knobs or {}).items():
        x[node, -1] = t
    u = wa_d[:, 0]
    w[-1] = KNOB * u / float(u @ u)
    return x, w, wa_s, wa_d


def gat_layer_checks(tg, x, w, wa_src, wa_dst, *, dtype_name: str, case: str,
                     negative_slope: float = 0.2, final_sf: str = "identity",
                     terms=None) -> Iterator[KernelCase]:
    """K14 against its plain version, stage by stage, on CUDA tensors (on
    the CPU both sides are the plain version):

    - the projection's hq, and its a_s | a_d from the kernel's own hq,
      each scaled by its sum of |term| (a dot may cancel);
    - the walk and epilogue against the plain walk from the kernel's
      projection, row by row;
    - in float32 also the whole layer against the whole plain version.

    The last two are scaled by twice each cell's sum of |term| (the walk
    over |hq|, no activation): a row averages values of both signs, so its
    sum cancels, and on a hub row of 2e5 terms the float32 sum-order error
    of the average runs above 1e-5 of |out|.  The output is a quotient of
    two sums, num and den, and each carries its own sum-order error e:
    |d(num / den)| <= e sum(alpha |hq|) + e |out| <= 2 e sum(alpha |hq|).
    Every activation has slope at most 1, so it shrinks an error.

    In bfloat16 the whole layer is held stage by stage because a_s and a_d
    round to bf16 before the exp: a last-bit difference in a sum's order
    can flip one of them by a bf16 ulp, which moves the logit of every edge
    that reads it by 2^-8 of |a|, more than a bf16 rounding of one term."""
    import torch

    from ..ops import gat as A
    dt, H = x.dtype, wa_src.shape[1]
    cuda = x.device.type == "cuda"
    hq, a_s, a_d = (A.gat_layer_projection if cuda
                    else A._gat_layer_project_plain)(x, w, wa_src, wa_dst)
    yield KernelCase("gat_layer", f"projection hq {case}", dtype_name, hq,
                     A._gat_layer_project_plain(x, w, wa_src, wa_dst)[0],
                     scale=x.float().abs() @ w.float().abs())
    wv = torch.cat([wa_src, wa_dst], dim=1).to(dt).float()
    yield KernelCase("gat_layer", f"projection a_s|a_d {case}", dtype_name,
                     torch.cat([a_s.float(), a_d], dim=1),
                     (hq.float() @ wv).to(dt).float(), split=H,
                     scale=hq.float().abs() @ wv.abs())
    kw = dict(negative_slope=negative_slope, final_sf=final_sf)
    out = A.gat_layer_tiles(tg, x, w, wa_src, wa_dst, **kw)
    mag = 2.0 * A._gat_layer_walk_plain(tg, hq.abs(), a_s, a_d,
                                        negative_slope=negative_slope)
    yield KernelCase("gat_layer", f"walk+epilogue {case}", dtype_name, out,
                     A._gat_layer_walk_plain(tg, hq, a_s, a_d, **kw),
                     terms=terms, scale=mag)
    if dt == torch.float32:
        yield KernelCase("gat_layer", f"whole layer {case}", dtype_name, out,
                         A._gat_layer_plain(tg, x, w, wa_src, wa_dst, **kw),
                         terms=terms, scale=mag)


# K15's head shapes (H, HD) beyond the two layers': the rest of the wgmma
# path's widths N (2 heads of 32 and 4 of 16: N = 32; 8 of 8: N = 8; 2 of
# 64: N = 64; 1 of 128: N = 128)
PANEL_SHAPES = ((2, 64), (4, 64), (8, 64), (2, 128), (1, 128))


def layer_kernel_cases(device, seed: int = 0) -> Iterator[KernelCase]:
    """K14 and K15 against their plain versions on the edge-case graph, in
    float32 and bfloat16.  K14 (:func:`gat_layer_checks`): the whole graph
    at 128-wide blocks, ET 128 (pad slots, the hot pair's 200 slots, empty
    rows 512-598, a dead tile whose slots look live), every final
    activation, 4 heads of 32 (F = 43) and 1 head of 41 (F = 64); row
    CLAMP_ROW's logits pushed above the clamp SHIFT + 60 and the gap row's
    below the exp's underflow (knob feature); and 1 head of 41 at F = 70,
    so that the bf16 projection meets every way it stages x rows (by 2, 4
    and 16 bytes: F = 43, 70, 64) and n = 600 rows, not a multiple of its
    128.  K15: the
    'cr' int8 split with an unvisited row block, 4 heads of 32 and 1 of 41,
    the gap row's sources past the shift-bound gap, from
    :func:`~..ops.dense.exp_panels`; then every other width of the bf16
    wgmma path (``PANEL_SHAPES``) on that split, on values of h's dtype,
    and on :func:`seg_block_graph`'s 'cr' blocks, whose row blocks of 17
    dense blocks take two wide-segment runs."""
    import dataclasses

    import torch

    from .. import graph as G
    from ..ops import dense as D

    s, r, n, _ = edge_case_graph(seed=seed)
    hg = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    tg = _dead_tile(G.tile_graph(hg, block_rows=128, block_cols=128,
                                 tile_edges=128, unit_weight=True,
                                 device=device))
    terms = row_terms(tg)
    split = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=64,
                 unit_weight=True, block_layout="cr", device=device)
    bd = G.hybrid_graph(hg, values_dtype=np.int8, **split).dense
    bd_v = G.hybrid_graph(hg, **split).dense
    seg_cr = dataclasses.replace(seg_block_graph(device, seed),
                                 values_layout="cr")
    rng = np.random.default_rng(seed)

    def panel_case(tag, bg, H, HD, dt, name, gap=True):
        nb = max(bg.n_col_blocks * bg.block_cols, n)
        h = torch.tensor(rng.standard_normal((nb, HD)), dtype=dt,
                         device=device)
        a_s = torch.tensor(gap_a_src(rng, nb, H) if gap else
                           rng.standard_normal((nb, H)).astype(np.float32),
                           device=device)
        a_d = torch.tensor(rng.standard_normal((nb, H)), dtype=dt,
                           device=device).float()
        pan_s, pan_d = D.exp_panels(
            a_s, a_d, a_s.amax(0, keepdim=True),
            bg.n_col_blocks * bg.block_cols, bg.n_row_blocks * bg.block_rows)
        v = bg.values if bg.values.dtype == torch.int8 else bg.values.to(dt)
        return KernelCase(
            "gat_dense_panel", f"{tag} H={H} HD={HD}", name,
            D.gat_dense_panel_blocks(bg, h, v, a_s, pan_s, pan_d),
            D._gat_dense_panel_reference(bg, h, v, a_s, pan_s, pan_d), HD)

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for H, HD, F in ((4, 128, 43), (1, 41, 64), (1, 41, 70)):
            arrays = layer_inputs(rng, n, F, HD, H,
                                  knobs={CLAMP_ROW: 2.0, GAP_ROW: -6.0})
            x, w, wa_s, wa_d = (torch.tensor(a, device=device).to(dt)
                                for a in arrays)
            for sf in (SFS if F != 70 else ("elu",)):
                yield from gat_layer_checks(
                    tg, x, w, wa_s, wa_d, dtype_name=name, terms=terms,
                    case=f"H={H} HD={HD} F={F} sf={sf}", final_sf=sf)
            if F != 70:
                yield panel_case("int8 cr", bd, H, HD, dt, name)
        for H, HD in PANEL_SHAPES:
            yield panel_case("int8 cr", bd, H, HD, dt, name)
        for H, HD in PANEL_SHAPES + ((4, 128), (1, 41)):
            yield panel_case(f"{name} values cr", bd_v, H, HD, dt, name,
                             gap=False)
            yield panel_case(f"blocks per row block {SEG_COUNTS} cr", seg_cr,
                             H, HD, dt, name, gap=False)


CLASS_KERNELS = ("spmm_tiles", "gat_tiles", "sddmm_tiles")
# the class cases' capacities at 64-wide blocks: 32 takes the scattered
# runs of at most 32 edges, 128 runs of 33-128, 512 runs of 129-512 (the
# community blocks, the heavy run); 2048 would take runs of 513-2048, and
# there are none: a class without a part
CLASSES = (32, 128, 512, 2048)
HEAVY_RUN = 480           # edges planted into one 64 x 64 block
MEDIUM_RUN = 100          # edges planted into a block of the sparse rows


def class_tilings(device, seed: int = 0) -> Dict[str, Any]:
    """name -> MultiTiledGraph, the tilings K1, K3 and K11 are checked on
    per class: the edge-case graph plus a heavy run of ``HEAVY_RUN`` edges
    in one 64 x 64 block and a run of ``MEDIUM_RUN`` into the sparse rows,
    at 64-wide blocks and ``CLASSES``, with
    symmetric-norm weights (K1) and unit weights (the GAT tiling, bf16
    slot weights; the merged copies of the hot pair are no tail here, so
    its run is a heavy one of ``HOT_COPIES``); and an edge-less graph,
    whose one part has no edge (every row reads 0).  Raises unless the
    weighted tiling has a part for each of 32, 128 and 512 and none for
    2048."""
    from .. import graph as G
    s, r, n, _ = edge_case_graph(seed=seed)
    rng = np.random.default_rng(seed + 7)
    s = np.concatenate([s, 64 + rng.integers(0, 64, HEAVY_RUN),
                        rng.integers(0, 64, MEDIUM_RUN)])
    r = np.concatenate([r, 192 + rng.integers(0, 64, HEAVY_RUN),
                        512 + rng.integers(0, 64, MEDIUM_RUN)])
    geo = dict(block_rows=64, block_cols=64, tile_classes=CLASSES,
               device=device)
    hg = G.build_host_graph(s, r, n, symmetric_norm=True,
                            edge_pad_multiple=128)
    hg_u = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    empty = G.build_host_graph(np.zeros(0, np.int32), np.zeros(0, np.int32),
                               n, edge_pad_multiple=128)
    tilings = {
        "weighted classes": G.tile_graph_classes(hg, **geo),
        "unit classes": G.tile_graph_classes(hg_u, unit_weight=True, **geo),
        "edge-less": G.tile_graph_classes(empty, **geo),
    }
    got = [p.tile_edges for p in tilings["weighted classes"].parts]
    if got != [32, 128, 512]:
        raise AssertionError(f"class fixture parts {got} != [32, 128, 512]")
    return tilings


def class_kernel_cases(device, seed: int = 0) -> Iterator[KernelCase]:
    """K1, K3 and K11 on every part of :func:`class_tilings`, in float32
    and bfloat16, against their plain versions, and the classes' sums
    (``spmm``, ``_gat_forward``) against the plain versions summed: K1 at
    F = 41 and 128, K3 at 4 heads of 32 and 1 of 41 in both forms of a_s
    (the float32 per-node array of the hybrid path and derive mode) over
    the unit classes under one shift bound, K11 at 4 heads of 32 and 2 of
    41 (its two walks); on the card K11's outputs lie over NaN."""
    import torch

    from ..ops import gat as A
    from ..ops import sddmm as SD
    from ..ops import spmm as SP

    tilings = class_tilings(device, seed)
    rng = np.random.default_rng(seed)
    K = KernelCase
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for tag, m in tilings.items():
            n = m.n_node
            for F in (41, 128):
                x = torch.tensor(rng.standard_normal((n, F)), dtype=dt,
                                 device=device)
                for p in m.parts:
                    yield K("spmm_tiles", f"{tag} ET={p.tile_edges} F={F}",
                            name, SP.spmm_tiles(p, x, p.weight),
                            SP._spmm_reference(p, x), terms=row_terms(p))
                yield K("spmm_tiles", f"{tag} summed F={F}", name,
                        SP.spmm(m, x), SP._spmm_reference(m, x))
            for H, P in ((4, 32), (2, 41)):
                xs, xd = (torch.tensor(rng.standard_normal((n, H * P)),
                                       dtype=dt, device=device)
                          for _ in range(2))
                for p in m.parts:
                    if xs.device.type == "cuda":
                        out = _over_nan((H, p.n_tiles, p.tile_edges),
                                        xs.device,
                                        lambda: SD.sddmm_tiles(p, xs, xd, H))
                    else:
                        out = SD.sddmm_tiles(p, xs, xd, H)
                    yield K("sddmm_tiles",
                            f"{tag} ET={p.tile_edges} H={H} P={P}", name,
                            _slots(out),
                            _slots(SD._sddmm_reference(p, xs, xd, H)),
                            scale=_slots(SD._sddmm_reference(
                                p, xs.abs(), xd.abs(), H)))
            if tag == "weighted classes":
                continue
            for H, HD in ((4, 128), (1, 41)):
                h = torch.tensor(rng.standard_normal((n, HD)), dtype=dt,
                                 device=device)
                w = torch.tensor(rng.standard_normal((HD, H)) / np.sqrt(HD),
                                 dtype=dt, device=device)
                a_s = h.float() @ w.float()
                a_d = torch.tensor(rng.standard_normal((n, H)),
                                   dtype=torch.float32, device=device)
                ms = a_s.amax(0, keepdim=True)
                for form, kw in (("a_s f32", dict(a_src=a_s)),
                                 ("derive", dict(w_asrc=w))):
                    refs = []
                    for p in m.parts:
                        ref = A._gat_tiles_reference(
                            p, h, p.weight, a_d, ms, normalize=False, **kw)
                        refs.append(ref)
                        yield K("gat_tiles", f"{form} {tag} ET="
                                f"{p.tile_edges} H={H} HD={HD}", name,
                                A.gat_tiles(p, h, p.weight, a_d, ms,
                                            normalize=False, **kw), ref, HD)
                    fkw = dict(a_s=a_s) if "a_src" in kw else dict(w_asrc=w)
                    yield K("gat_tiles", f"{form} {tag} summed H={H} "
                            f"HD={HD}", name,
                            A._gat_forward(m, h, None, a_d, normalize=False,
                                           msrc=ms, **fkw),
                            sum(refs), HD)


def zipf_features(n: int, n_feat: int, density: float = 0.0127,
                  seed: int = 0) -> np.ndarray:
    """A seeded bag-of-words X [n, n_feat] float32 of 0/1 at about
    ``density``: each draw picks a node uniformly and a word from a Zipf
    law of exponent 1 over the words (word k with weight 1 / (k + 1)),
    duplicates merged, so frequent words fill dense column blocks and rare
    ones stay sparse."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_feat + 1)
    draws = int(round(n * n_feat * density))
    docs = rng.integers(0, n, draws)
    words = rng.choice(n_feat, size=draws, p=p / p.sum())
    x = np.zeros((n, n_feat), np.float32)
    x[docs, words] = 1.0
    return x


def sinput_kernel_cases(device, seed: int = 0) -> Iterator[KernelCase]:
    """K1 and K2 on the feature graph of a Zipf bag-of-words X (600 nodes,
    300 words, 64-wide blocks: the frequent words' blocks go dense) in
    both directions of ``sinput_mm``, float32 and bfloat16, against their
    plain versions: the forward with W [300, 41] and the backward with ḡ
    [600, 41], each in the square space of max(N, F_in) rows."""
    import torch

    from ..ops import dense as D
    from ..ops import sinput as SI
    from ..ops import spmm as SP

    x = zipf_features(N_NODE, 300, seed=seed)
    fg = SI.feature_graph(x, block=64, tile_edges=64, device=device)
    if fg.fwd.dense is None or fg.bwd.dense is None:
        raise AssertionError("the sparse-input fixture lost its dense blocks")
    rng = np.random.default_rng(seed)
    nsq = max(fg.n_node, fg.n_feat)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for tag, hyb in (("forward", fg.fwd), ("backward", fg.bwd)):
            v = torch.tensor(rng.standard_normal((nsq, 41)), dtype=dt,
                             device=device)
            tg, bg = hyb.tiles, hyb.dense
            yield KernelCase("spmm_tiles", f"sinput {tag} tail", name,
                             SP.spmm_tiles(tg, v, tg.weight),
                             SP._spmm_reference(tg, v))
            vals = bg.values.to(dt)
            yield KernelCase("spmm_dense_blocks", f"sinput {tag} blocks",
                             name, D.spmm_dense_blocks(bg, v, vals),
                             D._spmm_dense_reference(bg, v, vals))
