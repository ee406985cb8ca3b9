"""Fused pair-sum aggregation: the DGN / PNA edge chain in one pass,

    z_e  = sf(u[src_e] + v[dst_e])          sf: identity or leaky_relu
    outs = {reduce over e -> r of z_e : reduce in {ADD, MAX, MEAN, MIN, STD}}

without the [E, D] edge tensor of the per-op path.

Counterpart of the JAX package's ``ops/pairagg.py``.  K13
``csrc/pair_agg.cu`` (replacing the TPU kernel ``_pair_agg_kernel``) walks
a receiver-ordered work list of a :class:`~..graph.TiledGraph`'s counted
slots (:func:`pair_work`, built on the tiling's device at first use and
kept with the tiling) and returns each row's sum, max and count, and in
the instantiation PNA's four aggregators take (``want_min_sq``) also its
min and its sum of squares, from the same pass.  Given a ``layout``, that
instantiation finishes PNA's aggregates itself and writes the mean, max,
min and std as column slices of one [N, 4D] tensor, in the layout's order
(:func:`finish_moments` is the same arithmetic in PyTorch);
:func:`_pair_agg_reference` is its plain PyTorch version, and the wrapper
:func:`pair_agg` takes it for a tensor on the CPU and launches the kernel
for a CUDA tensor (or raises).  :func:`pair_aggregate` is
differentiable: its backward is autograd of the JAX package's float32
formulation over the tile edge lists (:func:`_pair_agg_twin`), as the JAX
custom VJP is; the JAX package has no backward kernel.

The matcher (:func:`match_pair_agg`, pure IR) collects linear combinations
of scatter terms: an apply_edge MM distributes over the gather ((XW)[s] =
X[s]W) and pair sums merge, so both PNA variants and DGN's two streams
reduce to one (u, v) pair.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from .. import ir
from ..graph import TiledGraph
from ..utils import spans
from . import _ext
from . import primitives as P
from .spmm import _live_slots, _unit_steps

# ---------------------------------------------------------------------------
# the kernel's function: K13 and its plain version
# ---------------------------------------------------------------------------


def _leaky(z: torch.Tensor, slope: float) -> torch.Tensor:
    # where(z >= 0): the JAX leaky_relu, whose gradient at 0 is 1
    return torch.where(z >= 0, z, slope * z)


def _kernel_slots(tg: TiledGraph, t0: int, t1: int, n: int):
    """(src, has_src, dst) of the slots of tiles [t0, t1) that K13 counts:
    every slot whose receiver is real (dst_local < R, row < n), a dead tile
    (cb < 0) reading column block 0 as the TPU kernel does; ``has_src`` is
    False for a pad sender, whose u row reads 0."""
    R, C = tg.block_rows, tg.block_cols
    sl = tg.src_local[t0:t1].long()
    dl = tg.dst_local[t0:t1].long()
    col = tg.tile_cb[t0:t1].long().clamp(min=0)[:, None] * C + sl
    row = tg.tile_rb[t0:t1].long()[:, None] * R + dl
    live = (dl < R) & (row < n)
    has = ((sl < C) & (col < n))[live]
    return torch.where(has, col[live], 0), has, row[live]


# slots a chunk of the work list holds at most: a hub row of ~2e5 slots
# spreads over the card in chunks, each a lane group's, and a row of more
# slots than this is cut (its chunks then meet in the outputs by atomics)
PAIR_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class PairWork:
    """K13's work list of a tiling at ``n`` rows: the slots that
    :func:`_kernel_slots` counts, sorted by receiver (a stable sort, so
    tile order holds within a row) and cut into chunks of at most
    ``PAIR_CHUNK`` slots of one receiver.  Every row 0..n-1 has at least
    one chunk (an empty row one empty chunk), in row order.

      slot_src:  int32[S]     sender of each slot, -1 for a pad sender
      chunk_ptr: int32[NC+1]  chunk c holds slots chunk_ptr[c]:chunk_ptr[c+1]
      chunk_row: int32[NC]    its receiver r, or ~r (= -r - 1) where r's
                              slots are cut into several chunks
      split_rows: int64[NS]   those receivers, ascending
    """

    slot_src: torch.Tensor
    chunk_ptr: torch.Tensor
    chunk_row: torch.Tensor
    split_rows: torch.Tensor

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_row.shape[0])


def _build_pair_work(tg: TiledGraph, n: int) -> PairWork:
    dev = tg.src_local.device
    parts = [_kernel_slots(tg, t0, t1, n) for t0, t1 in _unit_steps(tg, 8)]
    src = torch.cat([torch.where(has, s, -1) for s, has, _ in parts]
                    ) if parts else torch.zeros(0, dtype=torch.long,
                                                device=dev)
    dst = torch.cat([d for _, _, d in parts]) if parts else src.clone()
    if src.numel() >= 2 ** 31:
        raise ValueError(f"{src.numel()} counted slots: the work list "
                         "indexes them in int32")
    dst, order = torch.sort(dst, stable=True)
    cnt = torch.bincount(dst, minlength=n)[:n]
    nch = ((cnt + PAIR_CHUNK - 1) // PAIR_CHUNK).clamp(min=1)
    row = torch.repeat_interleave(torch.arange(n, device=dev), nch)
    first = torch.cumsum(nch, 0) - nch
    start = torch.cumsum(cnt, 0) - cnt
    j = torch.arange(row.numel(), device=dev) - first[row]
    ptr = torch.cat([start[row] + PAIR_CHUNK * j,
                     torch.full((1,), src.numel(), device=dev)])
    split = nch > 1
    return PairWork(
        slot_src=src[order].to(torch.int32),
        chunk_ptr=ptr.to(torch.int32),
        chunk_row=torch.where(split[row], -row - 1, row).to(torch.int32),
        split_rows=torch.nonzero(split).reshape(-1))


def pair_work(tg: TiledGraph, n: int) -> PairWork:
    """K13's work list of ``tg`` at ``n`` rows (u's), built on the
    tiling's device at first use and kept in ``tg.work_lists``."""
    key = ("pair_agg", n)
    if key not in tg.work_lists:
        tg.work_lists[key] = _build_pair_work(tg, n)
    return tg.work_lists[key]


def _pair_agg_reference(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor, *,
                        sf: Optional[str] = None, slope: float = 0.2,
                        want_max: bool = True, magnitude: bool = False,
                        want_min_sq: bool = False) -> tuple:
    """Plain version of K13: (sum [N, D] float32, max [N, D] float32 or
    None without ``want_max``, count [N, 1] float32), and with
    ``want_min_sq`` also (min [N, D], sum of squares [N, D]), both float32.
    U = u[src] and V = v[dst] in u's dtype, z = sf(U + V) in float32; the
    sum adds z rounded to u's dtype, the max and min are of z rounded to
    u's dtype, the sum of squares adds the squares of the rounded z, rows
    without a slot give 0.  ``magnitude``: the sum adds |rounded z| instead
    (the scale of a row's sum for the kernel check, whose terms may
    cancel).  The sums accumulate in float64 and are rounded to float32
    once, so the kernel's float32 sums, in whatever order, are held to the
    exactly rounded sum.  Walks the tiles in chunks, so its temporaries
    stay small on large graphs."""
    n, D = u.shape
    dt = u.dtype
    v = v.to(dt)
    dev = u.device
    y_sum = torch.zeros((n, D), dtype=torch.float64, device=dev)
    y_max = (torch.full((n, D), float("-inf"), dtype=torch.float32,
                        device=dev) if want_max else None)
    y_min = y_sq = None
    if want_min_sq:
        y_min = torch.full((n, D), float("inf"), dtype=torch.float32,
                           device=dev)
        y_sq = torch.zeros((n, D), dtype=torch.float64, device=dev)
    cnt = torch.zeros(n, dtype=torch.float32, device=dev)
    for t0, t1 in _unit_steps(tg, 2 * D):
        src, has, dst = _kernel_slots(tg, t0, t1, n)
        z = (u.index_select(0, src).float() * has[:, None]
             + v.index_select(0, dst).float())
        if sf == "leaky_relu":
            z = _leaky(z, slope)
        zr = z.to(dt).float()
        y_sum.index_add_(0, dst, (zr.abs() if magnitude else zr).double())
        if want_max:
            y_max.scatter_reduce_(0, dst[:, None].expand_as(zr), zr, "amax")
        if want_min_sq:
            y_min.scatter_reduce_(0, dst[:, None].expand_as(zr), zr, "amin")
            y_sq.index_add_(0, dst, zr.double() ** 2)
        cnt += torch.bincount(dst, minlength=n).float()
    cnt = cnt[:, None]
    if want_max:
        y_max.masked_fill_(cnt == 0, 0.0)
    if not want_min_sq:
        return y_sum.float(), y_max, cnt
    return (y_sum.float(), y_max, cnt, y_min.masked_fill_(cnt == 0, 0.0),
            y_sq.float())


# the aggregates K13 finishes in its final layout, in the order of the
# columns it leaves to those a layout does not ask for
LAYOUT_REDUCES = (ir.MEAN, ir.MAX, ir.MIN, ir.STD)


def finish_moments(y_sum: torch.Tensor, y_max: Optional[torch.Tensor],
                   cnt: torch.Tensor, y_min: Optional[torch.Tensor],
                   y_sq: Optional[torch.Tensor],
                   layout: Sequence[str]) -> torch.Tensor:
    """The aggregates ``layout`` (distinct reduces of ``PAIR_REDUCES``) of a
    pair aggregation's moments, as adjacent column slices of one float32
    tensor in that order: the mean sum / c and the std
    ``primitives.std_from_moments(mean, sq / c)``, with c = max(count, 1).
    K13's final layout takes these operations in this order, each rounded
    on its own."""
    c = cnt.clamp(min=1.0)
    mean = y_sum / c
    got = {ir.ADD: y_sum, ir.MAX: y_max, ir.MEAN: mean, ir.MIN: y_min}
    if ir.STD in layout:
        got[ir.STD] = P.std_from_moments(mean, y_sq / c)
    return torch.cat([got[r] for r in layout], 1)


def pair_agg(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor, *,
             sf: Optional[str] = None, slope: float = 0.2,
             want_max: bool = True, want_min_sq: bool = False,
             layout: Optional[Sequence[str]] = None):
    """K13 wrapper: (sum, max or None, count[, min, sum of squares]) as
    :func:`_pair_agg_reference`.  u and v share a dtype (float32 or
    bfloat16) and a shape [N, D].  ``want_min_sq`` takes the instantiation
    of PNA's four aggregators, which computes the max too (it needs
    ``want_max``).  With ``layout`` (reduces of ``PAIR_REDUCES``; needs
    ``want_min_sq``) it returns (y, count) instead: y [N, len(layout) D]
    float32 holds :func:`finish_moments` of the moments, which K13 writes
    itself where the layout holds no ADD (y is then a view of an [N, 4D]
    tensor whose last columns hold the aggregates the layout left out).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if sf not in (None, "leaky_relu"):
        raise ValueError(f"pair aggregation takes sf None or leaky_relu, not "
                         f"{sf!r}")
    if want_min_sq and not want_max:
        raise ValueError("want_min_sq computes the max too: pass want_max")
    if layout is not None:
        if not want_min_sq:
            raise ValueError("a layout takes want_min_sq")
        if len(set(layout)) != len(layout) or not set(layout) <= set(
                PAIR_REDUCES):
            raise ValueError(f"a layout is distinct reduces of "
                             f"{PAIR_REDUCES}, not {list(layout)}")
    if u.device.type == "cpu" or (layout is not None and ir.ADD in layout):
        # K13's epilogue leaves no sum beside the mean: a layout with ADD
        # takes the moments and finishes them in PyTorch
        kw = dict(sf=sf, slope=slope, want_max=want_max,
                  want_min_sq=want_min_sq)
        out = (_pair_agg_reference(tg, u, v, **kw) if u.device.type == "cpu"
               else pair_agg(tg, u, v, **kw))
        return out if layout is None else (finish_moments(*out, layout),
                                           out[2])
    dev = u.device
    _ext.require(u, "u", dev, (torch.float32, torch.bfloat16), 2)
    _ext.require(v, "v", dev, (u.dtype,), 2)
    if v.shape != u.shape:
        raise ValueError(f"v {tuple(v.shape)} != u {tuple(u.shape)}")
    for k in ("src_local", "dst_local"):
        _ext.require(getattr(tg, k), k, dev, (torch.int16,), 2)
    for k in ("tile_rb", "tile_cb"):
        _ext.require(getattr(tg, k), k, dev, (torch.int32,), 1)
    n, D = u.shape
    work = pair_work(tg, n)
    # the kernel writes every row: a row of one chunk by plain stores, a
    # row cut into several by atomics, into its 0 (sum, sum of squares,
    # count), -inf (max) and +inf (min) set here
    def out():
        return torch.empty((n, D), dtype=torch.float32, device=dev)

    if layout is None:
        y_sum = out()
        y_max = out() if want_max else None
        y_min, y_sq = (out(), out()) if want_min_sq else (None, None)
        ld = D
    else:
        # the final layout: the sum's columns hold the mean, the sum of
        # squares' the std
        cols = [*layout, *(r for r in LAYOUT_REDUCES if r not in layout)]
        agg = torch.empty((n, 4 * D), dtype=torch.float32, device=dev)
        at = dict(zip(cols, agg.split(D, 1)))
        y_sum, y_max, y_min, y_sq = (at[r] for r in LAYOUT_REDUCES)
        ld = 4 * D
    cnt = torch.empty((n, 1), dtype=torch.float32, device=dev)
    if work.split_rows.numel():
        for y, fill in ((y_sum, 0.0), (cnt, 0.0), (y_max, float("-inf")),
                        (y_min, float("inf")), (y_sq, 0.0)):
            if y is not None:
                y.index_fill_(0, work.split_rows, fill)
    if work.n_chunks:
        lib = _ext.library()
        def ptr(y):
            return None if y is None else y.data_ptr()

        with torch.cuda.device(dev):
            rc = lib.gta_pair_agg(
                work.chunk_ptr.data_ptr(), work.chunk_row.data_ptr(),
                work.slot_src.data_ptr(), u.data_ptr(), v.data_ptr(),
                _ext.DTYPE_CODE[u.dtype], y_sum.data_ptr(), ptr(y_max),
                ptr(y_min), ptr(y_sq), cnt.data_ptr(), work.n_chunks, D, ld,
                int(sf == "leaky_relu"), slope, int(layout is not None),
                ir.STD_EPS, _ext.stream(u))
            _ext.check(rc, "pair_agg")
            pair_agg.launches += 1
            spans.count("pair_agg.k13", 1)
            if layout is not None:
                spans.count("pair_agg.layout", 1)
                cut = work.split_rows.numel()
                if cut:
                    # the cut rows' moments, gathered by atomics, into their
                    # mean and std
                    rc = lib.gta_pair_agg_finish(
                        work.split_rows.data_ptr(), cut, cnt.data_ptr(),
                        y_sum.data_ptr(), y_sq.data_ptr(), ld, D,
                        ir.STD_EPS, _ext.stream(u))
                    _ext.check(rc, "pair_agg_finish")
                    spans.count("pair_agg.cut_rows", cut)
    if layout is not None:
        return agg[:, : len(layout) * D], cnt
    if want_min_sq:
        return y_sum, y_max, cnt, y_min, y_sq
    return y_sum, y_max, cnt


pair_agg.launches = 0


def pair_aggregate_raw(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor, *,
                       sf: Optional[str] = None, slope: float = 0.2,
                       want_max: bool = True, want_min_sq: bool = False,
                       layout: Optional[Sequence[str]] = None):
    """(sum [N, D] float32, max [N, D] float32 with 0 on empty rows, count
    [N, 1] float32) on K13, and with ``want_min_sq`` also (min [N, D] with
    0 on empty rows, sum of squares [N, D]); v is cast to u's dtype.
    ``want_max=False`` skips the max and returns None in its place.  With
    ``layout``: (aggregates, count), as :func:`pair_agg`."""
    return pair_agg(tg, u.contiguous(), v.to(u.dtype).contiguous(), sf=sf,
                    slope=slope, want_max=want_max, want_min_sq=want_min_sq,
                    layout=layout)


def _pair_agg_twin(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor, *,
                   sf: Optional[str], slope: float, want_min_sq: bool = False):
    """The JAX package's float32 formulation over the tile edge lists
    (its ``_pair_agg_reference``): slots live when cb >= 0, src < C and
    dst < R; no rounding; (sum, max, count, min, sum of squares), the last
    two None without ``want_min_sq``.  Differentiable: a tie of the max or
    the min splits its gradient evenly, as JAX's ``segment_max`` does."""
    n, D = u.shape
    _, src, dst = _live_slots(tg, 0, tg.n_tiles)
    keep = dst < n
    src, dst = src[keep].clamp(max=n), dst[keep]
    # senders past the last node read a zero row, as in the JAX package
    up = torch.cat([u.float(), u.new_zeros((1, D), dtype=torch.float32)])
    z = up.index_select(0, src) + v.float().index_select(0, dst)
    if sf == "leaky_relu":
        z = _leaky(z, slope)
    idx = dst[:, None].expand_as(z)
    y_sum = z.new_zeros((n, D)).index_add(0, dst, z)
    y_max = z.new_full((n, D), float("-inf")).scatter_reduce(
        0, idx, z, "amax", include_self=True)
    cnt = torch.bincount(dst, minlength=n).float()[:, None]
    y_min = y_sq = None
    if want_min_sq:
        y_min = torch.where(cnt > 0, z.new_full((n, D), float("inf"))
                            .scatter_reduce(0, idx, z, "amin",
                                            include_self=True), 0.0)
        y_sq = z.new_zeros((n, D)).index_add(0, dst, z * z)
    return y_sum, torch.where(cnt > 0, y_max, 0.0), cnt, y_min, y_sq


class _PairAggregate(torch.autograd.Function):
    """Forward on K13; backward by autograd of :func:`_pair_agg_twin`
    (with a ``layout``, followed by :func:`finish_moments` at the forward's
    count).  Outputs: sum, max (with ``want_max``), count, and min and sum
    of squares (with ``want_min_sq``); with a ``layout``: the aggregates and
    the count."""

    @staticmethod
    def forward(ctx, u, v, tg, sf, slope, want_max, want_min_sq, layout):
        ctx.tg, ctx.sf, ctx.slope = tg, sf, slope
        ctx.want_max, ctx.want_min_sq, ctx.layout = (want_max, want_min_sq,
                                                     layout)
        out = pair_aggregate_raw(tg, u, v, sf=sf, slope=slope,
                                 want_max=want_max, want_min_sq=want_min_sq,
                                 layout=layout)
        cnt = out[-1] if layout is not None else out[2]
        ctx.save_for_backward(u, v, cnt)
        ctx.mark_non_differentiable(cnt)
        return tuple(t for t in out if t is not None)

    @staticmethod
    def backward(ctx, *grads):
        u, v, cnt = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(r) for t, r in zip((u, v), need)]
            y_sum, y_max, _, y_min, y_sq = _pair_agg_twin(
                ctx.tg, *ins, sf=ctx.sf, slope=ctx.slope,
                want_min_sq=ctx.want_min_sq)
            if ctx.layout is not None:
                outs = [finish_moments(y_sum, y_max, cnt, y_min, y_sq,
                                       ctx.layout)]
                gys = [grads[0].float()]
            else:
                outs = [y_sum] + ([y_max] if ctx.want_max else [])
                outs += [y_min, y_sq] if ctx.want_min_sq else []
                cnt_at = 2 if ctx.want_max else 1     # count has no gradient
                gys = [g.float() for i, g in enumerate(grads) if i != cnt_at]
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(outs, wrt, gys) if wrt else ())
        return (*(next(got) if r else None for r in need), None, None, None,
                None, None, None)


def pair_aggregate(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor, *,
                   sf: Optional[str] = None, slope: float = 0.2,
                   want_max: bool = True, want_min_sq: bool = False,
                   layout: Optional[Sequence[str]] = None):
    """Differentiable pair aggregation: (sum, max or None, count[, min, sum
    of squares]) as :func:`pair_aggregate_raw`, or with ``layout``
    (aggregates, count), with gradients in u and v.  The backward holds
    [live slots, D] float32 temporaries (fine at the sizes the JAX package
    trains these families at; not chunked)."""
    out = _PairAggregate.apply(u, v, tg, sf, slope, want_max, want_min_sq,
                               None if layout is None else tuple(layout))
    return out if want_max or layout is not None else (out[0], None,
                                                       *out[1:])


# ---------------------------------------------------------------------------
# matcher: linear pair-term collection over the edge chain (pure IR)
# ---------------------------------------------------------------------------


PAIR_REDUCES = (ir.ADD, ir.MAX, ir.MEAN, ir.MIN, ir.STD)


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

    @property
    def want_min_sq(self) -> bool:
        """MIN or STD asked for: K13's instantiation of PNA's four
        aggregators (min and sum of squares beside the sum and max)."""
        return bool({ir.MIN, ir.STD} & set(self.gathers))


def _collect_terms(graph: ir.OpGraph, oid: int, allow: set):
    """(cterms, rterms, ops) of the linear pair expression rooted at
    ``oid``, or None.  An apply_edge MM distributes over the scatter's
    gather: (scatter(x)) @ W == scatter(x @ W), recorded as (ref, w_name)."""
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
            return None           # one linear map deep is all it absorbs
        ct = [(r, wname) for r, _ in inner[0]]
        rt = [(r, wname) for r, _ in inner[1]]
        return ct, rt, inner[2] | {oid}
    return None


def match_pair_agg(graph: ir.OpGraph,
                   block: Sequence[int]) -> Optional[PairAggPlan]:
    """Match a block that is exactly: a linear pair expression, an optional
    leaky_relu, and gathers of distinct reduces {ADD, MAX, MEAN, MIN, STD}
    consuming it."""
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
        if op.order != "R" or op.compute not in PAIR_REDUCES:
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
    # internal values must not escape the block (only the gathers are
    # materialised)
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
