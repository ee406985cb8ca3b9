"""Fused pair-sum aggregation: the DGN / PNA edge chain in one pass,

    z_e  = sf(u[src_e] + v[dst_e])          sf: identity or leaky_relu
    outs = {reduce over e -> r of z_e : reduce in {ADD, MAX, MEAN}}

without the [E, D] edge tensor of the per-op path.

Counterpart of the JAX package's ``ops/pairagg.py``.  K13
``csrc/pair_agg.cu`` (replacing the TPU kernel ``_pair_agg_kernel``) reads
a :class:`~..graph.TiledGraph` in place and returns each row's sum, max and
count; :func:`_pair_agg_reference` is its plain PyTorch version, and the
wrapper :func:`pair_agg` takes it for a tensor on the CPU and launches the
kernel for a CUDA tensor (or raises).  :func:`pair_aggregate` is
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
from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import ir
from ..graph import TiledGraph
from . import _ext
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


def _pair_agg_reference(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor, *,
                        sf: Optional[str] = None, slope: float = 0.2,
                        want_max: bool = True, magnitude: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                   torch.Tensor]:
    """Plain version of K13: (sum [N, D] float32, max [N, D] float32 or
    None without ``want_max``, count [N, 1] float32).  U = u[src] and V =
    v[dst] in u's dtype, z = sf(U + V) in float32; the sum adds z rounded to
    u's dtype, the max is of z rounded to u's dtype, rows without a slot
    give 0.  ``magnitude``: the sum adds |rounded z| instead (the scale of
    a row's sum for the kernel check, whose terms may cancel).  The sum
    accumulates in float64 and is rounded to float32 once, so the kernel's
    float32 sums, in whatever order, are held to the exactly rounded sum.
    Walks the tiles in chunks, so its temporaries stay small on large
    graphs."""
    n, D = u.shape
    dt = u.dtype
    v = v.to(dt)
    dev = u.device
    y_sum = torch.zeros((n, D), dtype=torch.float64, device=dev)
    y_max = (torch.full((n, D), float("-inf"), dtype=torch.float32,
                        device=dev) if want_max else None)
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
        cnt += torch.bincount(dst, minlength=n).float()
    cnt = cnt[:, None]
    if want_max:
        y_max.masked_fill_(cnt == 0, 0.0)
    return y_sum.float(), y_max, cnt


def pair_agg(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor, *,
             sf: Optional[str] = None, slope: float = 0.2,
             want_max: bool = True):
    """K13 wrapper: (sum, max or None, count) as :func:`_pair_agg_reference`.
    u and v share a dtype (float32 or bfloat16) and a shape [N, D].  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if sf not in (None, "leaky_relu"):
        raise ValueError(f"pair aggregation takes sf None or leaky_relu, not "
                         f"{sf!r}")
    if u.device.type == "cpu":
        return _pair_agg_reference(tg, u, v, sf=sf, slope=slope,
                                   want_max=want_max)
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
    # the kernel adds into zeroed sums and counts with atomics, and takes
    # the max over -inf; rows without a slot get max 0 below
    y_sum = torch.zeros((n, D), dtype=torch.float32, device=dev)
    y_max = (torch.full((n, D), float("-inf"), dtype=torch.float32,
                        device=dev) if want_max else None)
    cnt = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    if D and tg.n_tiles:
        lib = _ext.library()
        with torch.cuda.device(dev):
            rc = lib.gta_pair_agg(
                tg.tile_rb.data_ptr(), tg.tile_cb.data_ptr(),
                tg.src_local.data_ptr(), tg.dst_local.data_ptr(),
                u.data_ptr(), v.data_ptr(), _ext.DTYPE_CODE[u.dtype],
                y_sum.data_ptr(), None if y_max is None else y_max.data_ptr(),
                cnt.data_ptr(), tg.n_tiles, tg.block_rows, tg.block_cols,
                tg.tile_edges, D, n, int(sf == "leaky_relu"), slope,
                _ext.stream(u))
        _ext.check(rc, "pair_agg")
        pair_agg.launches += 1
    if want_max:
        y_max.masked_fill_(cnt == 0, 0.0)
    return y_sum, y_max, cnt


pair_agg.launches = 0


def pair_aggregate_raw(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor, *,
                       sf: Optional[str] = None, slope: float = 0.2,
                       want_max: bool = True):
    """(sum [N, D] float32, max [N, D] float32 with 0 on empty rows, count
    [N, 1] float32) on K13; v is cast to u's dtype.  ``want_max=False``
    skips the max and returns None in its place."""
    return pair_agg(tg, u.contiguous(), v.to(u.dtype).contiguous(), sf=sf,
                    slope=slope, want_max=want_max)


def _pair_agg_twin(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor, *,
                   sf: Optional[str], slope: float):
    """The JAX package's float32 formulation over the tile edge lists
    (its ``_pair_agg_reference``): slots live when cb >= 0, src < C and
    dst < R; no rounding; (sum, max, count).  Differentiable: a tie of the
    max splits its gradient evenly, as JAX's ``segment_max`` does."""
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
    return y_sum, torch.where(cnt > 0, y_max, 0.0), cnt


class _PairAggregate(torch.autograd.Function):
    """Forward on K13; backward by autograd of :func:`_pair_agg_twin`."""

    @staticmethod
    def forward(ctx, u, v, tg, sf, slope, want_max):
        ctx.tg, ctx.sf, ctx.slope, ctx.want_max = tg, sf, slope, want_max
        ctx.save_for_backward(u, v)
        y_sum, y_max, cnt = pair_aggregate_raw(tg, u, v, sf=sf, slope=slope,
                                               want_max=want_max)
        ctx.mark_non_differentiable(cnt)
        return (y_sum, y_max, cnt) if want_max else (y_sum, cnt)

    @staticmethod
    def backward(ctx, *grads):
        u, v = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(r) for t, r in zip((u, v), need)]
            y_sum, y_max, _ = _pair_agg_twin(ctx.tg, *ins, sf=ctx.sf,
                                             slope=ctx.slope)
            outs, gys = [y_sum], [grads[0].float()]
            if ctx.want_max:
                outs.append(y_max)
                gys.append(grads[1].float())
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(outs, wrt, gys) if wrt else ())
        return (*(next(got) if r else None for r in need), None, None, None,
                None)


def pair_aggregate(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor, *,
                   sf: Optional[str] = None, slope: float = 0.2,
                   want_max: bool = True):
    """Differentiable pair aggregation: (sum, max or None, count) as
    :func:`pair_aggregate_raw`, with gradients in u and v.  The backward
    holds [live slots, D] float32 temporaries (fine at the sizes the JAX
    package trains these families at; not chunked)."""
    out = _PairAggregate.apply(u, v, tg, sf, slope, want_max)
    return out if want_max else (out[0], None, out[1])


# ---------------------------------------------------------------------------
# matcher: linear pair-term collection over the edge chain (pure IR)
# ---------------------------------------------------------------------------


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
