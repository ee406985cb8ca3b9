"""GATv2's attention (Brody, Alon and Yahav, arXiv:2105.14491) in one pass
over the receivers' incoming edges: per receiver i and head h,

    z_ij     = leaky_relu(u_j + v_i, slope)        H*C wide, in float32
    e_ij,h   = a_h . z_ij,h                        a: [H, C]
    alpha    = softmax over j of e_ij,h
    out_i,h  = sum_j alpha_ij,h u_j,h              [N, H*C] float32

without the [E, H*C] edge tensors of the per-op path.

K17 ``csrc/gatv2_attn.cu`` walks K13's receiver-ordered work list
(:func:`~.pairagg.pair_work`, kept with the tiling) chunk by chunk with an
online softmax per head (a running max, a running sum and a rescaled
accumulator); a row cut into several chunks leaves one partial (max, sum,
accumulator) a chunk in scratch rows (:class:`Gatv2Work`), which its
finishing kernel merges.  :func:`_gatv2_attn_reference` is its plain
version, and the wrapper :func:`gatv2_attn` takes it for a tensor on the
CPU and launches the kernel for a CUDA tensor (or raises).
:func:`gatv2_attention` is differentiable: its backward is autograd of
the plain per-edge float32 formulation over the tile edge lists
(:func:`_gatv2_twin`).  K17 replaces no TPU kernel: the JAX package has
no GATv2.

A slot of the work list whose sender is a pad (-1) is no edge and takes
no share of the softmax; a row without an edge gives 0.

The matcher (:func:`match_gatv2`, pure IR) finds the chain of the
``"GATv2"`` op graph (``models/builders.py``): the two scatters, their sum, the leaky, the
head dot, the segment max and its subtraction, the exponent, the
weighted message, the numerator and denominator gathers and their
division on nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import ir
from ..graph import TiledGraph
from ..utils import spans
from . import _ext
from . import primitives as P
from .pairagg import PairWork, _leaky, pair_work
from .spmm import _live_slots

# ---------------------------------------------------------------------------
# the work list's partial rows
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Gatv2Work:
    """K13's work list of a tiling (``pair``) with where K17 leaves the
    partials of the rows cut into several chunks: chunk c of a cut row
    writes partial row ``part_of[c]`` (-1 for a chunk of an uncut row),
    and cut row ``pair.split_rows[s]`` owns partial rows
    ``part_ptr[s]:part_ptr[s+1]`` (its chunks, in order).

      part_of:  int32[NC]
      part_ptr: int32[NS+1]
      n_parts:  the partial rows, NP = part_ptr[-1] (kept on the host, so
                that a launch reads no device value)
    """

    pair: PairWork
    part_of: torch.Tensor
    part_ptr: torch.Tensor
    n_parts: int


def _build_gatv2_work(tg: TiledGraph, n: int) -> Gatv2Work:
    pw = pair_work(tg, n)
    cut = pw.chunk_row < 0
    part_of = torch.where(cut, torch.cumsum(cut, 0) - 1, -1)
    rows = torch.bitwise_not(pw.chunk_row[cut])
    counts = (torch.unique_consecutive(rows, return_counts=True)[1]
              if rows.numel() else rows.new_zeros(0))
    ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return Gatv2Work(pair=pw, part_of=part_of.to(torch.int32),
                     part_ptr=ptr.to(torch.int32), n_parts=int(ptr[-1]))


def gatv2_work(tg: TiledGraph, n: int) -> Gatv2Work:
    """K17's work list of ``tg`` at ``n`` rows, built on the tiling's
    device at first use and kept in ``tg.work_lists``."""
    key = ("gatv2", n)
    if key not in tg.work_lists:
        tg.work_lists[key] = _build_gatv2_work(tg, n)
    return tg.work_lists[key]


# ---------------------------------------------------------------------------
# the kernel's function: K17 and its plain version
# ---------------------------------------------------------------------------

# slots whose [slots, H*C] float64 temporaries the plain version holds at
# once
_PLAIN_SLOTS = 1 << 21


def _gatv2_attn_reference(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor,
                          att: torch.Tensor, *, slope: float = 0.2,
                          magnitude: bool = False) -> torch.Tensor:
    """Plain version of K17: [N, H*C] float32.  u and v in u's dtype (v is
    cast), each slot's score in float64 from them and ``att``; each chunk
    of the work list reduces its slots to a partial (its max, its sum of
    exp(e - max) and its accumulator of exp(e - max) u_j), and each row
    merges its chunks' partials under the row's max, in float64, rounded
    to float32 once.  ``magnitude``: the accumulator adds alpha |u_j|
    instead (the scale of a row's error for the kernel check).  The
    scores [slots, H] are kept whole; the messages are made in blocks of
    slots."""
    n, HC = u.shape
    H, C = att.shape
    if H * C != HC:
        raise ValueError(f"att {tuple(att.shape)} does not split u's {HC} "
                         "features")
    v = v.to(u.dtype)
    dev = u.device
    work = pair_work(tg, n)
    src = work.slot_src.long()
    ptr = work.chunk_ptr.long()
    nc = work.n_chunks
    crow = work.chunk_row.long()
    row = torch.where(crow < 0, torch.bitwise_not(crow), crow)
    chunk_of = torch.repeat_interleave(torch.arange(nc, device=dev),
                                       ptr.diff())
    a64 = att.double()
    S = src.numel()
    blocks = [(a, min(a + _PLAIN_SLOTS // HC, S))
              for a in range(0, S, max(_PLAIN_SLOTS // HC, 1))]
    neg_inf = float("-inf")
    score = torch.empty((S, H), dtype=torch.float64, device=dev)
    for a, b in blocks:
        s = src[a:b]
        z = (u.index_select(0, s.clamp(min=0)).double()
             + v.index_select(0, row[chunk_of[a:b]]).double())
        sc = (_leaky(z, slope).view(-1, H, C) * a64).sum(-1)
        score[a:b] = sc.masked_fill_((s < 0)[:, None], neg_inf)
    pm = torch.full((nc, H), neg_inf, dtype=torch.float64, device=dev)
    pm.scatter_reduce_(0, chunk_of[:, None].expand(-1, H), score, "amax")
    pl = torch.zeros((nc, H), dtype=torch.float64, device=dev)
    pacc = torch.zeros((nc, HC), dtype=torch.float64, device=dev)
    for a, b in blocks:
        ch = chunk_of[a:b]
        sc = score[a:b]
        p = torch.where(torch.isfinite(sc), torch.exp(sc - pm[ch]), 0.0)
        uj = u.index_select(0, src[a:b].clamp(min=0)).double()
        pl.index_add_(0, ch, p)
        pacc.index_add_(0, ch, p.repeat_interleave(C, 1)
                        * (uj.abs() if magnitude else uj))
    top = torch.full((n, H), neg_inf, dtype=torch.float64, device=dev)
    top.scatter_reduce_(0, row[:, None].expand(-1, H), pm, "amax")
    w = torch.where(torch.isfinite(pm), torch.exp(pm - top[row]), 0.0)
    den = torch.zeros((n, H), dtype=torch.float64, device=dev).index_add_(
        0, row, pl * w)
    num = torch.zeros((n, HC), dtype=torch.float64, device=dev).index_add_(
        0, row, pacc * w.repeat_interleave(C, 1))
    den = den.repeat_interleave(C, 1)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       0.0).float()


def _kernel_vec(H: int, C: int) -> int:
    """Features a lane of K17 holds (1, 2 or 4), or raise where K17 does
    not take the shape: H*C up to 128 features, and with several heads
    each head's features on a power of two of lanes."""
    HC = H * C
    if HC > 128:
        raise ValueError(f"K17 takes up to 128 features a row, not {HC}")
    vec = 1 if HC <= 32 else 2 if HC <= 64 else 4
    if H > 1:
        g = C // vec
        if C % vec or g & (g - 1):
            raise ValueError(f"K17 takes {H} heads of {C} features only "
                             f"where {C} / {vec} is a power of two")
    return vec


def gatv2_attn(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor,
               att: torch.Tensor, *, slope: float = 0.2) -> torch.Tensor:
    """K17 wrapper: [N, H*C] float32 as :func:`_gatv2_attn_reference`.  u
    and v share a dtype (float32 or bfloat16) and a shape [N, H*C]; att is
    float32 [H, C].  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if u.device.type == "cpu":
        return _gatv2_attn_reference(tg, u, v, att, slope=slope)
    dev = u.device
    _ext.require(u, "u", dev, (torch.float32, torch.bfloat16), 2)
    _ext.require(v, "v", dev, (u.dtype,), 2)
    _ext.require(att, "att", dev, (torch.float32,), 2)
    if v.shape != u.shape:
        raise ValueError(f"v {tuple(v.shape)} != u {tuple(u.shape)}")
    n, HC = u.shape
    H, C = att.shape
    if H * C != HC:
        raise ValueError(f"att {tuple(att.shape)} does not split u's {HC} "
                         "features")
    _kernel_vec(H, C)
    work = gatv2_work(tg, n)
    pw = work.pair
    # every row is written: a row of one chunk by K17, a cut row by the
    # finishing kernel from its chunks' partials
    out = torch.empty((n, HC), dtype=torch.float32, device=dev)
    parts = max(work.n_parts, 1)
    pmax = torch.empty((parts, H), dtype=torch.float32, device=dev)
    psum = torch.empty((parts, H), dtype=torch.float32, device=dev)
    pacc = torch.empty((parts, HC), dtype=torch.float32, device=dev)
    if pw.n_chunks:
        lib = _ext.library()
        with torch.cuda.device(dev):
            rc = lib.gta_gatv2_attn(
                pw.chunk_ptr.data_ptr(), pw.chunk_row.data_ptr(),
                pw.slot_src.data_ptr(), work.part_of.data_ptr(),
                u.data_ptr(), v.data_ptr(), _ext.DTYPE_CODE[u.dtype],
                att.data_ptr(), out.data_ptr(), pmax.data_ptr(),
                psum.data_ptr(), pacc.data_ptr(), pw.n_chunks, H, C, slope,
                _ext.stream(u))
            _ext.check(rc, "gatv2_attn")
            gatv2_attn.launches += 1
            spans.count("gatv2.k17", 1)
            cut = pw.split_rows.numel()
            if cut:
                rc = lib.gta_gatv2_attn_finish(
                    pw.split_rows.data_ptr(), work.part_ptr.data_ptr(),
                    pmax.data_ptr(), psum.data_ptr(), pacc.data_ptr(),
                    out.data_ptr(), cut, H, C, _ext.stream(u))
                _ext.check(rc, "gatv2_attn_finish")
                spans.count("gatv2.cut_rows", cut)
    return out


gatv2_attn.launches = 0


def _gatv2_twin(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor,
                att: torch.Tensor, *, slope: float) -> torch.Tensor:
    """The per-edge float32 formulation over the tile edge lists (slots
    live when cb >= 0, src < C and dst < R; no rounding): the scores, the
    segment max, exp, the numerator and denominator gathers and their
    division, as the per-op path takes them.  Differentiable in u, v and
    att; the segment max is held constant, as a softmax allows."""
    n, HC = u.shape
    H, C = att.shape
    _, src, dst = _live_slots(tg, 0, tg.n_tiles)
    keep = (dst < n) & (src < n)
    src, dst = src[keep], dst[keep]
    uj = u.float().index_select(0, src)
    z = _leaky(uj + v.float().index_select(0, dst), slope)
    s = (z.view(-1, H, C) * att.float()).sum(-1)
    top = s.new_full((n, H), float("-inf")).scatter_reduce(
        0, dst[:, None].expand_as(s), s.detach(), "amax")
    p = P.exp_f64(s - top.index_select(0, dst))
    den = s.new_zeros((n, H)).index_add(0, dst, p)
    num = uj.new_zeros((n, HC)).index_add(0, dst,
                                          p.repeat_interleave(C, 1) * uj)
    den = den.repeat_interleave(C, 1)
    return num / torch.where(den > 0, den, 1.0)


class _Gatv2Attention(torch.autograd.Function):
    """Forward on K17; backward by autograd of :func:`_gatv2_twin`."""

    @staticmethod
    def forward(ctx, u, v, att, tg, slope):
        ctx.tg, ctx.slope = tg, slope
        ctx.save_for_backward(u, v, att)
        return gatv2_attn(tg, u.contiguous(), v.to(u.dtype).contiguous(),
                          att.float().contiguous(), slope=slope)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(r) for t, r in zip(saved, need)]
            out = _gatv2_twin(ctx.tg, *ins, slope=ctx.slope)
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, gy.float())
                       if wrt else ())
        return (*(next(got) if r else None for r in need), None, None)


def gatv2_attention(tg: TiledGraph, u: torch.Tensor, v: torch.Tensor,
                    att: torch.Tensor, *, slope: float = 0.2
                    ) -> torch.Tensor:
    """Differentiable GATv2 attention: [N, H*C] float32 as
    :func:`gatv2_attn`, with gradients in u, v and att.  The backward
    holds [live slots, H*C] float32 temporaries (fine at the sizes the
    CPU tests train at; not chunked)."""
    return _Gatv2Attention.apply(u, v, att, tg, slope)


# ---------------------------------------------------------------------------
# matcher: the GATv2 attention chain (pure IR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Gatv2Plan:
    """u = the value ``u_op`` (scattered by sender), v = ``v_op`` (by
    receiver), the attention vectors the parameter ``att`` [heads, width
    / heads]; ``out_op`` the node-level division the chain ends in."""
    u_op: int
    v_op: int
    att: str
    heads: int
    width: int
    slope: float
    ops: frozenset
    out_op: int


def _only(graph: ir.OpGraph, pred) -> Optional[ir.Op]:
    found = [op for op in graph.ops if pred(op)]
    return found[0] if len(found) == 1 else None


def _chain_at(graph: ir.OpGraph, hd: ir.Op) -> Optional[Gatv2Plan]:
    B = graph.by_id
    if hd.kind != ir.APPLY_EDGE or len(hd.inputs) != 1 or hd.inputs[0] < 0:
        return None
    lk = B[hd.inputs[0]]
    if (lk.kind != ir.APPLY_EDGE or lk.compute != ir.SF
            or lk.extra.get("sf") != "leaky_relu" or len(lk.inputs) != 1
            or lk.inputs[0] < 0):
        return None
    ad = B[lk.inputs[0]]
    if (ad.kind != ir.APPLY_EDGE or ad.compute != ir.ADD
            or len(ad.inputs) != 2 or min(ad.inputs) < 0):
        return None
    scs = [B[i] for i in ad.inputs]
    if any(s.kind != ir.SCATTER or s.compute != ir.NONE
           or len(s.inputs) != 1 for s in scs):
        return None
    if {s.order for s in scs} != {"C", "R"}:
        return None
    sc_c = next(s for s in scs if s.order == "C")
    sc_r = next(s for s in scs if s.order == "R")
    h = hd.op_id
    gm = _only(graph, lambda o: o.kind == ir.GATHER and o.compute == ir.MAX
               and o.order == "R" and o.inputs == [h])
    if gm is None:
        return None
    sm = _only(graph, lambda o: o.kind == ir.SCATTER and o.order == "R"
               and o.compute == ir.NONE and o.inputs == [gm.op_id])
    if sm is None:
        return None
    sb = _only(graph, lambda o: o.kind == ir.APPLY_EDGE
               and o.compute == ir.SUB and o.inputs == [h, sm.op_id])
    if sb is None:
        return None
    ex = _only(graph, lambda o: o.kind == ir.APPLY_EDGE and o.compute == ir.SF
               and o.extra.get("sf") == "exp" and o.inputs == [sb.op_id])
    if ex is None:
        return None
    mu = _only(graph, lambda o: o.kind == ir.APPLY_EDGE
               and o.compute == ir.MUL
               and sorted(o.inputs) == sorted([ex.op_id, sc_c.op_id]))
    if mu is None:
        return None
    gn = _only(graph, lambda o: o.kind == ir.GATHER and o.compute == ir.ADD
               and o.order == "R" and o.inputs == [mu.op_id])
    gd = _only(graph, lambda o: o.kind == ir.GATHER and o.compute == ir.ADD
               and o.order == "R" and o.inputs == [ex.op_id])
    if gn is None or gd is None:
        return None
    dv = _only(graph, lambda o: o.kind == ir.APPLY_NODE
               and o.compute == ir.DIV and o.inputs == [gn.op_id, gd.op_id])
    if dv is None:
        return None
    name, heads, c = hd.extra["weight"]
    width = sc_c.out_width
    if heads != hd.out_width or heads * c != width \
            or sc_r.out_width != width:
        return None
    ops = frozenset(o.op_id for o in (sc_c, sc_r, ad, lk, hd, gm, sm, sb,
                                      ex, mu, gn, gd, dv))
    # internal values must not escape the block (only the division is
    # materialised)
    internal = ops - {dv.op_id}
    if internal & set(graph.outputs):
        return None
    if any(i in internal and op.op_id not in ops
           for op in graph.ops for i in op.inputs):
        return None
    return Gatv2Plan(u_op=sc_c.inputs[0], v_op=sc_r.inputs[0], att=name,
                     heads=heads, width=width,
                     slope=lk.extra.get("negative_slope", 0.2), ops=ops,
                     out_op=dv.op_id)


def find_gatv2_chain(graph: ir.OpGraph) -> Optional[Gatv2Plan]:
    """The GATv2 attention chain of ``graph`` (the first HEAD_DOT's that
    matches), or None."""
    for op in graph.ops:
        if op.compute == ir.HEAD_DOT:
            plan = _chain_at(graph, op)
            if plan is not None:
                return plan
    return None


def match_gatv2(graph: ir.OpGraph, block) -> Optional[Gatv2Plan]:
    """The plan of a block that is exactly a GATv2 attention chain."""
    hds = [graph.by_id[o] for o in block
           if graph.by_id[o].compute == ir.HEAD_DOT]
    if len(hds) != 1:
        return None
    plan = _chain_at(graph, hds[0])
    return plan if plan is not None and plan.ops == set(block) else None
