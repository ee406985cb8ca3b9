"""Fused GAT attention over edge tiles, and its tile-domain backward.

Counterpart of the JAX package's ``ops/gat.py``.  The backward kernels
are K5 ``csrc/gat_bwd_tiles_dad.cu`` and K6 ``csrc/gat_bwd_tiles_src.cu``
(replacing ``_gat_bwd_dad_kernel(_tt)`` and ``_gat_bwd_dsrc_kernel(_tt)``)
behind :func:`_gat_bwd_fused`.  The forward kernel is K3
``csrc/gat_tiles.cu``, the Hopper replacement of the TPU kernels
``_gat_kernel_t`` and ``_gat_kernel``: per destination row it accumulates
the softmax numerator and denominator of the edge attention under the
shift bound ``b[r] = leaky(msrc + a_dst[r])``, where ``msrc`` is the global
per-head max of a_src (softmax is shift-invariant and leaky_relu monotone,
so ``exp(e - b) <= 1``: no overflow and no rescaling).

Bound domain: a row whose incident sources all sit more than ~85 below the
global max underflows to zero attention.  The kernels reproduce this so that
the tile and dense partials add exactly; :func:`gat_shift_gap` measures the
gap and ``SHIFT_GAP_SAFE`` is the guard level.

The tile weight stream is the per-edge softmax-term multiplicity (1 per
plain edge, the copy count for merged multi-edges, 0 on padding).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as tF

from .. import ir
from ..graph import GraphTensor, TiledGraph
from . import _ext
from .spmm import _PLAIN_CHUNK

NEG = -1e30


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, slope * v)


def _gat_tiles_reference(tg: TiledGraph, h: torch.Tensor, mult: torch.Tensor,
                         a_dst: torch.Tensor, msrc: torch.Tensor, *,
                         w_asrc: Optional[torch.Tensor] = None,
                         a_src: Optional[torch.Tensor] = None,
                         negative_slope: float = 0.2,
                         normalize: bool = True) -> torch.Tensor:
    """Plain version of K3 over the same tile arrays and at the TPU
    kernel's rounding points: p*hs and p round to h's dtype before the f32
    sums.  Derive mode (``w_asrc`` [HD, H] in h's dtype) forms a_s = hs @
    w_asrc in f32; values mode reads ``a_src`` [N, H] in h's dtype."""
    H = a_dst.shape[1]
    HD = h.shape[1]
    D = HD // H
    R, C, ET = tg.block_rows, tg.block_cols, tg.tile_edges
    acc = torch.zeros((tg.n_row_blocks * R, HD + H), dtype=torch.float32,
                      device=h.device)
    ms = msrc.float().reshape(1, H)
    ad_all = a_dst.float()
    wf = w_asrc.float() if w_asrc is not None else None
    step = max(1, _PLAIN_CHUNK // max(ET * (HD + H), 1))
    for t0 in range(0, tg.n_tiles, step):
        t1 = t0 + step
        cb = tg.tile_cb[t0:t1].long()[:, None]
        rb = tg.tile_rb[t0:t1].long()[:, None]
        sl = tg.src_local[t0:t1].long()
        dl = tg.dst_local[t0:t1].long()
        valid = (cb >= 0) & (sl < C) & (dl < R)
        src = (cb * C + sl)[valid]
        dst = (rb * R + dl)[valid]
        m = mult[t0:t1].float()[valid][:, None]
        hs = h.index_select(0, src).float()
        a_s = hs @ wf if wf is not None else a_src.index_select(0, src).float()
        a_d = ad_all.index_select(0, dst)
        z = (_leaky(a_s + a_d, negative_slope)
             - _leaky(ms + a_d, negative_slope))
        p = torch.exp(torch.clamp(z, max=60.0)) * m
        v = torch.cat([p.repeat_interleave(D, dim=1) * hs, p], dim=1)
        if h.dtype != torch.float32:
            v = v.to(h.dtype).float()
        acc.index_add_(0, dst, v)
    acc = acc[: tg.n_node]
    if normalize:
        den = torch.clamp(acc[:, HD:], min=1e-20).repeat_interleave(D, dim=1)
        return acc[:, :HD] / den
    return acc


def gat_tiles(tg: TiledGraph, h: torch.Tensor, mult: torch.Tensor,
              a_dst: torch.Tensor, msrc: torch.Tensor, *,
              w_asrc: Optional[torch.Tensor] = None,
              a_src: Optional[torch.Tensor] = None,
              negative_slope: float = 0.2,
              normalize: bool = True) -> torch.Tensor:
    """K3 wrapper: [n_node, HD] normalized, or raw [n_node, HD + H]
    [num | den].  Exactly one of ``w_asrc`` (derive mode) and ``a_src``
    (values mode), both in h's dtype.  ``a_dst`` [N, H] and ``msrc`` [1, H]
    are float32.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if (w_asrc is None) == (a_src is None):
        raise ValueError("give exactly one of w_asrc and a_src")
    if h.device.type == "cpu":
        return _gat_tiles_reference(tg, h, mult, a_dst, msrc, w_asrc=w_asrc,
                                    a_src=a_src, negative_slope=negative_slope,
                                    normalize=normalize)
    dev = h.device
    H = a_dst.shape[1]
    HD = h.shape[1]
    dts = (torch.float32, torch.bfloat16)
    _ext.require(h, "h", dev, dts, 2)
    _ext.require(mult, "mult", dev, dts, 2)
    _ext.require(a_dst, "a_dst", dev, (torch.float32,), 2)
    _ext.require(msrc, "msrc", dev, (torch.float32,), 2)
    side = w_asrc if w_asrc is not None else a_src
    _ext.require(side, "w_asrc" if w_asrc is not None else "a_src", dev,
                 (h.dtype,), 2)
    for name in ("src_local", "dst_local"):
        _ext.require(getattr(tg, name), name, dev, (torch.int16,), 2)
    for name in ("tile_rb", "tile_cb"):
        _ext.require(getattr(tg, name), name, dev, (torch.int32,), 1)
    if tuple(mult.shape) != (tg.n_tiles, tg.tile_edges):
        raise ValueError(f"mult shape {tuple(mult.shape)} != "
                         f"{(tg.n_tiles, tg.tile_edges)}")
    if HD % H or HD > 256 or H > 32:
        raise ValueError(f"K3 takes HD % H == 0, HD <= 256, H <= 32; got "
                         f"HD={HD}, H={H}")
    if tuple(msrc.shape) != (1, H):
        raise ValueError(f"msrc shape {tuple(msrc.shape)} != {(1, H)}")
    if w_asrc is not None and tuple(w_asrc.shape) != (HD, H):
        raise ValueError(f"w_asrc shape {tuple(w_asrc.shape)} != {(HD, H)}")
    # raw [num | den]: the kernel adds into it with atomics, so rows without
    # edges stay 0; a second launch normalizes into ``out``
    acc = torch.zeros((tg.n_node, HD + H), dtype=torch.float32, device=dev)
    out = (torch.empty((tg.n_node, HD), dtype=torch.float32, device=dev)
           if normalize else None)
    if tg.n_tiles == 0 or tg.n_node == 0:
        return acc[:, :HD].clone() if normalize else acc
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_gat_tiles(
            tg.tile_rb.data_ptr(), tg.tile_cb.data_ptr(),
            tg.src_local.data_ptr(), tg.dst_local.data_ptr(),
            mult.data_ptr(), _ext.DTYPE_CODE[mult.dtype],
            h.data_ptr(), _ext.DTYPE_CODE[h.dtype],
            w_asrc.data_ptr() if w_asrc is not None else None,
            a_src.data_ptr() if a_src is not None else None,
            a_dst.data_ptr(), msrc.data_ptr(), acc.data_ptr(),
            out.data_ptr() if normalize else None,
            tg.n_tiles, tg.block_rows, tg.block_cols, tg.tile_edges,
            HD, H, h.shape[0], a_dst.shape[0], tg.n_node,
            float(negative_slope), _ext.stream(h))
    _ext.check(rc, "gat_tiles")
    gat_tiles.launches += 1
    return out if normalize else acc


gat_tiles.launches = 0


def _gat_forward(
    tg: TiledGraph,
    h_src: torch.Tensor,
    a_src: Optional[torch.Tensor],
    a_dst: torch.Tensor,
    *,
    w_asrc: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    normalize: bool = True,
    msrc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Edge-tile attention: [N, HD] normalized or raw [N, HD + H].

    ``w_asrc`` [HD, H] instead of ``a_src`` when a_src is a linear map of h:
    the kernel derives a_s from the gathered rows ("derive" mode).  ``msrc``
    [1, H]: the shift bound; hybrid callers pass theirs so that every
    partial shares it."""
    H = a_dst.shape[1]
    HD = h_src.shape[1]
    if HD % H:
        raise ValueError(f"HD={HD} is not a multiple of H={H}")
    dt = h_src.dtype
    if w_asrc is not None:
        w_k = w_asrc.to(dt)
        if msrc is None:
            msrc = (h_src.float() @ w_k.float()).amax(0, keepdim=True)
        kw = dict(w_asrc=w_k.contiguous())
    else:
        if msrc is None:
            msrc = a_src.float().amax(0, keepdim=True)
        kw = dict(a_src=a_src.to(dt).contiguous())
    return gat_tiles(tg, h_src.contiguous(), tg.weight,
                     a_dst.float().contiguous(),
                     msrc.float().reshape(1, H).contiguous(),
                     negative_slope=negative_slope, normalize=normalize, **kw)


# ---------------------------------------------------------------------------
# tile-domain backward (K5, K6)
#
# Per head, with alpha the forward's weight of edge s -> d recomputed from
# the saved combined denominator (alpha = p * mult / den[d], p under the
# forward's shift bound):
#   te = <gbar_d, h_s>,  dz = alpha (te - s2[d]) leaky'(a_s[s] + a_d[d])
#   dad[d] += dz                  K5 over the forward tiling (rows = dst)
#   das[s] += dz, dh[s] += alpha gbar_d   K6 over the transposed tiling
# ``side`` [N, 4H] float32 packs [a_s | a_d | 1/den | s2] per node.
# ---------------------------------------------------------------------------


def _bwd_side(side: torch.Tensor, idx: torch.Tensor, H: int, part: int):
    return side.index_select(0, idx)[:, part * H:(part + 1) * H]


def _edge_grad(a_s, a_d, rden, s2, ms, mult, te, slope):
    """alpha and dz of a batch of edges [e, H], float32, in the kernels'
    order of operations."""
    lraw = a_s + a_d
    p = torch.exp(torch.clamp(_leaky(lraw, slope) - _leaky(ms + a_d, slope),
                              max=60.0))
    alpha = p * mult * rden
    dz = alpha * (te - s2) * torch.where(lraw >= 0, 1.0, slope)
    return alpha, dz


def _gat_bwd_tiles_reference(tg: TiledGraph, h: torch.Tensor,
                             gbar: torch.Tensor, side: torch.Tensor,
                             msrc: torch.Tensor, *, src_mode: bool,
                             negative_slope: float = 0.2,
                             magnitude: bool = False) -> torch.Tensor:
    """Plain version of K5 (``src_mode=False``: dad [n, H] over the forward
    tiling) and K6 (``src_mode=True``: [das | dh] [n, H + HD] over the
    transposed tiling, whose rows are the original senders), at the TPU
    kernels' rounding points: the values scattered round to h's dtype
    before the f32 sums (the side values arrive already rounded).
    ``magnitude`` sums the magnitudes of the elementary terms instead
    (alpha |leaky'| (sum |g h| + |s2|) for dz, |alpha g| for dh): the scale
    of a check, since these sums cancel (a softmax gradient sums to zero
    over a row's edges, and te - s2 may cancel too)."""
    H = msrc.shape[1]
    HD = h.shape[1]
    D = HD // H
    R, C, ET = tg.block_rows, tg.block_cols, tg.tile_edges
    out = torch.zeros((tg.n_row_blocks * R, H + (HD if src_mode else 0)),
                      dtype=torch.float32, device=h.device)
    ms = msrc.float().reshape(1, H)
    step = max(1, _PLAIN_CHUNK // max(ET * (2 * HD + 8 * H), 1))
    for t0 in range(0, tg.n_tiles, step):
        t1 = t0 + step
        cb = tg.tile_cb[t0:t1].long()[:, None]
        rb = tg.tile_rb[t0:t1].long()[:, None]
        sl = tg.src_local[t0:t1].long()
        dl = tg.dst_local[t0:t1].long()
        valid = (cb >= 0) & (sl < C) & (dl < R)
        row = (rb * R + dl)[valid]
        col = (cb * C + sl)[valid]
        s, d = (row, col) if src_mode else (col, row)
        gd = gbar.index_select(0, d).float()
        hs = h.index_select(0, s).float()
        s2 = _bwd_side(side, d, H, 3)
        if magnitude:
            gd, hs, s2 = gd.abs(), hs.abs(), -s2.abs()
        te = (hs * gd).view(-1, H, D).sum(-1)
        alpha, dz = _edge_grad(
            _bwd_side(side, s, H, 0), _bwd_side(side, d, H, 1),
            _bwd_side(side, d, H, 2), s2, ms,
            tg.weight[t0:t1].float()[valid][:, None], te, negative_slope)
        v = (torch.cat([dz, alpha.repeat_interleave(D, dim=1) * gd], dim=1)
             if src_mode else dz)
        if h.dtype != torch.float32:
            v = v.to(h.dtype).float()
        out.index_add_(0, row, v.abs() if magnitude else v)
    return out[: tg.n_node]


def _require_bwd(h, gbar, side, msrc, dev):
    H = msrc.shape[1]
    HD = h.shape[1]
    _ext.require(h, "h", dev, (torch.float32, torch.bfloat16), 2)
    _ext.require(gbar, "gbar", dev, (h.dtype,), 2)
    _ext.require(side, "side", dev, (torch.float32,), 2)
    _ext.require(msrc, "msrc", dev, (torch.float32,), 2)
    if HD % H or HD > 256 or H > 32:
        raise ValueError(f"the backward kernels take HD % H == 0, HD <= 256, "
                         f"H <= 32; got HD={HD}, H={H}")
    if (tuple(gbar.shape) != tuple(h.shape)
            or tuple(side.shape) != (h.shape[0], 4 * H)
            or tuple(msrc.shape) != (1, H)):
        raise ValueError(f"inconsistent shapes: h {tuple(h.shape)}, gbar "
                         f"{tuple(gbar.shape)}, side {tuple(side.shape)}, "
                         f"msrc {tuple(msrc.shape)}")


def _gat_bwd_tiles(tg: TiledGraph, h, gbar, side, msrc, negative_slope,
                   src_mode: bool, entry: str) -> torch.Tensor:
    dev = h.device
    _require_bwd(h, gbar, side, msrc, dev)
    _ext.require(tg.weight, "weight", dev, (torch.float32, torch.bfloat16), 2)
    for name in ("src_local", "dst_local"):
        _ext.require(getattr(tg, name), name, dev, (torch.int16,), 2)
    for name in ("tile_rb", "tile_cb"):
        _ext.require(getattr(tg, name), name, dev, (torch.int32,), 1)
    H = msrc.shape[1]
    HD = h.shape[1]
    # the kernel adds into a zeroed buffer with atomics
    out = torch.zeros((tg.n_node, H + (HD if src_mode else 0)),
                      dtype=torch.float32, device=dev)
    if tg.n_tiles == 0 or tg.n_node == 0:
        return out
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            tg.tile_rb.data_ptr(), tg.tile_cb.data_ptr(),
            tg.src_local.data_ptr(), tg.dst_local.data_ptr(),
            tg.weight.data_ptr(), _ext.DTYPE_CODE[tg.weight.dtype],
            h.data_ptr(), gbar.data_ptr(), _ext.DTYPE_CODE[h.dtype],
            side.data_ptr(), msrc.data_ptr(), out.data_ptr(), tg.n_tiles,
            tg.block_rows, tg.block_cols, tg.tile_edges, HD, H,
            min(h.shape[0], tg.n_node), float(negative_slope),
            _ext.stream(h))
    _ext.check(rc, entry)
    return out


def gat_bwd_tiles_dad(tg: TiledGraph, h: torch.Tensor, gbar: torch.Tensor,
                      side: torch.Tensor, msrc: torch.Tensor, *,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """K5 wrapper: dad [n, H] float32 over the forward tail tiling.  ``h``
    and ``gbar`` [N, HD] share a dtype; ``side`` [N, 4H] float32 is
    [a_s | a_d | 1/den | s2]; ``msrc`` [1, H] is the forward's shift bound.
    CPU tensors take the plain version; CUDA tensors launch or raise."""
    if h.device.type == "cpu":
        return _gat_bwd_tiles_reference(tg, h, gbar, side, msrc,
                                        src_mode=False,
                                        negative_slope=negative_slope)
    out = _gat_bwd_tiles(tg, h, gbar, side, msrc, negative_slope, False,
                         "gta_gat_bwd_tiles_dad")
    gat_bwd_tiles_dad.launches += 1
    return out


gat_bwd_tiles_dad.launches = 0


def gat_bwd_tiles_src(tg_t: TiledGraph, h: torch.Tensor, gbar: torch.Tensor,
                      side: torch.Tensor, msrc: torch.Tensor, *,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """K6 wrapper: [das | dh] [n, H + HD] float32 over the TRANSPOSED tail
    tiling (its rows are the original senders); arguments as
    :func:`gat_bwd_tiles_dad`.  CPU tensors take the plain version; CUDA
    tensors launch or raise."""
    if h.device.type == "cpu":
        return _gat_bwd_tiles_reference(tg_t, h, gbar, side, msrc,
                                        src_mode=True,
                                        negative_slope=negative_slope)
    out = _gat_bwd_tiles(tg_t, h, gbar, side, msrc, negative_slope, True,
                         "gta_gat_bwd_tiles_src")
    gat_bwd_tiles_src.launches += 1
    return out


gat_bwd_tiles_src.launches = 0


def bwd_node_terms(gbar: torch.Tensor, out: torch.Tensor,
                   den: torch.Tensor) -> tuple:
    """(s2, 1/den) [N, H] float32: s2 = <gbar, out> per head, the softmax
    backward's row term, and the reciprocal of the combined denominator."""
    n, H = den.shape
    D = gbar.shape[1] // H
    s2 = (gbar.float().view(n, H, D) * out.float().view(n, H, D)).sum(-1)
    return s2, 1.0 / torch.clamp(den.float(), min=1e-20)


def _gat_bwd_fused(tg: TiledGraph, tg_t: TiledGraph, h: torch.Tensor,
                   a_s: torch.Tensor, a_d: torch.Tensor, den: torch.Tensor,
                   out: torch.Tensor, gbar: torch.Tensor, slope: float,
                   a_s_bound: Optional[torch.Tensor] = None):
    """Tile-domain GAT attention backward: (dh, das, dad) of the tail
    edges, no [E]-shaped intermediate.  ``den`` [N, H] is the forward's
    (combined) raw denominator, ``out`` its normalized output; the shift
    bound is the per-head max of ``a_s`` (or of ``a_s_bound``, the a_src
    the forward bounded with).  As on the TPU, h, gbar, a_s, a_d, 1/den
    and s2 enter the kernels rounded to h's dtype."""
    H = a_d.shape[1]
    dt = h.dtype
    s2, rden = bwd_node_terms(gbar, out, den)
    msrc = (a_s if a_s_bound is None else a_s_bound).float().amax(
        0, keepdim=True)
    side = torch.cat([v.to(dt).float() for v in (a_s, a_d, rden, s2)],
                     dim=1).contiguous()
    hc = h.contiguous()
    gc = gbar.to(dt).contiguous()
    dad = gat_bwd_tiles_dad(tg, hc, gc, side, msrc, negative_slope=slope)
    sd = gat_bwd_tiles_src(tg_t, hc, gc, side, msrc, negative_slope=slope)
    return sd[:, H:].to(dt), sd[:, :H].to(a_s.dtype), dad.to(a_d.dtype)


def _gat_reference(tg: TiledGraph, h_src, a_src, a_dst, negative_slope):
    """Segment formulation over the tile edge lists with the EXACT per-row
    max (the JAX package's differentiable twin): it ignores multiplicity
    and has no shift-bound domain, so it equals the kernels only on
    unit-weight tilings inside that domain."""
    n = tg.n_node
    H = a_src.shape[1]
    HD = h_src.shape[1]
    D = HD // H
    R, C, ET = tg.block_rows, tg.block_cols, tg.tile_edges
    sl = tg.src_local.reshape(-1).long()
    dl = tg.dst_local.reshape(-1).long()
    src = sl + tg.tile_cb.long().repeat_interleave(ET) * C
    dst = dl + tg.tile_rb.long().repeat_interleave(ET) * R
    valid = (dl < R) & (sl < C)
    src = torch.where(valid, src, n)
    dst = torch.where(valid, dst, n)
    dev = h_src.device
    f32 = torch.float32
    hs = torch.cat([h_src.float(), torch.zeros(1, HD, dtype=f32, device=dev)]
                   )[src]
    asr = torch.cat([a_src.float(), torch.zeros(1, H, dtype=f32, device=dev)]
                    )[src]
    ads = torch.cat([a_dst.float(), torch.zeros(1, H, dtype=f32, device=dev)]
                    )[dst]
    e = tF.leaky_relu(asr + ads, negative_slope)
    e = torch.where(valid[:, None], e, torch.full_like(e, NEG))
    m = torch.full((n + 1, H), float("-inf"), dtype=f32, device=dev)
    m = m.scatter_reduce_(0, dst[:, None].expand_as(e), e, "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(valid[:, None], torch.exp(e - m[dst]), torch.zeros_like(e))
    den = torch.zeros((n + 1, H), dtype=f32, device=dev).index_add_(0, dst, p)
    num = torch.zeros((n + 1, HD), dtype=f32, device=dev).index_add_(
        0, dst, p.repeat_interleave(D, dim=1) * hs)
    out = num / torch.clamp(den, min=1e-20).repeat_interleave(D, dim=1)
    return out[:n]


# rows whose incident a_src all sit further than this below the global
# per-head max would lose f32-exp precision under the shift bound
SHIFT_GAP_SAFE = 60.0


def gat_shift_gap(g: GraphTensor, a_src: torch.Tensor) -> torch.Tensor:
    """Worst-case shift-bound gap: scalar max over rows and heads of
    (global max a_src - per-row max incident a_src); rows without in-edges
    are excluded."""
    n = g.n_node
    src = torch.where(g.edge_mask, g.senders, n)
    dst = torch.where(g.edge_mask, g.receivers, n)
    a = a_src.float()
    pad = torch.full((1, a.shape[1]), NEG, dtype=a.dtype, device=a.device)
    a_se = torch.cat([a, pad]).index_select(0, src)
    a_se = torch.where(g.edge_mask[:, None], a_se, torch.full_like(a_se, NEG))
    rowmax = torch.full((n + 1, a.shape[1]), NEG, dtype=a.dtype,
                        device=a.device)
    rowmax = rowmax.scatter_reduce_(0, dst[:, None].expand_as(a_se), a_se,
                                    "amax")[:n]
    msrc = a.amax(0)
    gap = torch.where(rowmax > NEG / 2, msrc[None, :] - rowmax,
                      torch.zeros_like(rowmax))
    return gap.max()


def gat_attention(
    tg: TiledGraph,
    h_src: torch.Tensor,
    a_src: Optional[torch.Tensor] = None,
    a_dst: Optional[torch.Tensor] = None,
    heads: int = 1,
    negative_slope: float = 0.2,
    w_asrc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused multi-head GAT edge-softmax + aggregation, [N, HD] float32
    (forward only: its backward ``_gat_vjp`` is ROADMAP.md Queue 1 item
    5; the hybrid path's backward runs :func:`_gat_bwd_fused`).  Pass
    ``w_asrc`` [HD, H] instead of ``a_src`` when a_src is a linear map of
    h."""
    return _gat_forward(tg, h_src, None if w_asrc is not None else a_src,
                        a_dst, w_asrc=w_asrc, negative_slope=negative_slope)


# ---------------------------------------------------------------------------
# block matchers for the schedule lowerer (pure IR, as in the JAX package)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GatLayerPlan:
    x_op: int                # external input feeding the projection MM
    w_name: str
    was_name: str
    wad_name: str
    out_op: int              # the final activation op (block output)
    heads: int
    negative_slope: float
    final_sf: str
    ops: frozenset


def match_gat_layer(graph: ir.OpGraph, block: Sequence[int]):
    """Match an ENTIRE GAT layer: projection MM + attention-vector MMs +
    the attention chain + final apply_node SF, covering the block exactly.
    Lowered by the whole-layer mega-kernel (gat_layer)."""
    chain = find_gat_chain(graph, block)
    if chain is None:
        return None
    B = {o: graph.by_id[o] for o in block}
    h_id, as_id, ad_id = chain.h_op, chain.asrc_op, chain.adst_op
    for oid in (h_id, as_id, ad_id):
        op = B.get(oid)
        if op is None or op.kind != ir.APPLY_NODE or op.compute != ir.MM:
            return None
    h_op, as_op, ad_op = B[h_id], B[as_id], B[ad_id]
    if as_op.inputs != [h_id] or ad_op.inputs != [h_id]:
        return None
    if len(h_op.inputs) != 1:
        return None
    # final activation consuming the chain output
    sf_ops = [o for o, op in B.items()
              if op.kind == ir.APPLY_NODE and op.compute == ir.SF
              and op.inputs == [chain.out_op]]
    if not sf_ops:
        return None
    sf_op = B[sf_ops[0]]
    sf_name = sf_op.extra.get("sf", "relu")
    if sf_name not in ("identity", "relu", "elu", "leaky_relu"):
        return None
    covered = chain.ops | {h_id, as_id, ad_id, sf_ops[0]}
    if covered != frozenset(block):
        return None
    return GatLayerPlan(
        x_op=h_op.inputs[0],
        w_name=h_op.extra["weight"][0],
        was_name=as_op.extra["weight"][0],
        wad_name=ad_op.extra["weight"][0],
        out_op=sf_ops[0],
        heads=chain.heads,
        negative_slope=chain.negative_slope,
        final_sf=sf_name,
        ops=covered,
    )


@dataclasses.dataclass
class GatPlan:
    h_op: int
    asrc_op: int
    adst_op: int
    out_op: int
    heads: int
    negative_slope: float
    ops: frozenset           # exact op ids covered by the fused kernel


def match_gat_block(graph: ir.OpGraph, block: Sequence[int]) -> Optional[GatPlan]:
    """Match the canonical GAT attention chain (either reference variant)
    within ``block``.  Returns a plan only if the matched chain covers the
    block exactly (no stray ops that the kernel would silently drop).

    Chain: scatter(C) h / scatter(C) a_src / scatter(R) a_dst ->
    ADD -> SF(leaky_relu) -> gather MAX -> scatter R -> SUB -> SF(exp) ->
    then either {gather ADD den, scatter R, DIV, MUL h, gather ADD} (the
    normalise-on-edges variant, genGraphOP.py:47-62) or
    {MUL h, gather ADD num, gather ADD den, apply_node DIV} ('trans')."""
    plan = find_gat_chain(graph, block)
    if plan is None or plan.ops != frozenset(block):
        return None
    return plan


def find_gat_chain(
    graph: ir.OpGraph,
    within: Optional[Sequence[int]] = None,
) -> Optional[GatPlan]:
    """Find a GAT attention chain among ``within`` (default: all ops)."""
    ids = list(within) if within is not None else [op.op_id for op in graph.ops]
    B = {o: graph.by_id[o] for o in ids}

    def find(pred):
        return [o for o, op in B.items() if pred(op)]

    adds = find(lambda op: op.kind == ir.APPLY_EDGE and op.compute == ir.ADD
                and len(op.inputs) == 2
                and all(i in B and B[i].kind == ir.SCATTER for i in op.inputs))
    for add in adds:
        s1, s2 = (B[i] for i in B[add].inputs)
        if {s1.order, s2.order} != {"R", "C"}:
            continue
        asrc_sc = s1 if s1.order == "C" else s2
        adst_sc = s1 if s1.order == "R" else s2
        sfs = find(lambda op: op.kind == ir.APPLY_EDGE and op.compute == ir.SF
                   and op.inputs == [add])
        if not sfs or B[sfs[0]].extra.get("sf") != "leaky_relu":
            continue
        lrelu = sfs[0]
        gmax = find(lambda op: op.kind == ir.GATHER and op.compute == ir.MAX
                    and op.inputs == [lrelu])
        if not gmax:
            continue
        mscat = find(lambda op: op.kind == ir.SCATTER and op.order == "R"
                     and op.inputs == gmax)
        if not mscat:
            continue
        subs = find(lambda op: op.kind == ir.APPLY_EDGE and op.compute == ir.SUB
                    and op.inputs == [lrelu, mscat[0]])
        if not subs:
            continue
        exps = find(lambda op: op.kind == ir.APPLY_EDGE and op.compute == ir.SF
                    and op.inputs == subs and op.extra.get("sf") == "exp")
        if not exps:
            continue
        expo = exps[0]
        h_cands = find(lambda op: op.kind == ir.SCATTER and op.order == "C"
                       and op.op_id != asrc_sc.op_id)
        for h_id in h_cands:
            h_sc = B[h_id]
            core = [asrc_sc.op_id, adst_sc.op_id, add, lrelu, gmax[0],
                    mscat[0], subs[0], expo, h_id]
            # variant A: den -> scatter -> DIV -> MUL h -> gather
            dens = find(lambda op: op.kind == ir.GATHER
                        and op.compute == ir.ADD and op.inputs == [expo])
            for den in dens:
                dscat = find(lambda op: op.kind == ir.SCATTER
                             and op.order == "R" and op.inputs == [den])
                if not dscat:
                    continue
                divs = find(lambda op: op.kind == ir.APPLY_EDGE
                            and op.compute == ir.DIV
                            and op.inputs == [expo, dscat[0]])
                if not divs:
                    continue
                muls = find(lambda op: op.kind == ir.APPLY_EDGE
                            and op.compute == ir.MUL
                            and sorted(op.inputs) == sorted([divs[0], h_id]))
                if not muls:
                    continue
                gsum = find(lambda op: op.kind == ir.GATHER
                            and op.compute == ir.ADD and op.inputs == muls)
                if gsum:
                    return GatPlan(
                        h_op=h_sc.inputs[0],
                        asrc_op=asrc_sc.inputs[0],
                        adst_op=adst_sc.inputs[0],
                        out_op=gsum[0],
                        heads=asrc_sc.out_width,
                        negative_slope=B[lrelu].extra.get(
                            "negative_slope", 0.2),
                        ops=frozenset(core + [den, dscat[0], divs[0],
                                              muls[0], gsum[0]]),
                    )
            # variant B: MUL h -> gather num; gather den; node DIV
            muls = find(lambda op: op.kind == ir.APPLY_EDGE
                        and op.compute == ir.MUL
                        and sorted(op.inputs) == sorted([expo, h_id]))
            if muls:
                gnum = find(lambda op: op.kind == ir.GATHER
                            and op.compute == ir.ADD and op.inputs == muls)
                gden = find(lambda op: op.kind == ir.GATHER
                            and op.compute == ir.ADD and op.inputs == [expo])
                if gnum and gden:
                    divs = find(lambda op: op.kind == ir.APPLY_NODE
                                and op.compute == ir.DIV
                                and op.inputs == [gnum[0], gden[0]])
                    if divs:
                        return GatPlan(
                            h_op=h_sc.inputs[0],
                            asrc_op=asrc_sc.inputs[0],
                            adst_op=adst_sc.inputs[0],
                            out_op=divs[0],
                            heads=asrc_sc.out_width,
                            negative_slope=B[lrelu].extra.get(
                                "negative_slope", 0.2),
                            ops=frozenset(core + [muls[0], gnum[0],
                                                  gden[0], divs[0]]),
                        )
    return None
