"""Fused GAT attention over edge tiles, its tile-domain backward, and the
whole GAT layer.

Counterpart of the JAX package's ``ops/gat.py``.  K14 ``csrc/gat_layer.cu``
(replacing ``_gat_layer_kernel``) runs a whole layer behind
:func:`gat_layer_tiles` / :func:`gat_layer`.  The backward kernels
are K5 ``csrc/gat_bwd_tiles_dad.cu`` and K6 ``csrc/gat_bwd_tiles_src.cu``
(replacing ``_gat_bwd_dad_kernel(_tt)`` and ``_gat_bwd_dsrc_kernel(_tt)``)
behind :func:`_gat_bwd_fused`.  K10 ``csrc/gat_grouped.cu`` (replacing
``_gat_grouped_kernel_t``) computes the raw partials over a grouped tiling
behind :func:`gat_grouped`.  The forward kernel is K3
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

from .. import ir
from ..compiler.schedule import _gat_layer_smem, _gat_wgmma_width
from ..graph import (GraphTensor, GroupedTiledGraph, MultiTiledGraph,
                     TiledGraph)
from . import _ext
from .primitives import exp_f64
from .spmm import Tiling, _geometry, _live_slots, _require_slots, _unit_steps

NEG = -1e30
SHIFT = 12.0   # the whole-layer kernel's static softmax shift


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    # jax.nn.leaky_relu: its gradient at 0 is 1, not the slope
    return torch.where(v >= 0, v, slope * v)


def shift_bound_p(a_s: torch.Tensor, a_d: torch.Tensor, msrc: torch.Tensor,
                  slope: float) -> torch.Tensor:
    """An edge's softmax term under the global per-head shift bound,
    exp(min(leaky(a_s + a_d) - leaky(msrc + a_d), 60)): the ShiftBound
    logit of csrc/tile_walk.cuh (K3, K10, the backward kernels)."""
    return exp_f64(torch.clamp(_leaky(a_s + a_d, slope)
                               - _leaky(msrc + a_d, slope), max=60.0))


def static_shift_p(a_s: torch.Tensor, a_d: torch.Tensor,
                   slope: float) -> torch.Tensor:
    """An edge's softmax term under K14's static shift, exp(min(leaky(a_s +
    a_d), SHIFT + 60) - SHIFT): the StaticShift logit of
    csrc/tile_walk.cuh."""
    return exp_f64(torch.clamp(_leaky(a_s + a_d, slope), max=SHIFT + 60.0)
                   - SHIFT)


def _gat_tiles_reference(tg: Tiling, h: torch.Tensor, mult: torch.Tensor,
                         a_dst: torch.Tensor, msrc: torch.Tensor, *,
                         w_asrc: Optional[torch.Tensor] = None,
                         a_src: Optional[torch.Tensor] = None,
                         negative_slope: float = 0.2,
                         normalize: bool = True) -> torch.Tensor:
    """Plain version of K3 (and, over a grouped tiling, of K10) over the
    same tile arrays and at the TPU kernel's rounding points: p*hs and p
    round to h's dtype before the sums.  Derive mode (``w_asrc`` [HD,
    H] in h's dtype) forms a_s = hs @ w_asrc in f32; otherwise ``a_src``
    [N, H] is read as it is: float32 per-node logits (the hybrid path's) or
    the values mode's, in h's dtype.  The rounded terms are summed in
    float64 and rounded once to float32 (as K1's and K9's plain version): a
    multigraph row that repeats one term hundreds of times drifts by ~n/4
    ulps in a float32 sum of any order."""
    H = a_dst.shape[1]
    HD = h.shape[1]
    D = HD // H
    acc = torch.zeros((_geometry(tg)[1], HD + H), dtype=torch.float64,
                      device=h.device)
    ms = msrc.float().reshape(1, H)
    ad_all = a_dst.float()
    wf = w_asrc.float() if w_asrc is not None else None
    for t0, t1 in _unit_steps(tg, HD + H):
        valid, src, dst = _live_slots(tg, t0, t1)
        m = mult[t0:t1].float()[valid][:, None]
        hs = h.index_select(0, src).float()
        a_s = hs @ wf if wf is not None else a_src.index_select(0, src).float()
        a_d = ad_all.index_select(0, dst)
        p = shift_bound_p(a_s, a_d, ms, negative_slope) * m
        v = torch.cat([p.repeat_interleave(D, dim=1) * hs, p], dim=1)
        if h.dtype != torch.float32:
            v = v.to(h.dtype).float()
        acc.index_add_(0, dst, v.double())
    acc = acc[: tg.n_node].float()
    if normalize:
        den = torch.clamp(acc[:, HD:], min=1e-20).repeat_interleave(D, dim=1)
        return acc[:, :HD] / den
    return acc


def gat_tiles(tg: TiledGraph, h: torch.Tensor, mult: torch.Tensor,
              a_dst: torch.Tensor, msrc: torch.Tensor, *,
              w_asrc: Optional[torch.Tensor] = None,
              a_src: Optional[torch.Tensor] = None,
              negative_slope: float = 0.2,
              normalize: bool = True,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 wrapper: [n_node, HD] normalized, or raw [n_node, HD + H] [num |
    den]; raw, ``out`` ([n_node, HD + H] float32) takes the kernel's adds
    and is returned in place of a zeroed output of its own (the classes of
    a MultiTiledGraph share one).  Exactly one of ``w_asrc`` [HD, H] in h's
    dtype (derive mode: the kernel's entry point forms a_s = h @ w_asrc per
    node in float32 first) and ``a_src`` [N, H], float32 per-node logits
    read as they are or the values mode's in h's dtype, which the kernel
    reads widened to float32 (exact).  ``a_dst`` [N, H] and ``msrc`` [1, H]
    are float32.  The kernel walks each tile's edge prefix (the builders'
    slot order).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if (w_asrc is None) == (a_src is None):
        raise ValueError("give exactly one of w_asrc and a_src")
    if out is not None and normalize:
        raise ValueError("out= takes the raw [num | den] (normalize=False)")
    if h.device.type == "cpu":
        y = _gat_tiles_reference(tg, h, mult, a_dst, msrc, w_asrc=w_asrc,
                                 a_src=a_src, negative_slope=negative_slope,
                                 normalize=normalize)
        return y if out is None else out.add_(y)
    dev = h.device
    H = a_dst.shape[1]
    HD = h.shape[1]
    dts = (torch.float32, torch.bfloat16)
    _ext.require(h, "h", dev, dts, 2)
    _ext.require(mult, "mult", dev, dts, 2)
    _ext.require(a_dst, "a_dst", dev, (torch.float32,), 2)
    _ext.require(msrc, "msrc", dev, (torch.float32,), 2)
    if w_asrc is not None:
        _ext.require(w_asrc, "w_asrc", dev, (h.dtype,), 2)
    else:
        _ext.require(a_src, "a_src", dev, (torch.float32, h.dtype), 2)
        if tuple(a_src.shape) != (h.shape[0], H):
            raise ValueError(f"a_src shape {tuple(a_src.shape)} != "
                             f"{(h.shape[0], H)}")
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
    if out is None:
        acc = torch.zeros((tg.n_node, HD + H), dtype=torch.float32,
                          device=dev)
    else:
        _ext.require(out, "out", dev, (torch.float32,), 2)
        if tuple(out.shape) != (tg.n_node, HD + H):
            raise ValueError(f"out shape {tuple(out.shape)} != "
                             f"{(tg.n_node, HD + H)}")
        acc = out
    out = (torch.empty((tg.n_node, HD), dtype=torch.float32, device=dev)
           if normalize else None)
    if tg.n_tiles == 0 or tg.n_node == 0:
        return acc[:, :HD].clone() if normalize else acc
    # derive mode: the per-node a_s the kernel's first launch writes
    a_scr = (torch.empty((h.shape[0], H), dtype=torch.float32, device=dev)
             if w_asrc is not None else None)
    if a_src is not None:
        a_src = a_src.float().contiguous()
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_gat_tiles(
            tg.tile_rb.data_ptr(), tg.tile_cb.data_ptr(),
            tg.src_local.data_ptr(), tg.dst_local.data_ptr(),
            mult.data_ptr(), _ext.DTYPE_CODE[mult.dtype],
            h.data_ptr(), _ext.DTYPE_CODE[h.dtype],
            w_asrc.data_ptr() if w_asrc is not None else None,
            a_src.data_ptr() if a_src is not None else None,
            a_scr.data_ptr() if a_scr is not None else None,
            a_dst.data_ptr(), msrc.data_ptr(), acc.data_ptr(),
            out.data_ptr() if normalize else None,
            tg.n_tiles, tg.block_rows, tg.block_cols, tg.tile_edges,
            HD, H, h.shape[0], a_dst.shape[0], tg.n_node,
            float(negative_slope), _ext.stream(h))
    _ext.check(rc, "gat_tiles")
    gat_tiles.launches += 1
    return out if normalize else acc


gat_tiles.launches = 0


def _gat_grouped_reference(tg: GroupedTiledGraph, h: torch.Tensor,
                           a_dst: torch.Tensor, msrc: torch.Tensor,
                           w_asrc: torch.Tensor, *,
                           negative_slope: float = 0.2) -> torch.Tensor:
    """Plain version of K10: K3's formulation in derive mode, raw [num |
    den], over the grouped arrays; slot weights scale p (a unit tiling's
    real slots weigh 1, so reading them changes nothing)."""
    return _gat_tiles_reference(tg, h, tg.weight, a_dst, msrc, w_asrc=w_asrc,
                                negative_slope=negative_slope,
                                normalize=False)


def gat_grouped(tg: GroupedTiledGraph, h: torch.Tensor, a_dst: torch.Tensor,
                msrc: torch.Tensor, w_asrc: Optional[torch.Tensor] = None, *,
                a_src: Optional[torch.Tensor] = None,
                negative_slope: float = 0.2) -> torch.Tensor:
    """K10 wrapper: raw [num | den] [n_node, HD + H] float32 over a grouped
    tiling, head-major.  Exactly one of ``w_asrc`` [HD, H] in h's dtype
    (derive mode: the kernel's entry point forms a_s = h @ w_asrc per node
    in float32 first, K3's pass) and ``a_src`` [N, H] float32, per-node
    logits read as they are (the grouped hybrid path's, which its msrc and
    the dense partial read too).  ``a_dst`` [N, H] and ``msrc`` [1, H] are
    float32.  The kernel walks the sub-tiles of ``tg.live_sub`` by their
    edge prefixes and reads the weight stream unless
    ``tg.weight_all_unit``.  CPU tensors take the plain version; CUDA
    tensors launch or raise."""
    if (w_asrc is None) == (a_src is None):
        raise ValueError("give exactly one of w_asrc and a_src")
    if h.device.type == "cpu":
        if w_asrc is not None:
            return _gat_grouped_reference(tg, h, a_dst, msrc, w_asrc,
                                          negative_slope=negative_slope)
        return _gat_tiles_reference(tg, h, tg.weight, a_dst, msrc,
                                    a_src=a_src, negative_slope=negative_slope,
                                    normalize=False)
    dev = h.device
    H = a_dst.shape[1]
    HD = h.shape[1]
    _ext.require(h, "h", dev, (torch.float32, torch.bfloat16), 2)
    if w_asrc is not None:
        _ext.require(w_asrc, "w_asrc", dev, (h.dtype,), 2)
        if tuple(w_asrc.shape) != (HD, H):
            raise ValueError(f"w_asrc shape {tuple(w_asrc.shape)} != "
                             f"{(HD, H)}")
    else:
        _ext.require(a_src, "a_src", dev, (torch.float32,), 2)
        if tuple(a_src.shape) != (h.shape[0], H):
            raise ValueError(f"a_src shape {tuple(a_src.shape)} != "
                             f"{(h.shape[0], H)}")
    _ext.require(a_dst, "a_dst", dev, (torch.float32,), 2)
    _ext.require(msrc, "msrc", dev, (torch.float32,), 2)
    _ext.require(tg.weight, "weight", dev, (torch.float32,), 3)
    _ext.require(tg.live_sub, "live_sub", dev, (torch.int32,), 1)
    _require_slots(tg, dev, ("chunk_grp", "chunk_cb"))
    if HD % H or HD > 256 or H > 32:
        raise ValueError(f"K10 takes HD % H == 0, HD <= 256, H <= 32; got "
                         f"HD={HD}, H={H}")
    if tuple(msrc.shape) != (1, H):
        raise ValueError(f"msrc shape {tuple(msrc.shape)} != {(1, H)}")
    # the kernel adds into a zeroed buffer with atomics
    acc = torch.zeros((tg.n_node, HD + H), dtype=torch.float32, device=dev)
    if tg.n_chunks == 0 or tg.n_node == 0:
        return acc
    # derive mode: the per-node a_s the kernel's first launch writes
    a_scr = (torch.empty((h.shape[0], H), dtype=torch.float32, device=dev)
             if w_asrc is not None else None)
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_gat_grouped(
            tg.live_sub.data_ptr(), tg.chunk_grp.data_ptr(),
            tg.chunk_cb.data_ptr(), tg.src_local.data_ptr(),
            tg.dst_local.data_ptr(),
            None if tg.weight_all_unit else tg.weight.data_ptr(),
            h.data_ptr(), _ext.DTYPE_CODE[h.dtype],
            w_asrc.data_ptr() if w_asrc is not None else None,
            a_src.data_ptr() if a_src is not None else None,
            a_scr.data_ptr() if a_scr is not None else None,
            a_dst.data_ptr(), msrc.data_ptr(), acc.data_ptr(),
            tg.live_sub.numel(), tg.group, tg.block_rows, tg.block_cols,
            tg.tile_edges, HD, H, h.shape[0], a_dst.shape[0], tg.n_node,
            float(negative_slope), _ext.stream(h))
    _ext.check(rc, "gat_grouped")
    gat_grouped.launches += 1
    return acc


gat_grouped.launches = 0


def _gat_forward(
    tg: Tiling,
    h_src: torch.Tensor,
    a_src: Optional[torch.Tensor],
    a_dst: torch.Tensor,
    *,
    w_asrc: Optional[torch.Tensor] = None,
    a_s: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    normalize: bool = True,
    msrc: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Edge-tile attention: [N, HD] normalized or raw [N, HD + H].

    ``w_asrc`` [HD, H] instead of ``a_src`` when a_src is a linear map of h:
    the kernel derives a_s from h ("derive" mode).  ``a_s`` [N, H] float32,
    h @ w_asrc at the kernels' precision: per-node logits that K3 and K10
    read as they are in place of deriving them (the hybrid path's, which
    its msrc, dense partial and backward read too).  ``a_src`` is rounded
    to h's dtype first (values mode).  ``msrc`` [1, H]: the shift bound;
    hybrid callers pass theirs so that every partial shares it.  A grouped
    tiling runs K10, which takes the hybrid partial path only, as in the
    JAX package: raw output, ``msrc`` given, and ``a_s`` or ``w_asrc``.  A
    MultiTiledGraph (tile capacity classes) runs K3 once per class under
    the one shift bound ``msrc``, which it needs, as raw output; each
    class adds its [num | den] into the first class's output.  ``out``:
    see :func:`gat_tiles` (per-tile tilings, raw)."""
    H = a_dst.shape[1]
    HD = h_src.shape[1]
    if HD % H:
        raise ValueError(f"HD={HD} is not a multiple of H={H}")
    if isinstance(tg, MultiTiledGraph):
        if normalize or msrc is None:
            raise ValueError("a MultiTiledGraph needs normalize=False and an "
                             "explicit msrc, so that the classes' partial "
                             "softmax sums share one shift")
        acc = None
        for part in tg.parts:
            acc = _gat_forward(part, h_src, a_src, a_dst, w_asrc=w_asrc,
                               a_s=a_s, negative_slope=negative_slope,
                               normalize=False, msrc=msrc, out=acc)
        return acc
    dt = h_src.dtype
    if isinstance(tg, GroupedTiledGraph):
        if normalize or msrc is None or (a_s is None and w_asrc is None):
            raise ValueError("a grouped tiling supports the hybrid partial "
                             "path only: normalize=False, msrc, and a_s or "
                             "w_asrc")
        kw = (dict(a_src=a_s.float().contiguous()) if a_s is not None
              else dict(w_asrc=w_asrc.to(dt).contiguous()))
        return gat_grouped(tg, h_src.contiguous(), a_dst.float().contiguous(),
                           msrc.float().reshape(1, H).contiguous(),
                           negative_slope=negative_slope, **kw)
    if a_s is not None:
        if msrc is None:
            msrc = a_s.float().amax(0, keepdim=True)
        kw = dict(a_src=a_s.float().contiguous())
    elif w_asrc is not None:
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
                     negative_slope=negative_slope, normalize=normalize,
                     out=out, **kw)


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
    alpha = shift_bound_p(a_s, a_d, ms, slope) * mult * rden
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
    out = torch.zeros((_geometry(tg)[1], H + (HD if src_mode else 0)),
                      dtype=torch.float32, device=h.device)
    ms = msrc.float().reshape(1, H)
    for t0, t1 in _unit_steps(tg, 2 * HD + 8 * H):
        valid, col, row = _live_slots(tg, t0, t1)
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


def _bwd_out(out: Optional[torch.Tensor], shape: tuple,
             dev: torch.device) -> torch.Tensor:
    """The float32 buffer a backward kernel adds into with atomics: the
    caller's ``out`` (checked), else a zeroed one of its own."""
    if out is None:
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    _ext.require(out, "out", dev, (torch.float32,), 2)
    if tuple(out.shape) != shape:
        raise ValueError(f"out shape {tuple(out.shape)} != {shape}")
    return out


def pack_side(side: torch.Tensor) -> torch.Tensor:
    """The side panel [N, 4H] = [a_s | a_d | 1/den | s2] repacked per node
    and head, [N, H, 4] float32 (one 16-byte load a head in the tail
    walks); with one head that is ``side`` itself, no copy."""
    n, H4 = side.shape
    return side.view(n, 4, H4 // 4).transpose(1, 2).contiguous()


def _gat_bwd_tiles(tg: TiledGraph, h, gbar, side, msrc, negative_slope,
                   src_mode: bool, entry: str,
                   packed: Optional[torch.Tensor],
                   out: Optional[torch.Tensor]) -> torch.Tensor:
    dev = h.device
    _require_bwd(h, gbar, side, msrc, dev)
    packed = pack_side(side) if packed is None else packed
    _ext.require(packed, "packed", dev, (torch.float32,), 3)
    if (tuple(packed.shape) != (side.shape[0], msrc.shape[1], 4)
            or packed.data_ptr() % 16):
        raise ValueError(f"packed side {tuple(packed.shape)} must be the "
                         f"16-byte aligned [N, H, 4] repack of side "
                         f"{tuple(side.shape)}")
    _ext.require(tg.weight, "weight", dev, (torch.float32, torch.bfloat16), 2)
    for name in ("src_local", "dst_local"):
        _ext.require(getattr(tg, name), name, dev, (torch.int16,), 2)
    for name in ("tile_rb", "tile_cb"):
        _ext.require(getattr(tg, name), name, dev, (torch.int32,), 1)
    H = msrc.shape[1]
    HD = h.shape[1]
    out = _bwd_out(out, (tg.n_node, H + (HD if src_mode else 0)), dev)
    if tg.n_tiles == 0 or tg.n_node == 0:
        return out
    lib = _ext.library()
    n = min(h.shape[0], tg.n_node)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            tg.tile_rb.data_ptr(), tg.tile_cb.data_ptr(),
            tg.src_local.data_ptr(), tg.dst_local.data_ptr(),
            tg.weight.data_ptr(), _ext.DTYPE_CODE[tg.weight.dtype],
            h.data_ptr(), gbar.data_ptr(), _ext.DTYPE_CODE[h.dtype],
            packed.data_ptr(), msrc.data_ptr(), out.data_ptr(), tg.n_tiles,
            tg.block_rows, tg.block_cols, tg.tile_edges, HD, H, n,
            float(negative_slope), _ext.stream(h))
    _ext.check(rc, entry)
    return out


def gat_bwd_tiles_dad(tg: TiledGraph, h: torch.Tensor, gbar: torch.Tensor,
                      side: torch.Tensor, msrc: torch.Tensor, *,
                      negative_slope: float = 0.2,
                      packed: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5 wrapper: dad [n, H] float32 over the forward tail tiling.  ``h``
    and ``gbar`` [N, HD] share a dtype; ``side`` [N, 4H] float32 is
    [a_s | a_d | 1/den | s2]; ``msrc`` [1, H] is the forward's shift bound;
    ``packed`` is ``pack_side(side)`` where the caller has it (else the
    wrapper packs); ``out`` ([n, H] float32) takes the kernel's adds and is
    returned in place of a zeroed output of its own.  CPU tensors take the
    plain version; CUDA tensors launch or raise."""
    if h.device.type == "cpu":
        y = _gat_bwd_tiles_reference(tg, h, gbar, side, msrc, src_mode=False,
                                     negative_slope=negative_slope)
        return y if out is None else out.add_(y)
    out = _gat_bwd_tiles(tg, h, gbar, side, msrc, negative_slope, False,
                         "gta_gat_bwd_tiles_dad", packed, out)
    gat_bwd_tiles_dad.launches += 1
    return out


gat_bwd_tiles_dad.launches = 0


def gat_bwd_tiles_src(tg_t: TiledGraph, h: torch.Tensor, gbar: torch.Tensor,
                      side: torch.Tensor, msrc: torch.Tensor, *,
                      negative_slope: float = 0.2,
                      packed: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6 wrapper: [das | dh] [n, H + HD] float32 over the TRANSPOSED tail
    tiling (its rows are the original senders); arguments as
    :func:`gat_bwd_tiles_dad`, ``out`` [n, H + HD].  CPU tensors take the
    plain version; CUDA tensors launch or raise."""
    if h.device.type == "cpu":
        y = _gat_bwd_tiles_reference(tg_t, h, gbar, side, msrc, src_mode=True,
                                     negative_slope=negative_slope)
        return y if out is None else out.add_(y)
    out = _gat_bwd_tiles(tg_t, h, gbar, side, msrc, negative_slope, True,
                         "gta_gat_bwd_tiles_src", packed, out)
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


def bwd_inputs(h: torch.Tensor, a_s: torch.Tensor, a_d: torch.Tensor,
               den: torch.Tensor, out: torch.Tensor, gbar: torch.Tensor,
               a_s_bound: Optional[torch.Tensor] = None) -> tuple:
    """What the backward kernels K5-K8 read, built once: (h, gbar in h's
    dtype, both contiguous; the float32 side panel [a_s | a_d | 1/den |
    s2] [N, 4H]; msrc [1, H], the per-head max of ``a_s`` or of
    ``a_s_bound``).  The dense kernels read the panel as it is, the tail
    kernels rounded to h's dtype (``side.to(h.dtype).float()``)."""
    s2, rden = bwd_node_terms(gbar, out, den)
    msrc = (a_s if a_s_bound is None else a_s_bound).float().amax(
        0, keepdim=True)
    side = torch.cat([a_s.float(), a_d.float(), rden, s2], dim=1)
    return h.contiguous(), gbar.to(h.dtype).contiguous(), side, msrc


def _gat_bwd_fused(tg: TiledGraph, tg_t: TiledGraph, h: torch.Tensor,
                   a_s: torch.Tensor, a_d: torch.Tensor, den: torch.Tensor,
                   out: torch.Tensor, gbar: torch.Tensor, slope: float,
                   a_s_bound: Optional[torch.Tensor] = None):
    """Tile-domain GAT attention backward: (dh, das, dad) of the tail
    edges, no [E]-shaped intermediate.  ``den`` [N, H] is the forward's
    (combined) raw denominator, ``out`` its normalized output; the shift
    bound is the per-head max of ``a_s`` (or of ``a_s_bound``, the a_src
    the forward bounded with).  As on the TPU, h, gbar, a_s, a_d, 1/den
    and s2 enter the kernels rounded to h's dtype.  The side panel is
    packed per node and head once, for K5 and K6 both."""
    H = a_d.shape[1]
    dt = h.dtype
    hc, gc, side, msrc = bwd_inputs(h, a_s, a_d, den, out, gbar, a_s_bound)
    side = side.to(dt).float()
    packed = None if h.device.type == "cpu" else pack_side(side)
    dad = gat_bwd_tiles_dad(tg, hc, gc, side, msrc, negative_slope=slope,
                            packed=packed)
    sd = gat_bwd_tiles_src(tg_t, hc, gc, side, msrc, negative_slope=slope,
                           packed=packed)
    return sd[:, H:].to(dt), sd[:, :H].to(a_s.dtype), dad.to(a_d.dtype)


def _gat_reference(tg: TiledGraph, h_src, a_src, a_dst, negative_slope):
    """Segment formulation over the tiling's live slots with the EXACT
    per-row max (the JAX package's differentiable twin, which masks every
    slot of the tiling where this selects the live ones: [E, HD] edge
    tensors, not [slots, HD]).  It ignores multiplicity and has no
    shift-bound domain, so it equals the kernels only on unit-weight
    tilings inside that domain."""
    n = tg.n_node
    H = a_src.shape[1]
    HD = h_src.shape[1]
    D = HD // H
    _, src, dst = _live_slots(tg, 0, tg.n_tiles)
    f32 = torch.float32
    dev = h_src.device
    hs = h_src.float().index_select(0, src)
    e = _leaky(a_src.float().index_select(0, src)
               + a_dst.float().index_select(0, dst), negative_slope)
    m = torch.full((n, H), float("-inf"), dtype=f32, device=dev)
    m = m.scatter_reduce_(0, dst[:, None].expand_as(e), e, "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = exp_f64(e - m.index_select(0, dst))
    den = torch.zeros((n, H), dtype=f32, device=dev).index_add_(0, dst, p)
    num = torch.zeros((n, HD), dtype=f32, device=dev).index_add_(
        0, dst, p.repeat_interleave(D, dim=1) * hs)
    return num / torch.clamp(den, min=1e-20).repeat_interleave(D, dim=1)


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


class _GatAttention(torch.autograd.Function):
    """The JAX package's ``_gat_vjp``.  Forward on K3.  With a per-tile
    twin (``fused``) the forward keeps K3's raw denominator and the backward
    runs :func:`_gat_bwd_fused` (K5 over ``tg``, K6 over the twin); in
    derive mode the chain rule through a_s = h w follows in float32.
    Without one, autograd of :func:`_gat_reference`, which holds [E, HD]
    edge tensors.  JAX keeps two a_s twins in derive mode (its msrc bound at
    DEFAULT precision, its logits at HIGHEST); here both are the same float32
    product of h's dtype operands (TF32 off), so one a_s serves both."""

    @staticmethod
    def forward(ctx, h, sw, d, tg, tg_t, slope, wmode, fused):
        w, s = (sw, None) if wmode else (None, sw)
        ctx.tg, ctx.tg_t, ctx.slope = tg, tg_t, slope
        ctx.wmode, ctx.fused = wmode, fused
        if not fused:
            ctx.save_for_backward(h, sw, d)
            return _gat_forward(tg, h, s, d, w_asrc=w, negative_slope=slope)
        HD, H = h.shape[1], d.shape[1]
        raw = _gat_forward(tg, h, s, d, w_asrc=w, negative_slope=slope,
                           normalize=False)
        den = raw[:, HD:]
        y = raw[:, :HD] / torch.clamp(den, min=1e-20).repeat_interleave(
            HD // H, dim=1)
        ctx.save_for_backward(h, sw, d, y, den)
        return y

    @staticmethod
    def backward(ctx, gy):
        none = (None,) * 5
        if not ctx.fused:
            h, sw, d = ctx.saved_tensors
            with torch.enable_grad():
                hv, sv, dv = (t.detach().requires_grad_(True)
                              for t in (h, sw, d))
                a_s = hv.float() @ sv.float() if ctx.wmode else sv
                y = _gat_reference(ctx.tg, hv, a_s, dv, ctx.slope)
                return torch.autograd.grad(y, (hv, sv, dv), gy.float()) + none
        h, sw, d, y, den = ctx.saved_tensors
        if not ctx.wmode:
            dh, das, dad = _gat_bwd_fused(ctx.tg, ctx.tg_t, h, sw, d, den, y,
                                          gy, ctx.slope)
            return (dh, das.to(sw.dtype), dad.to(d.dtype)) + none
        a_s = h.float() @ sw.to(h.dtype).float()
        dh, das, dad = _gat_bwd_fused(ctx.tg, ctx.tg_t, h, a_s, d, den, y, gy,
                                      ctx.slope)
        das32 = das.float()
        dh = (dh.float() + das32 @ sw.float().T).to(h.dtype)
        dw = (h.float().T @ das32).to(sw.dtype)
        return (dh, dw, dad.to(d.dtype)) + none


def gat_attention(
    tg: TiledGraph,
    h_src: torch.Tensor,
    a_src: Optional[torch.Tensor] = None,
    a_dst: Optional[torch.Tensor] = None,
    heads: int = 1,
    negative_slope: float = 0.2,
    w_asrc: Optional[torch.Tensor] = None,
    g: Optional[GraphTensor] = None,
    tg_t: Optional[TiledGraph] = None,
    ev_perm_t: Optional[torch.Tensor] = None,
    guard_shift: bool = False,
) -> torch.Tensor:
    """Fused multi-head GAT edge-softmax + aggregation, [N, HD] float32,
    differentiable in h, a_src (or ``w_asrc``) and a_dst.  Pass ``w_asrc``
    [HD, H] instead of ``a_src`` when a_src is a linear map of h.

    Backward, as in the JAX package: with ``g``, ``tg_t`` (the unit-weight
    tiling of the transposed graph) and ``ev_perm_t`` (its
    ``transpose_host_graph`` permutation), and both tilings per-tile, the
    tile-domain kernels K5 and K6; otherwise autograd of the edge
    formulation over ``tg`` (exact, but [E, HD] edge tensors).  Where JAX
    would take its superseded ``_gat_bwd_scalable`` (those three given, a
    tiling not per-tile) the port takes that reference route: the same
    gradient by another route.

    ``guard_shift`` (needs ``g``): check the shift bound's domain at run
    time.  :func:`gat_shift_gap` of a_s (in ``w_asrc`` mode a_s = h w in
    float32) is read to the host once; below ``SHIFT_GAP_SAFE`` the call
    takes K3's route, else the exact per-row-max :func:`_gat_reference`
    (the adversarial-logit regime where the kernels' bound underflows).
    The guard turns the fused K5/K6 backward off, as in JAX, so both
    routes differentiate the edge formulation.  The branch is a host
    decision after a device-to-host read, PyTorch's counterpart of JAX's
    ``lax.cond``: it synchronises with the card and cannot run under CUDA
    graph capture; at Reddit scale check the gap offline instead.
    Without the guard the route is exactly the unguarded one."""
    assert not guard_shift or g is not None, "guard_shift needs g"
    scalable = g is not None and tg_t is not None and ev_perm_t is not None
    fused = (scalable and not guard_shift and type(tg) is TiledGraph
             and type(tg_t) is TiledGraph)
    wmode = w_asrc is not None
    if guard_shift:
        a_s = h_src.float() @ w_asrc.float() if wmode else a_src
        if not float(gat_shift_gap(g, a_s.detach())) < SHIFT_GAP_SAFE:
            return _gat_reference(tg, h_src, a_s, a_dst, negative_slope)
    return _GatAttention.apply(h_src, w_asrc if wmode else a_src, a_dst, tg,
                               tg_t if fused else None, float(negative_slope),
                               wmode, fused)


# ---------------------------------------------------------------------------
# the whole GAT layer (K14)
# ---------------------------------------------------------------------------

# final activations of the whole-layer kernel, codes of csrc/gat_layer.cu
SF_CODE = {"identity": 0, "relu": 1, "elu": 2, "leaky_relu": 3}


def _sf_apply(v: torch.Tensor, sf: str, slope: float) -> torch.Tensor:
    """The layer's final activation; ELU is exp(min(v, 0)) - 1, as the JAX
    package computes it (no expm1)."""
    if sf == "identity":
        return v
    if sf == "relu":
        return torch.clamp(v, min=0.0)
    if sf == "elu":
        return torch.where(v > 0, v, exp_f64(torch.clamp(v, max=0.0)) - 1.0)
    if sf == "leaky_relu":
        return torch.where(v >= 0, v, slope * v)
    raise ValueError(f"whole-layer kernel: unsupported sf {sf!r}")


def _gat_layer_reference(tg: TiledGraph, x, w, wa_src, wa_dst,
                         negative_slope: float, final_sf: str) -> torch.Tensor:
    """The layer in float32 with the EXACT per-row max (no static shift):
    what the JAX package differentiates for the layer's gradient."""
    h = x.float() @ w.float()
    a_s = h @ wa_src.float()
    a_d = h @ wa_dst.float()
    out = _gat_reference(tg, h, a_s, a_d, negative_slope)
    return _sf_apply(out, final_sf, negative_slope)


def _gat_layer_project_plain(x, w, wa_src, wa_dst):
    """Plain version of K14's projection: (hq, a_s, a_d).  hq = x w summed
    in float32 and rounded to x's dtype; a_s | a_d = hq [wa_s | wa_d]
    summed in float32 and rounded to x's dtype, returned widened to float32
    (exact), as the kernel writes them for its walk."""
    dt = x.dtype
    H = wa_src.shape[1]
    hq = (x.float() @ w.to(dt).float()).to(dt)
    wv = torch.cat([wa_src, wa_dst], dim=1).to(dt).float()
    sd = (hq.float() @ wv).to(dt).float()
    return hq, sd[:, :H].contiguous(), sd[:, H:].contiguous()


def _gat_layer_walk_plain(tg: TiledGraph, hq, a_s, a_d, *,
                          negative_slope: float = 0.2,
                          final_sf: str = "identity") -> torch.Tensor:
    """Plain version of K14's walk and epilogue from a projection (hq in
    the compute dtype, a_s and a_d float32): p = exp(min(leaky(a_s + a_d),
    SHIFT + 60) - SHIFT) over the live slots (tile weights not read), p and
    p hq rounded to hq's dtype before the sums, then sf(num / max(den,
    1e-30)), [n_node, HD] float32.  num and den are summed in float64 and
    rounded once to float32, so a check against this version measures the
    kernel's own sum-order error, not a float32 drift of its own on hub
    rows that repeat one edge hundreds of times."""
    dt = hq.dtype
    H, HD = a_s.shape[1], hq.shape[1]
    D = HD // H
    acc = torch.zeros((_geometry(tg)[1], HD + H), dtype=torch.float64,
                      device=hq.device)
    for t0, t1 in _unit_steps(tg, HD + H):
        _, src, dst = _live_slots(tg, t0, t1)
        hs = hq.index_select(0, src).float()
        p = static_shift_p(a_s.index_select(0, src).float(),
                           a_d.index_select(0, dst), negative_slope)
        v = torch.cat([p.repeat_interleave(D, dim=1) * hs, p], dim=1)
        if dt != torch.float32:
            v = v.to(dt).float()
        acc.index_add_(0, dst, v.double())
    acc = acc[: tg.n_node].float()
    den = torch.clamp(acc[:, HD:], min=1e-30).repeat_interleave(D, dim=1)
    return _sf_apply(acc[:, :HD] / den, final_sf, negative_slope)


def _gat_layer_plain(tg: TiledGraph, x, w, wa_src, wa_dst, *,
                     negative_slope: float = 0.2,
                     final_sf: str = "identity") -> torch.Tensor:
    """Plain version of K14, [n_node, HD] float32, with the kernel's static
    shift, clamp and roundings: :func:`_gat_layer_project_plain` then
    :func:`_gat_layer_walk_plain`."""
    return _gat_layer_walk_plain(
        tg, *_gat_layer_project_plain(x, w, wa_src, wa_dst),
        negative_slope=negative_slope, final_sf=final_sf)


def _require_layer(tg, x, w, wa_src, wa_dst):
    dev = x.device
    _ext.require(x, "x", dev, (torch.float32, torch.bfloat16), 2)
    for name, t in (("w", w), ("wa_src", wa_src), ("wa_dst", wa_dst)):
        _ext.require(t, name, dev, (x.dtype,), 2)
    F, HD, H = x.shape[1], w.shape[1], wa_src.shape[1]
    if (w.shape[0] != F or tuple(wa_src.shape) != (HD, H)
            or tuple(wa_dst.shape) != (HD, H)):
        raise ValueError(f"inconsistent shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, wa_src {tuple(wa_src.shape)}, "
                         f"wa_dst {tuple(wa_dst.shape)}")
    if HD % H or HD > 256 or H > 32:
        raise ValueError(f"K14 takes HD % H == 0, HD <= 256, H <= 32; got "
                         f"HD={HD}, H={H}")
    if tg is not None:
        for name in ("src_local", "dst_local"):
            _ext.require(getattr(tg, name), name, dev, (torch.int16,), 2)
        for name in ("tile_rb", "tile_cb"):
            _ext.require(getattr(tg, name), name, dev, (torch.int32,), 1)
        if x.shape[0] != tg.n_node:
            raise ValueError(f"x has {x.shape[0]} rows, the tiling "
                             f"{tg.n_node} nodes")


def _gat_layer_launch(tg, x, w, wa_src, wa_dst, slope, final_sf, stages,
                      proj=None, acc=None):
    """Launch the stages of K14 (bits: 1 projection, 2 walk, 4 epilogue)
    into fresh buffers, or into ``proj`` (hq, a_s, a_d) and ``acc`` [n, HD
    + H] where given (the smoke times the stages apart); returns (out, hq,
    a_s, a_d)."""
    dev = x.device
    n, F = x.shape
    HD, H = w.shape[1], wa_src.shape[1]
    f32 = torch.float32
    hq, a_s, a_d = proj if proj is not None else (
        torch.empty((n, HD), dtype=x.dtype, device=dev),
        torch.empty((n, H), dtype=f32, device=dev),
        torch.empty((n, H), dtype=f32, device=dev))
    # the walk adds into [num | den] with atomics: zeroed
    if acc is None and stages & 6:
        acc = torch.zeros((n, HD + H), dtype=f32, device=dev)
    out = torch.empty((n, HD), dtype=f32, device=dev) if stages & 4 else None
    # the bf16 tensor-core projection's B operand: W transposed, HD padded
    # to the wgmma width, F to a multiple of 8 (the kernel fills it)
    N = _gat_wgmma_width(1, HD) if x.dtype == torch.bfloat16 else 0
    ld_w = -(-F // 8) * 8
    w_panel = (torch.empty((N, ld_w), dtype=x.dtype, device=dev)
               if N and stages & 1 else None)
    T = tg.n_tiles if tg is not None else 0
    geo = ((tg.block_rows, tg.block_cols, tg.tile_edges) if tg is not None
           else (0, 0, 0))
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_gat_layer(
            *(getattr(tg, k).data_ptr() if tg is not None else None
              for k in ("tile_rb", "tile_cb", "src_local", "dst_local")),
            x.data_ptr(), w.data_ptr(), wa_src.data_ptr(),
            wa_dst.data_ptr(), _ext.DTYPE_CODE[x.dtype],
            None if w_panel is None else w_panel.data_ptr(), ld_w,
            hq.data_ptr(), a_s.data_ptr(), a_d.data_ptr(),
            None if acc is None else acc.data_ptr(),
            None if out is None else out.data_ptr(), T, *geo, n, F, HD, H,
            SF_CODE[final_sf], float(slope), stages,
            _gat_layer_smem(HD, H, x.element_size()), _ext.stream(x))
    _ext.check(rc, "gat_layer")
    return out, hq, a_s, a_d


def gat_layer_tiles(tg: TiledGraph, x: torch.Tensor, w: torch.Tensor,
                    wa_src: torch.Tensor, wa_dst: torch.Tensor, *,
                    negative_slope: float = 0.2,
                    final_sf: str = "identity") -> torch.Tensor:
    """K14 wrapper: the whole GAT layer, [n_node, HD] float32.  ``x`` [n_node,
    F] float32 or bfloat16; ``w`` [F, HD], ``wa_src`` / ``wa_dst`` [HD, H]
    in x's dtype.  The kernel walks each tile's edge prefix (the builders'
    slot order).  CPU tensors take the plain version; CUDA tensors launch
    the kernel (three stages) or raise."""
    if final_sf not in SF_CODE:
        raise ValueError(f"whole-layer kernel: unsupported sf {final_sf!r}")
    if x.device.type == "cpu":
        return _gat_layer_plain(tg, x, w, wa_src, wa_dst,
                                negative_slope=negative_slope,
                                final_sf=final_sf)
    _require_layer(tg, x, w, wa_src, wa_dst)
    out = _gat_layer_launch(tg, x, w, wa_src, wa_dst, negative_slope,
                            final_sf, 7)[0]
    gat_layer_tiles.launches += 1
    return out


gat_layer_tiles.launches = 0


def gat_layer_projection(x: torch.Tensor, w: torch.Tensor,
                         wa_src: torch.Tensor, wa_dst: torch.Tensor):
    """K14's projection stage alone on CUDA tensors, (hq, a_s, a_d) as
    :func:`_gat_layer_project_plain` returns them: for timing the stage
    beside ``torch.matmul`` of the same product; not a launch of the layer
    (the count stays)."""
    _require_layer(None, x, w, wa_src, wa_dst)
    return _gat_layer_launch(None, x, w, wa_src, wa_dst, 0.2, "identity",
                             1)[1:]


class _GatLayer(torch.autograd.Function):
    """Forward on K14; backward by autograd of :func:`_gat_layer_reference`
    (exact per-row max, [E, HD] edge tensors), as in the JAX package."""

    @staticmethod
    def forward(ctx, x, w, wa_src, wa_dst, tg, slope, final_sf):
        ctx.tg, ctx.slope, ctx.final_sf = tg, slope, final_sf
        ctx.save_for_backward(x, w, wa_src, wa_dst)
        dt = x.dtype
        return gat_layer_tiles(tg, x.contiguous(), w.to(dt).contiguous(),
                               wa_src.to(dt).contiguous(),
                               wa_dst.to(dt).contiguous(),
                               negative_slope=slope, final_sf=final_sf)

    @staticmethod
    def backward(ctx, gy):
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(nd)
                   for t, nd in zip(ctx.saved_tensors, need)]
            y = _gat_layer_reference(ctx.tg, *ins, ctx.slope, ctx.final_sf)
            got = iter(torch.autograd.grad(
                y, [t for t, nd in zip(ins, need) if nd], gy.float()))
        return tuple(next(got) if nd else None for nd in need) + (None,) * 3


def gat_layer(tg: TiledGraph, x: torch.Tensor, w: torch.Tensor,
              wa_src: torch.Tensor, wa_dst: torch.Tensor, *,
              negative_slope: float = 0.2,
              final_sf: str = "identity") -> torch.Tensor:
    """The complete GAT layer (projection, attention logits, softmax,
    aggregation, activation) on K14, [n_node, HD] float32, differentiable
    in x, w, wa_src and wa_dst through the exact edge formulation (as the
    JAX package's ``gat_layer``).  The kernel's static shift equals the
    exact softmax while every row's logits stay in its domain: none above
    SHIFT + 60 and, in each row, some within ~100 below SHIFT."""
    return _GatLayer.apply(x, w, wa_src, wa_dst, tg, float(negative_slope),
                           final_sf)


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
