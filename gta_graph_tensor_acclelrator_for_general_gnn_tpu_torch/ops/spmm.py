"""Block-sparse SpMM: ``y[r] = sum over edges (s -> r) of w_e x[s]``.

Counterpart of the JAX package's ``ops/spmm.py``.  Two kernels read the
host-built tilings in place: K1 ``csrc/spmm_tiles.cu`` over a
:class:`~..graph.TiledGraph` (the Hopper replacement of the TPU one-hot
kernel ``_spmm_kernel``) and K9 ``csrc/spmm_grouped.cu`` over a
:class:`~..graph.GroupedTiledGraph` (replacing ``_spmm_grouped_kernel``).
:func:`_spmm_reference` is the plain PyTorch version of both, over the
same arrays.  The wrappers :func:`spmm_tiles` and :func:`spmm_grouped`
take the plain version for a tensor on the CPU and launch the kernel for a
CUDA tensor (or raise).  :func:`spmm` dispatches on the tiling and is
differentiable: with ``tg_t``, a tiling of the transposed graph, dx = Aᵀȳ
runs the same kernel over it.  A :class:`~..graph.MultiTiledGraph` (tile
capacity classes) runs K1 once per class, all adding into one output.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..graph import GroupedTiledGraph, MultiTiledGraph, TiledGraph
from . import _ext

# f32 elements per chunk of the plain versions' per-slot temporaries
_PLAIN_CHUNK = 1 << 26

Tiling = Union[TiledGraph, GroupedTiledGraph]


def parts_of(tg) -> tuple:
    """The single tilings of ``tg``: a MultiTiledGraph's class parts, else
    ``tg`` alone."""
    return tg.parts if isinstance(tg, MultiTiledGraph) else (tg,)


def _geometry(tg: Tiling):
    """(units, output rows, slots per unit): a unit is a tile of a
    TiledGraph or a chunk of a GroupedTiledGraph."""
    if isinstance(tg, GroupedTiledGraph):
        return (tg.n_chunks, tg.n_groups * tg.group * tg.block_rows,
                tg.group * tg.tile_edges)
    return tg.n_tiles, tg.n_row_blocks * tg.block_rows, tg.tile_edges


def _live_slots(tg: Tiling, u0: int, u1: int):
    """(mask, src, dst) of the live slots of units [u0, u1): ``mask`` has
    the shape of ``tg.src_local[u0:u1]``; ``src`` / ``dst`` are the global
    node ids of its True slots.  Pad slots (src >= C or dst >= R) and the
    slots of dead tiles (cb < 0) are not live."""
    R, C = tg.block_rows, tg.block_cols
    sl = tg.src_local[u0:u1].long()
    dl = tg.dst_local[u0:u1].long()
    if isinstance(tg, GroupedTiledGraph):
        cb = tg.chunk_cb[u0:u1].long()[:, None, None]
        j = torch.arange(tg.group, device=sl.device)[None, :, None]
        rb = tg.chunk_grp[u0:u1].long()[:, None, None] * tg.group + j
    else:
        cb = tg.tile_cb[u0:u1].long()[:, None]
        rb = tg.tile_rb[u0:u1].long()[:, None]
    mask = (cb >= 0) & (sl < C) & (dl < R)
    return mask, (cb * C + sl)[mask], (rb * R + dl)[mask]


def _unit_steps(tg: Tiling, width: int):
    """[u0, u1) ranges of units whose per-slot temporaries of ``width``
    f32 each stay within ``_PLAIN_CHUNK`` elements."""
    n_units, _, per_unit = _geometry(tg)
    step = max(1, _PLAIN_CHUNK // max(per_unit * width, 1))
    return [(u0, u0 + step) for u0 in range(0, n_units, step)]


def _tile_weight(tg: Tiling, edge_vals: Optional[torch.Tensor]):
    """Slot weights, times runtime per-edge values gathered into the slot
    layout through ``edge_id`` when given."""
    if edge_vals is None:
        return tg.weight
    return tg.weight.float() * edge_vals.float()[tg.edge_id.long()]


def _spmm_reference(tg: Tiling, x: torch.Tensor,
                    edge_vals: Optional[torch.Tensor] = None, *,
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1 (per-tile tilings and each class of a
    MultiTiledGraph) and K9 (grouped tilings) over the same arrays:
    [n_node, F] float32.

    It computes what the TPU kernels compute: dead tiles (cb < 0) and pad
    slots add nothing, and each w*x[s] rounds to x's dtype before the f32
    sum.  (The JAX package's XLA twin skips neither rounding nor dead tiles
    with nonzero weights; on builder output the two agree in float32.)
    The rounded terms are summed in float64 and the sum rounded once to
    float32, so a check against this version measures the kernel's own
    sum-order error: a multigraph row that repeats one term hundreds of
    times drifts by ~n/4 ulps in a float32 sum of any order.  Over a
    MultiTiledGraph the classes' terms go into one float64 sum."""
    if isinstance(tg, MultiTiledGraph):
        if weight is not None:
            raise ValueError("weight= names one tiling's slots; a "
                             "MultiTiledGraph takes edge_vals")
        y = sum(_spmm_f64(p, x, _tile_weight(p, edge_vals))
                for p in tg.parts)
        return y.float()
    w = _tile_weight(tg, edge_vals) if weight is None else weight
    return _spmm_f64(tg, x, w).float()


def _spmm_f64(tg: Tiling, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The rounded terms of one tiling summed in float64, [n_node, F]."""
    F = x.shape[1]
    y = torch.zeros((_geometry(tg)[1], F), dtype=torch.float64,
                    device=x.device)
    for u0, u1 in _unit_steps(tg, F):
        mask, src, dst = _live_slots(tg, u0, u1)
        msg = x.index_select(0, src).float() * w[u0:u1].float()[mask][:, None]
        if x.dtype != torch.float32:
            msg = msg.to(x.dtype).float()
        y.index_add_(0, dst, msg.double())
    return y[: tg.n_node]


# K9's plain version: the same formulation over the grouped arrays
_spmm_grouped_reference = _spmm_reference


def _require_slots(tg: Tiling, dev: torch.device, units: tuple) -> None:
    for name in ("src_local", "dst_local"):
        _ext.require(getattr(tg, name), name, dev, (torch.int16,),
                     tg.src_local.dim())
    for name in units:
        _ext.require(getattr(tg, name), name, dev, (torch.int32,), 1)


def spmm_tiles(tg: TiledGraph, x: torch.Tensor, weight: torch.Tensor, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 wrapper: [n_node, F] float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, which reads ``weight``
    ([T, ET] float32 or bfloat16) in place of ``tg.weight``.  ``out``
    ([n_node, F] float32): the kernel adds into it, and it is returned,
    in place of a zeroed output of its own (the classes of a
    MultiTiledGraph share one)."""
    if x.device.type == "cpu":
        y = _spmm_reference(tg, x, weight=weight)
        return y if out is None else out.add_(y)
    dev = x.device
    _ext.require(x, "x", dev, (torch.float32, torch.bfloat16), 2)
    _ext.require(weight, "weight", dev, (torch.float32, torch.bfloat16), 2)
    _require_slots(tg, dev, ("tile_rb", "tile_cb"))
    if tuple(weight.shape) != (tg.n_tiles, tg.tile_edges):
        raise ValueError(f"weight shape {tuple(weight.shape)} != "
                         f"{(tg.n_tiles, tg.tile_edges)}")
    F = x.shape[1]
    # the kernel adds into y with atomics: rows without edges stay 0
    if out is None:
        y = torch.zeros((tg.n_node, F), dtype=torch.float32, device=dev)
    else:
        _ext.require(out, "out", dev, (torch.float32,), 2)
        if tuple(out.shape) != (tg.n_node, F):
            raise ValueError(f"out shape {tuple(out.shape)} != "
                             f"{(tg.n_node, F)}")
        y = out
    if F == 0 or tg.n_tiles == 0:
        return y
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_spmm_tiles(
            tg.tile_rb.data_ptr(), tg.tile_cb.data_ptr(),
            tg.src_local.data_ptr(), tg.dst_local.data_ptr(),
            weight.data_ptr(), _ext.DTYPE_CODE[weight.dtype],
            x.data_ptr(), _ext.DTYPE_CODE[x.dtype], y.data_ptr(),
            tg.n_tiles, tg.block_rows, tg.block_cols, tg.tile_edges, F,
            x.shape[0], tg.n_node, _ext.stream(x))
    _ext.check(rc, "spmm_tiles")
    spmm_tiles.launches += 1
    return y


spmm_tiles.launches = 0


def spmm_grouped(tg: GroupedTiledGraph, x: torch.Tensor,
                 weight: Optional[torch.Tensor]) -> torch.Tensor:
    """K9 wrapper: [n_node, F] float32 over a grouped tiling.  ``weight``
    ([NC, G, ET] float32) replaces ``tg.weight``; None drops the weight
    stream, which needs ``tg.weight_all_unit``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if weight is None and not tg.weight_all_unit:
        raise ValueError("weight=None needs a tiling whose real edges all "
                         "weigh 1 (weight_all_unit)")
    if x.device.type == "cpu":
        return _spmm_reference(tg, x, weight=tg.weight if weight is None
                               else weight)
    dev = x.device
    _ext.require(x, "x", dev, (torch.float32, torch.bfloat16), 2)
    _require_slots(tg, dev, ("chunk_grp", "chunk_cb", "live_sub"))
    if weight is not None:
        _ext.require(weight, "weight", dev, (torch.float32,), 3)
        if weight.shape != tg.src_local.shape:
            raise ValueError(f"weight shape {tuple(weight.shape)} != "
                             f"{tuple(tg.src_local.shape)}")
    F = x.shape[1]
    # the kernel adds into y with atomics: rows without edges stay 0
    y = torch.zeros((tg.n_node, F), dtype=torch.float32, device=dev)
    n_live = int(tg.live_sub.shape[0])
    if F == 0 or n_live == 0:
        return y
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_spmm_grouped(
            tg.live_sub.data_ptr(), tg.chunk_grp.data_ptr(),
            tg.chunk_cb.data_ptr(),
            tg.src_local.data_ptr(), tg.dst_local.data_ptr(),
            None if weight is None else weight.data_ptr(),
            x.data_ptr(), _ext.DTYPE_CODE[x.dtype], y.data_ptr(),
            n_live, tg.group, tg.block_rows, tg.block_cols,
            tg.tile_edges, F, x.shape[0], tg.n_node, _ext.stream(x))
    _ext.check(rc, "spmm_grouped")
    spmm_grouped.launches += 1
    return y


spmm_grouped.launches = 0


def _spmm_raw(tg: Tiling, x: torch.Tensor,
              edge_vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward on the tiling's kernel (the JAX ``_spmm_raw``); a
    grouped tiling whose real edges all weigh 1 runs without the weight
    stream unless ``edge_vals`` are given; a MultiTiledGraph runs K1 once
    per class, each adding into the first class's output."""
    x = x.contiguous()
    if isinstance(tg, MultiTiledGraph):
        y = None
        for p in tg.parts:
            y = spmm_tiles(p, x, _tile_weight(p, edge_vals).contiguous(),
                           out=y)
        return y
    if isinstance(tg, GroupedTiledGraph):
        unit = edge_vals is None and tg.weight_all_unit
        return spmm_grouped(tg, x, None if unit else
                            _tile_weight(tg, edge_vals).float().contiguous())
    return spmm_tiles(tg, x, _tile_weight(tg, edge_vals).contiguous())


def _spmm_plain_vjp(tg: Tiling, x: torch.Tensor, gy: torch.Tensor,
                    edge_vals: Optional[torch.Tensor], need_x: bool,
                    need_ev: bool):
    """(dx, d edge_vals) of the plain float32 formulation over the tile
    arrays (the JAX ``jax.vjp`` of ``_spmm_reference``): dx = Aᵀȳ summed in
    float32 and cast to x's dtype; d ev[e] = sum over e's slots of the slot
    weight times <x[s], ȳ[r]>."""
    if not (need_x or need_ev):
        return None, None
    gf = gy.float()
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device) \
        if need_x else None
    dev = torch.zeros(edge_vals.shape, dtype=torch.float32,
                      device=x.device) if need_ev else None
    for part in parts_of(tg):
        w = _tile_weight(part, edge_vals)
        for u0, u1 in _unit_steps(part, x.shape[1]):
            mask, src, dst = _live_slots(part, u0, u1)
            g = gf.index_select(0, dst)
            if need_x:
                dx.index_add_(0, src, g * w[u0:u1].float()[mask][:, None])
            if need_ev:
                t = (x.index_select(0, src).float() * g).sum(1)
                dev.index_add_(0, part.edge_id[u0:u1][mask].long(),
                               part.weight[u0:u1].float()[mask] * t)
    return (None if dx is None else dx.to(x.dtype),
            None if dev is None else dev.to(edge_vals.dtype))


class _Spmm(torch.autograd.Function):
    """y = A x on the tiling's kernel.  Backward as the JAX ``spmm``
    custom VJP: with ``tg_t`` (and ``ev_perm_t`` when edge values are
    given) dx = Aᵀȳ runs the same kernel over the transposed tiling; else
    dx comes from the plain formulation.  The edge-value gradient always
    comes from the plain formulation."""

    @staticmethod
    def forward(ctx, x, edge_vals, tg, tg_t, ev_perm_t):
        ctx.tg, ctx.tg_t, ctx.ev_perm_t = tg, tg_t, ev_perm_t
        ctx.save_for_backward(x, edge_vals)
        return _spmm_raw(tg, x, edge_vals)

    @staticmethod
    def backward(ctx, gy):
        x, ev = ctx.saved_tensors
        need_x, need_ev = ctx.needs_input_grad[:2]
        kernel_dx = need_x and ctx.tg_t is not None and (
            ev is None or ctx.ev_perm_t is not None)
        dx, dev = _spmm_plain_vjp(ctx.tg, x, gy, ev,
                                  need_x and not kernel_dx,
                                  need_ev and ev is not None)
        if kernel_dx:
            ev_t = None if ev is None else ev[ctx.ev_perm_t.long()]
            dx = _spmm_raw(ctx.tg_t, gy.to(x.dtype), ev_t)[: x.shape[0]]
            dx = dx.to(x.dtype)
        return dx, dev, None, None, None


def spmm(tg: Tiling, x: torch.Tensor,
         edge_vals: Optional[torch.Tensor] = None, *,
         tg_t: Optional[Tiling] = None,
         ev_perm_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-sparse SpMM, ``y`` [n_node, F] float32, differentiable in
    ``x`` and ``edge_vals`` ([e_pad] per-edge multipliers of the slot
    weights).  K1 runs per-tile tilings (once per class of a
    MultiTiledGraph), K9 grouped ones.  ``tg_t``: the same kind of tiling over the transposed graph
    (:func:`~..graph.transpose_host_graph`), so that dx = Aᵀȳ runs the
    kernel too; ``ev_perm_t`` (that function's ``perm``) routes
    ``edge_vals`` into it.  Without ``tg_t`` the gradient comes from the
    plain formulation, which holds [slots, F] temporaries per chunk."""
    return _Spmm.apply(x, edge_vals, tg, tg_t, ev_perm_t)
