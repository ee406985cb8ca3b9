"""SDDMM: per-edge, per-head dot products of gathered node features,
``e[h, k] = sum over head h's features of x_src[sender_k] * x_dst[receiver_k]``
(the sampled dense-dense product behind attention logits).

Counterpart of the JAX package's ``ops/sddmm.py``.  Two kernels read the
host-built tilings in place: K11 ``csrc/sddmm_tiles.cu`` over a
:class:`~..graph.TiledGraph` (replacing the TPU kernel of ``sddmm``) and
K12 ``csrc/sddmm_grouped.cu`` over a :class:`~..graph.GroupedTiledGraph`
(replacing the kernel of ``_sddmm_grouped``).  Features are head-major:
F = heads * P, head h owning features [h*P, (h+1)*P).  The outputs keep the
JAX layouts, [heads, T, ET] and [heads, NC, G*ET]; pad slots and dead tiles
hold exact zeros.

The two kernels round differently on purpose, as their TPU kernels do:
the per-tile one sums the float32 products of the two values, the grouped
one rounds each product to the input dtype first.  The plain versions
:func:`_sddmm_reference` and :func:`_sddmm_grouped_reference` compute the
same as their kernels, in the same layouts; the wrappers
:func:`sddmm_tiles` and :func:`sddmm_grouped` take them for a tensor on
the CPU and launch the kernel for a CUDA tensor (or raise).

:func:`sddmm_edges` is the edge-domain scatter(C) + scatter(R) +
apply_edge(ADD|MUL) block of the ``sddmm`` lowering kind, differentiable.
"""
from __future__ import annotations

from typing import Union

import torch

from ..graph import GraphTensor, GroupedTiledGraph, TiledGraph
from . import _ext
from .spmm import _geometry, _live_slots, _unit_steps

Tiling = Union[TiledGraph, GroupedTiledGraph]


def _check_heads(f: int, heads: int) -> int:
    if heads < 1 or f % heads:
        raise ValueError(f"heads={heads} does not divide F={f}")
    return f // heads


def _sddmm_plain(tg: Tiling, x_src: torch.Tensor, x_dst: torch.Tensor,
                 heads: int, round_prod: bool) -> torch.Tensor:
    """The per-head dots of the live slots, [heads, units, slots per unit]
    float32, zeros elsewhere; ``round_prod`` rounds each float32 product to
    x_src's dtype before the head sum."""
    F = x_src.shape[1]
    P = _check_heads(F, heads)
    n_units, _, per_unit = _geometry(tg)
    out = torch.zeros((n_units, per_unit, heads), dtype=torch.float32,
                      device=x_src.device)
    for u0, u1 in _unit_steps(tg, 2 * F):
        mask, src, dst = _live_slots(tg, u0, u1)
        keep = (src < x_src.shape[0]) & (dst < x_dst.shape[0])
        p = (x_src.index_select(0, src[keep]).float()
             * x_dst.index_select(0, dst[keep]).float())
        if round_prod:
            p = p.to(x_src.dtype).float()
        vals = torch.zeros((int(mask.sum()), heads), dtype=torch.float32,
                           device=x_src.device)
        vals[keep] = p.view(-1, heads, P).sum(dim=2)
        out[u0:u1].view(-1, heads)[mask.reshape(-1)] = vals
    return out.view(n_units, per_unit, heads).permute(2, 0, 1).contiguous()


def _sddmm_reference(tg: TiledGraph, x_src: torch.Tensor,
                     x_dst: torch.Tensor, heads: int = 1) -> torch.Tensor:
    """Plain version of K11: [heads, T, ET] float32, the float32 products of
    each live slot summed per head; pad slots and dead tiles (cb < 0) 0."""
    return _sddmm_plain(tg, x_src, x_dst, heads, round_prod=False)


def _sddmm_grouped_reference(tg: GroupedTiledGraph, x_src: torch.Tensor,
                             x_dst: torch.Tensor,
                             heads: int = 1) -> torch.Tensor:
    """Plain version of K12: [heads, NC, G*ET] float32, each product
    rounded to x_src's dtype before the float32 head sum (the grouped TPU
    kernel's ``(s * d).astype(dt)``)."""
    return _sddmm_plain(tg, x_src, x_dst, heads, round_prod=True)


def _launch(name: str, tg: Tiling, x_src: torch.Tensor, x_dst: torch.Tensor,
            heads: int, units: tuple, geometry: tuple) -> torch.Tensor:
    """Check the inputs of K11 / K12, launch, and return the output: K11
    writes every slot of it, K12 the live slots of a zero-filled one."""
    dev = x_src.device
    _ext.require(x_src, "x_src", dev, (torch.float32, torch.bfloat16), 2)
    _ext.require(x_dst, "x_dst", dev, (x_src.dtype,), 2)
    if x_dst.shape[1] != x_src.shape[1]:
        raise ValueError(f"x_src has {x_src.shape[1]} features, x_dst "
                         f"{x_dst.shape[1]}")
    for k in ("src_local", "dst_local"):
        _ext.require(getattr(tg, k), k, dev, (torch.int16,),
                     tg.src_local.dim())
    for k in units:
        _ext.require(getattr(tg, k), k, dev, (torch.int32,), 1)
    F = x_src.shape[1]
    _check_heads(F, heads)
    k11 = name == "sddmm_tiles"
    if not k11 and F // heads < 32 and 8 * F * 4 > 227 * 1024:
        raise ValueError(f"F={F} with heads narrower than 32: K12's staging "
                         "buffer exceeds shared memory")
    n_units, _, per_unit = _geometry(tg)
    out = (torch.empty if k11 and F else torch.zeros)(
        (heads, n_units, per_unit), dtype=torch.float32, device=dev)
    if F == 0 or n_units == 0:
        return out
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = getattr(lib, f"gta_{name}")(
            *(getattr(tg, k).data_ptr() for k in units),
            tg.src_local.data_ptr(), tg.dst_local.data_ptr(),
            x_src.data_ptr(), x_dst.data_ptr(), _ext.DTYPE_CODE[x_src.dtype],
            out.data_ptr(), *geometry, F, heads, x_src.shape[0],
            x_dst.shape[0], _ext.stream(x_src))
    _ext.check(rc, name)
    return out


def k11_walk() -> str:
    """The walk of K11's last launch, as ``csrc/sddmm_tiles.cu``
    ``sddmm_config`` picked it from (F, heads, dtype, alignment): printed
    by ``chip_smoke.py`` beside K11's times."""
    return _ext.library().gta_sddmm_tiles_walk().decode()


def sddmm_tiles(tg: TiledGraph, x_src: torch.Tensor, x_dst: torch.Tensor,
                heads: int = 1) -> torch.Tensor:
    """K11 wrapper: [heads, T, ET] float32.  x_src and x_dst share one
    dtype (float32 or bfloat16).  The kernel walks each tile's edge prefix
    (the builders' slot order) and writes the zeros of the other slots
    too, so the output is allocated unfilled.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if x_src.device.type == "cpu":
        return _sddmm_reference(tg, x_src, x_dst, heads)
    out = _launch("sddmm_tiles", tg, x_src, x_dst, heads,
                  ("tile_rb", "tile_cb"),
                  (tg.n_tiles, tg.block_rows, tg.block_cols, tg.tile_edges))
    sddmm_tiles.launches += 1
    return out


sddmm_tiles.launches = 0


def sddmm_grouped(tg: GroupedTiledGraph, x_src: torch.Tensor,
                  x_dst: torch.Tensor, heads: int = 1) -> torch.Tensor:
    """K12 wrapper: [heads, NC, G*ET] float32.  x_src and x_dst share one
    dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if x_src.device.type == "cpu":
        return _sddmm_grouped_reference(tg, x_src, x_dst, heads)
    out = _launch("sddmm_grouped", tg, x_src, x_dst, heads,
                  ("chunk_grp", "chunk_cb"),
                  (tg.n_chunks, tg.group, tg.block_rows, tg.block_cols,
                   tg.tile_edges))
    sddmm_grouped.launches += 1
    return out


sddmm_grouped.launches = 0


def _sddmm_grouped(tg: GroupedTiledGraph, x_src: torch.Tensor,
                   x_dst: torch.Tensor, *, heads: int = 1) -> torch.Tensor:
    """The grouped SDDMM (JAX ``_sddmm_grouped``): x_dst takes x_src's
    dtype, then K12."""
    return sddmm_grouped(tg, x_src.contiguous(),
                         x_dst.to(x_src.dtype).contiguous(), heads)


def sddmm(tg: Tiling, x_src: torch.Tensor, x_dst: torch.Tensor, *,
          heads: int = 1) -> torch.Tensor:
    """Per-edge, per-head dots in tile layout, float32: [heads, T, ET] for a
    TiledGraph (K11), [heads, NC, G*ET] for a GroupedTiledGraph (K12).
    Map them to edge order with :func:`tiles_to_edges`.  On a per-tile
    tiling operands of two dtypes both widen to float32 (exact, as the TPU
    kernel's float32 gathers are)."""
    if isinstance(tg, GroupedTiledGraph):
        return _sddmm_grouped(tg, x_src, x_dst, heads=heads)
    if not isinstance(tg, TiledGraph):
        raise NotImplementedError(
            "tile classes (MultiTiledGraph) are not ported yet "
            "(ROADMAP.md Queue 1 item 9)")
    if x_src.dtype != x_dst.dtype:
        x_src, x_dst = x_src.float(), x_dst.float()
    return sddmm_tiles(tg, x_src.contiguous(), x_dst.contiguous(), heads)


def tiles_to_edges(tg: Tiling, vals: torch.Tensor,
                   e_pad: int) -> torch.Tensor:
    """Tile-layout values [heads, units, slots] to edge order [e_pad,
    heads].  Each real edge holds exactly one slot, so only the real slots
    are written; pad slots (which alias the last edge id) are left out."""
    H = vals.shape[0]
    real = ((tg.src_local < tg.block_cols)
            & (tg.dst_local < tg.block_rows)).reshape(-1)
    out = torch.zeros((e_pad, H), dtype=vals.dtype, device=vals.device)
    out[tg.edge_id.reshape(-1)[real].long()] = vals.reshape(H, -1)[:, real].t()
    return out


def edges_to_tiles(tg: Tiling, vals: torch.Tensor) -> torch.Tensor:
    """Per-edge values [e_pad, ...] gathered into the tile layout
    ``tg.edge_id.shape + vals.shape[1:]``."""
    return vals[tg.edge_id.long()]


def _edge_ref(g: GraphTensor, xs: torch.Tensor, xd: torch.Tensor,
              compute: str) -> torch.Tensor:
    """The per-edge take formulation of :func:`sddmm_edges` (JAX
    ``ref_fwd``): float32, padding edges read a zero row."""
    n, F = g.n_node, xs.shape[1]
    src = torch.where(g.edge_mask, g.senders, n)
    dst = torch.where(g.edge_mask, g.receivers, n)
    pad = xs.new_zeros((1, F), dtype=torch.float32)
    s = torch.cat([xs.float(), pad]).index_select(0, src)
    d = torch.cat([xd.float(), pad]).index_select(0, dst)
    if compute == "MUL":
        return s * d
    return torch.where(g.edge_mask[:, None], s + d, 0.0)


class _SddmmEdges(torch.autograd.Function):
    """Forward on K11 / K12; backward by autograd of :func:`_edge_ref`."""

    @staticmethod
    def forward(ctx, x_src, x_dst, tg, g, compute):
        ctx.g, ctx.compute = g, compute
        ctx.save_for_backward(x_src, x_dst)
        F = x_src.shape[1]
        if compute == "MUL":
            ev = sddmm(tg, x_src, x_dst, heads=F)
        else:
            # [a | 1] . [1 | b] = a + b per feature: F heads of width 2
            one_s, one_d = torch.ones_like(x_src), torch.ones_like(x_dst)
            ev = sddmm(tg, torch.stack([x_src, one_s], 2).view(-1, 2 * F),
                       torch.stack([one_d, x_dst], 2).view(-1, 2 * F),
                       heads=F)
        out = tiles_to_edges(tg, ev, g.e_pad)
        return torch.where(g.edge_mask[:, None], out, 0.0)

    @staticmethod
    def backward(ctx, gbar):
        xs, xd = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(r) for t, r in zip((xs, xd),
                                                                 need)]
            y = _edge_ref(ctx.g, *ins, ctx.compute)
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(y, wrt, gbar.float())
                       if wrt else ())
        return (*(next(got) if r else None for r in need), None, None, None)


def sddmm_edges(tg: Tiling, g: GraphTensor, x_src: torch.Tensor,
                x_dst: torch.Tensor, compute: str = "MUL") -> torch.Tensor:
    """Edge-domain scatter(C) + scatter(R) + apply_edge(ADD|MUL) as one
    SDDMM: [e_pad, F] float32 in edge order, 0 on padding edges.  MUL is an
    SDDMM with heads = F (per-head width 1); ADD one over the augmented
    operands [a | 1] . [1 | b] (per-head width 2).  Differentiable in both
    operands; the backward is that of the per-edge take formulation, as in
    the JAX package."""
    if compute not in ("MUL", "ADD"):
        raise ValueError(f"sddmm_edges computes MUL or ADD, not {compute!r}")
    return _SddmmEdges.apply(x_src, x_dst, tg, g, compute)
