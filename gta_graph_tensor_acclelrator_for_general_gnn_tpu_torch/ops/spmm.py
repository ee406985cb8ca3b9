"""Block-sparse edge-tile SpMM: ``y[r] = sum over edges (s -> r) of w_e x[s]``.

Counterpart of the JAX package's ``ops/spmm.py`` (forward only).  The
kernel is K1 ``csrc/spmm_tiles.cu``, the Hopper replacement of the TPU
one-hot kernel ``_spmm_kernel``; :func:`_spmm_reference` is its plain
PyTorch version over the same tile arrays.  :func:`spmm_tiles` takes the
plain version for a tensor on the CPU and launches the kernel for a CUDA
tensor (or raises).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph import TiledGraph
from . import _ext

# f32 elements per chunk of the plain versions' per-slot temporaries
_PLAIN_CHUNK = 1 << 26


def _tile_weight(tg: TiledGraph, edge_vals: Optional[torch.Tensor]):
    """Tile weights, times runtime per-edge values gathered into tile
    layout when given."""
    if edge_vals is None:
        return tg.weight
    return tg.weight.float() * edge_vals.float()[tg.edge_id.long()]


def _spmm_reference(tg: TiledGraph, x: torch.Tensor,
                    edge_vals: Optional[torch.Tensor] = None, *,
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1 over the same tile arrays: [n_node, F] float32.

    It computes what the TPU kernel computes: dead tiles (cb < 0) and pad
    slots add nothing, and each w*x[s] rounds to x's dtype before the f32
    sum.  (The JAX package's XLA twin skips neither rounding nor dead tiles
    with nonzero weights; on builder output the two agree in float32.)"""
    w = _tile_weight(tg, edge_vals) if weight is None else weight
    R, C, ET = tg.block_rows, tg.block_cols, tg.tile_edges
    F = x.shape[1]
    y = torch.zeros((tg.n_row_blocks * R, F), dtype=torch.float32,
                    device=x.device)
    step = max(1, _PLAIN_CHUNK // max(ET * F, 1))
    for t0 in range(0, tg.n_tiles, step):
        t1 = t0 + step
        cb = tg.tile_cb[t0:t1].long()[:, None]
        rb = tg.tile_rb[t0:t1].long()[:, None]
        sl = tg.src_local[t0:t1].long()
        dl = tg.dst_local[t0:t1].long()
        valid = (cb >= 0) & (sl < C) & (dl < R)
        src = (cb * C + sl)[valid]
        dst = (rb * R + dl)[valid]
        msg = x.index_select(0, src).float() * w[t0:t1].float()[valid][:, None]
        if x.dtype != torch.float32:
            msg = msg.to(x.dtype).float()
        y.index_add_(0, dst, msg)
    return y[: tg.n_node]


def spmm_tiles(tg: TiledGraph, x: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: [n_node, F] float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, which reads ``weight``
    ([T, ET] float32 or bfloat16) in place of ``tg.weight``."""
    if x.device.type == "cpu":
        return _spmm_reference(tg, x, weight=weight)
    dev = x.device
    _ext.require(x, "x", dev, (torch.float32, torch.bfloat16), 2)
    _ext.require(weight, "weight", dev, (torch.float32, torch.bfloat16), 2)
    for name in ("src_local", "dst_local"):
        _ext.require(getattr(tg, name), name, dev, (torch.int16,), 2)
    for name in ("tile_rb", "tile_cb"):
        _ext.require(getattr(tg, name), name, dev, (torch.int32,), 1)
    if tuple(weight.shape) != (tg.n_tiles, tg.tile_edges):
        raise ValueError(f"weight shape {tuple(weight.shape)} != "
                         f"{(tg.n_tiles, tg.tile_edges)}")
    F = x.shape[1]
    # the kernel adds into y with atomics: rows without edges stay 0
    y = torch.zeros((tg.n_node, F), dtype=torch.float32, device=dev)
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


def spmm(tg: TiledGraph, x: torch.Tensor,
         edge_vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-sparse SpMM forward, ``y`` [n_node, F] float32 (the JAX
    package's ``spmm`` / ``_spmm_raw``; the transposed-tiling backward is
    not ported yet, ROADMAP.md Queue 1 item 4).  ``edge_vals`` ([e_pad])
    multiplies the tile weights per edge."""
    return spmm_tiles(tg, x.contiguous(),
                      _tile_weight(tg, edge_vals).contiguous())
