"""Dense-adjacency-block kernels and the hybrid (density-split) wrappers.

Counterpart of the JAX package's ``ops/dense.py`` (forward only).  Blocks
whose nnz passes a threshold are stored dense and aggregated block by block;
the sparse remainder runs on the edge-tile kernels; both produce partial
sums over the same rows, which add exactly.

Kernels: K2 ``csrc/spmm_dense_blocks.cu`` (replaces the TPU
``_spmm_dense_kernel`` / ``_spmm_dense_super_kernel``) behind
:func:`spmm_dense_blocks`, and K4 ``csrc/gat_dense_blocks.cu`` (replaces
``_gat_dense_kernel_t`` / ``_gat_dense_kernel``) behind
:func:`gat_dense_blocks`.  Each wrapper takes its plain PyTorch version for a
CPU tensor and launches its kernel for a CUDA tensor, or raises.

The thresholds below are the JAX package's FLOP-balance rules, which were
fitted to the TPU; the port keeps them so both packages build the same
split, until the port's own measurements refit them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph import DenseBlockGraph, GraphTensor, HybridGraph, block_nnz
from . import _ext
from .gat import _gat_forward, _leaky
from .spmm import _PLAIN_CHUNK, spmm

# ---------------------------------------------------------------------------
# dispatch thresholds
# ---------------------------------------------------------------------------


def spmm_dense_threshold(block_rows: int, block_cols: int,
                         fudge: float = 1.0) -> int:
    """nnz per (R, C) block above which the dense block beats edge tiles
    for plain aggregation."""
    r, c = block_rows, block_cols
    return max(int(fudge * r * c / (c + r)), 1)


def gat_dense_threshold(block_rows: int, block_cols: int, heads: int,
                        head_dim: int, fudge: float = 1.0) -> int:
    """nnz threshold for attention over 'rc' blocks."""
    r, c = block_rows, block_cols
    dense = heads * r * c * (max(head_dim, 128) + 256)
    onehot_per_edge = (c + 2 * r) * 128
    return max(int(fudge * dense / onehot_per_edge), 1)


def gat_dense_threshold_t(block_rows: int, block_cols: int, heads: int,
                          head_dim: int, fudge: float = 1.0) -> int:
    """nnz threshold for attention over 'cr' blocks."""
    r, c = block_rows, block_cols
    dense = r * c * (max(heads * head_dim, 128) + heads * 256)
    onehot_per_edge = (c + 2 * r) * 128
    return max(int(fudge * dense / onehot_per_edge), 1)


DENSE_BLOCK = 256          # dense grid of the hybrid recipe
DENSE_BUDGET = 2 << 30     # dense-value byte budget per direction


def hybrid_threshold(hg, kind: str, *, heads: int = 1, head_dim: int = 128,
                     dense_rows: int = DENSE_BLOCK,
                     dense_cols: int = DENSE_BLOCK,
                     budget: int = DENSE_BUDGET,
                     value_bytes: int = 1) -> int:
    """The nnz/block dense threshold of the hybrid recipe: the balance rule
    per kind, raised until the dense value store fits ``budget`` bytes."""
    rb, cb = dense_rows, dense_cols
    if kind == "gat":
        thr = gat_dense_threshold_t(rb, cb, heads, head_dim)
    else:
        thr = spmm_dense_threshold(rb, cb,
                                   fudge=0.5 if value_bytes == 1 else 1.0)
    bn = np.sort(block_nnz(hg, rb, cb).reshape(-1))[::-1]
    max_blocks = max(budget // (rb * cb * value_bytes), 1)
    if len(bn) > max_blocks:
        thr = max(thr, int(bn[max_blocks - 1]) + 1)
    return thr


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[: t.shape[0]] = t
    return out


# ---------------------------------------------------------------------------
# dense SpMM: Y_rb += A_b @ X_cb  (K2)
# ---------------------------------------------------------------------------


def _require_blocks(bg: DenseBlockGraph, dev: torch.device) -> None:
    for name in ("blk_cb", "row_blocks"):
        _ext.require(getattr(bg, name), name, dev, (torch.int32,), 1)
    _ext.require(bg.segments, "segments", dev, (torch.int32,), 2)


def _spmm_dense_reference(bg: DenseBlockGraph, x: torch.Tensor,
                          values: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: [n_rows, F] float32, zero on unvisited rows."""
    R, C = bg.block_rows, bg.block_cols
    F = x.shape[1]
    xp = _pad_rows(x, bg.n_col_blocks * C).view(bg.n_col_blocks, C, F)
    y = torch.zeros((bg.n_row_blocks, R, F), dtype=torch.float32,
                    device=x.device)
    step = max(1, _PLAIN_CHUNK // (R * max(C, F)))
    for b0 in range(0, bg.n_blocks, step):
        a = values[b0:b0 + step].float()
        xb = xp[bg.blk_cb[b0:b0 + step].long()].float()
        y.index_add_(0, bg.blk_rb[b0:b0 + step].long(), torch.bmm(a, xb))
    return y.view(bg.n_row_blocks * R, F)


def spmm_dense_blocks(bg: DenseBlockGraph, x: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: sum over the dense blocks of A_b @ X_cb, [n_rows, F]
    float32 with zeros on row stripes that no block visits.  ``values``
    [B, R, C] ('rc' layout) holds int8 counts or is of x's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return _spmm_dense_reference(bg, x, values)
    dev = x.device
    _ext.require(x, "x", dev, (torch.float32, torch.bfloat16), 2)
    _ext.require(values, "values", dev, (torch.int8, x.dtype), 3)
    _require_blocks(bg, dev)
    R, C = bg.block_rows, bg.block_cols
    if tuple(values.shape) != (bg.n_blocks, R, C):
        raise ValueError(f"values shape {tuple(values.shape)} != "
                         f"{(bg.n_blocks, R, C)}")
    F = x.shape[1]
    n_rows = bg.n_row_blocks * R
    # segments add their partial stripes atomically: unvisited rows stay 0
    y = torch.zeros((n_rows, F), dtype=torch.float32, device=dev)
    n_seg = int(bg.segments.shape[0])
    if F == 0 or n_seg == 0:
        return y
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_spmm_dense_blocks(
            bg.segments.data_ptr(), bg.row_blocks.data_ptr(),
            bg.blk_cb.data_ptr(), values.data_ptr(),
            _ext.DTYPE_CODE[values.dtype], x.data_ptr(),
            _ext.DTYPE_CODE[x.dtype], y.data_ptr(), n_seg, R, C, F,
            x.shape[0], n_rows, _ext.stream(x))
    _ext.check(rc, "spmm_dense_blocks")
    spmm_dense_blocks.launches += 1
    return y


spmm_dense_blocks.launches = 0


def spmm_dense(bg: DenseBlockGraph, x: torch.Tensor, *,
               row_scale: Optional[torch.Tensor] = None,
               col_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[r] = sum_c A[r, c] x[c] over the dense blocks: [n_rows_padded, F]
    float32, zero on rows the dense set never touches.  ``row_scale`` /
    ``col_scale`` ([n_node]) recover separable weights when ``bg.values``
    holds int8 counts: the result is diag(rs) A diag(cs) x."""
    if bg.values_layout != "rc":
        raise ValueError(f"spmm_dense needs 'rc' blocks, got "
                         f"{bg.values_layout!r}")
    if col_scale is not None:
        x = x * col_scale[:, None].to(x.dtype)
    a = bg.values if _is_int(bg.values) else bg.values.to(x.dtype)
    y = spmm_dense_blocks(bg, x.contiguous(), a.contiguous())
    if row_scale is not None:
        y = y * _pad_rows(row_scale.float(), y.shape[0])[:, None]
    return y


# ---------------------------------------------------------------------------
# dense masked attention partials (K4)
# ---------------------------------------------------------------------------


def _gat_dense_reference(bg: DenseBlockGraph, h: torch.Tensor,
                         values: torch.Tensor, a_src: torch.Tensor,
                         a_dst: torch.Tensor, msrc: torch.Tensor,
                         negative_slope: float = 0.2) -> torch.Tensor:
    """Plain version of K4: [n_rows, HD + H] float32 [num | den] partials;
    p rounds to h's dtype before the num product, den sums unrounded p."""
    R, C = bg.block_rows, bg.block_cols
    H = a_dst.shape[1]
    HD = h.shape[1]
    D = HD // H
    CB, RB = bg.n_col_blocks, bg.n_row_blocks
    hp = _pad_rows(h, CB * C).view(CB, C, HD)
    asp = _pad_rows(a_src.float(), CB * C).view(CB, C, H)
    adp = _pad_rows(a_dst.float(), RB * R).view(RB, R, H)
    ms = msrc.float().reshape(1, 1, H)
    acc = torch.zeros((RB, R, HD + H), dtype=torch.float32, device=h.device)
    step = max(1, _PLAIN_CHUNK // (R * C * max(H, 1)))
    for b0 in range(0, bg.n_blocks, step):
        cb = bg.blk_cb[b0:b0 + step].long()
        rb = bg.blk_rb[b0:b0 + step].long()
        cnt = values[b0:b0 + step].float()
        if bg.values_layout == "cr":
            cnt = cnt.transpose(1, 2)                          # [b, R, C]
        a_d = adp[rb]                                          # [b, R, H]
        bound = _leaky(ms + a_d, negative_slope)[:, :, None, :]
        e = _leaky(asp[cb][:, None, :, :] + a_d[:, :, None, :],
                   negative_slope)                             # [b, R, C, H]
        p = cnt[..., None] * torch.exp(torch.clamp(e - bound, max=60.0))
        den = p.sum(dim=2)                                     # [b, R, H]
        pr = p.to(h.dtype).float() if h.dtype != torch.float32 else p
        hb = hp[cb].float().view(-1, C, H, D)
        num = torch.einsum("brch,bchd->brhd", pr, hb).reshape(-1, R, HD)
        acc.index_add_(0, rb, torch.cat([num, den], dim=2))
    return acc.view(RB * R, HD + H)


def gat_dense_blocks(bg: DenseBlockGraph, h: torch.Tensor,
                     values: torch.Tensor, a_src: torch.Tensor,
                     a_dst: torch.Tensor, msrc: torch.Tensor,
                     negative_slope: float = 0.2) -> torch.Tensor:
    """K4 wrapper: [num | den] partials [n_rows, HD + H] float32 over the
    dense blocks in either layout, zero on unvisited row stripes.
    ``values`` holds int8 counts or is of h's dtype; ``a_src`` / ``a_dst``
    [N, H] and ``msrc`` [1, H] are float32.  CPU tensors take the plain
    version; CUDA tensors launch or raise."""
    if h.device.type == "cpu":
        return _gat_dense_reference(bg, h, values, a_src, a_dst, msrc,
                                    negative_slope)
    dev = h.device
    H = a_dst.shape[1]
    HD = h.shape[1]
    _ext.require(h, "h", dev, (torch.float32, torch.bfloat16), 2)
    _ext.require(values, "values", dev, (torch.int8, h.dtype), 3)
    for name, t in (("a_src", a_src), ("a_dst", a_dst), ("msrc", msrc)):
        _ext.require(t, name, dev, (torch.float32,), 2)
    _require_blocks(bg, dev)
    R, C = bg.block_rows, bg.block_cols
    shape = (bg.n_blocks, C, R) if bg.values_layout == "cr" else (
        bg.n_blocks, R, C)
    if tuple(values.shape) != shape:
        raise ValueError(f"values shape {tuple(values.shape)} != {shape}")
    if HD % H or a_src.shape[1] != H or tuple(msrc.shape) != (1, H):
        raise ValueError(f"inconsistent heads: h {tuple(h.shape)}, a_src "
                         f"{tuple(a_src.shape)}, msrc {tuple(msrc.shape)}")
    n_rows = bg.n_row_blocks * R
    # segments add their partials atomically: unvisited rows stay 0
    out = torch.zeros((n_rows, HD + H), dtype=torch.float32, device=dev)
    n_seg = int(bg.segments.shape[0])
    if n_seg == 0:
        return out
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_gat_dense_blocks(
            bg.segments.data_ptr(), bg.row_blocks.data_ptr(),
            bg.blk_cb.data_ptr(), values.data_ptr(),
            _ext.DTYPE_CODE[values.dtype], int(bg.values_layout == "cr"),
            h.data_ptr(), _ext.DTYPE_CODE[h.dtype], a_src.data_ptr(),
            a_dst.data_ptr(), msrc.data_ptr(), out.data_ptr(),
            n_seg, R, C, HD, H, h.shape[0], a_dst.shape[0], n_rows,
            float(negative_slope), _ext.stream(h))
    _ext.check(rc, "gat_dense_blocks")
    gat_dense_blocks.launches += 1
    return out


gat_dense_blocks.launches = 0


def gat_dense_partial(bg: DenseBlockGraph, h_src: torch.Tensor,
                      a_src: torch.Tensor, a_dst: torch.Tensor,
                      msrc: torch.Tensor, *,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """[num | den] partial sums over the dense blocks, [n_rows, HD + H]
    float32.  ``msrc`` [1, H] must be the shift bound the edge-tile kernel
    uses so the partials add exactly.  Float blocks round to h's dtype."""
    H = a_dst.shape[1]
    vals = (bg.values if _is_int(bg.values)
            else bg.values.to(h_src.dtype)).contiguous()
    return gat_dense_blocks(bg, h_src.contiguous(), vals,
                            a_src.float().contiguous(),
                            a_dst.float().contiguous(),
                            msrc.float().reshape(1, H).contiguous(),
                            negative_slope)


def gat_dense_partial_t(bg: DenseBlockGraph, h_src, a_src, a_dst, msrc, *,
                        negative_slope: float = 0.2) -> torch.Tensor:
    """The JAX package's transposed layout of :func:`gat_dense_partial`:
    [HD + H, n_rows], for 'cr' blocks."""
    if bg.values_layout != "cr":
        raise ValueError("gat_dense_partial_t needs 'cr' blocks")
    return gat_dense_partial(bg, h_src, a_src, a_dst, msrc,
                             negative_slope=negative_slope).T


# ---------------------------------------------------------------------------
# full-graph plain formulations and the hybrid wrappers
# ---------------------------------------------------------------------------


def _spmm_ref_g(g: GraphTensor, x: torch.Tensor,
                weighted: bool = True) -> torch.Tensor:
    """Full-graph segment formulation of weighted SpMM: [N, F] float32."""
    n = g.n_node
    src = torch.where(g.edge_mask, g.senders, n)
    dst = torch.where(g.edge_mask, g.receivers, n)
    xt = _pad_rows(x.float(), n + 1)
    w = g.edge_weight if weighted else g.edge_mask.float()
    msg = xt.index_select(0, src) * w[:, None]
    return torch.zeros_like(xt).index_add_(0, dst, msg)[:n]


def _gat_reference_g(g: GraphTensor, h, a_src, a_dst, slope,
                     weighted: bool = True) -> torch.Tensor:
    """Full-graph segment formulation of GAT attention with the exact
    per-row max.  ``weighted=False`` drops the edge weights from the
    softmax terms, the semantics of every attention kernel."""
    n = g.n_node
    H = a_src.shape[1]
    HD = h.shape[1]
    D = HD // H
    src = torch.where(g.edge_mask, g.senders, n)
    dst = torch.where(g.edge_mask, g.receivers, n)
    asr = _pad_rows(a_src.float(), n + 1)
    ads = _pad_rows(a_dst.float(), n + 1)
    hsx = _pad_rows(h.float(), n + 1)
    w = (g.edge_weight if weighted else g.edge_mask.float())[:, None]
    mask = g.edge_mask[:, None]
    e = _leaky(asr.index_select(0, src) + ads.index_select(0, dst), slope)
    e = torch.where(mask, e, torch.full_like(e, -1e30))
    m = torch.full((n + 1, H), float("-inf"), dtype=torch.float32,
                   device=h.device)
    m = m.scatter_reduce_(0, dst[:, None].expand_as(e), e, "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(e - m.index_select(0, dst)),
                    torch.zeros_like(e)) * w
    den = torch.zeros((n + 1, H), dtype=torch.float32,
                      device=h.device).index_add_(0, dst, p)
    num = torch.zeros((n + 1, HD), dtype=torch.float32,
                      device=h.device).index_add_(
        0, dst, p.repeat_interleave(D, dim=1) * hsx.index_select(0, src))
    out = num / torch.clamp(den, min=1e-20).repeat_interleave(D, dim=1)
    return out[:n]


def spmm_hybrid(hyb: HybridGraph, g: Optional[GraphTensor], x: torch.Tensor,
                *, weighted: bool = True) -> torch.Tensor:
    """Density-split SpMM, [N, F] float32: the edge tail on K1 plus the
    dense blocks on K2 (with the separable scales when the blocks hold
    counts).  ``g`` and ``weighted`` serve the backward, not ported yet
    (ROADMAP.md Queue 1 item 4)."""
    y = spmm(hyb.tiles, x)
    if hyb.dense is not None:
        yd = spmm_dense(hyb.dense, x, row_scale=hyb.row_scale,
                        col_scale=hyb.col_scale)
        y = y + yd[: y.shape[0]]
    return y


def _a_s_kernel(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a_src at the tail kernel's precision (operands in h's dtype, f32
    sum): msrc and the dense partial must see the logits the tail derives."""
    return h.float() @ w.to(h.dtype).float()


def gat_hybrid(hyb: HybridGraph, g: Optional[GraphTensor],
               h_src: torch.Tensor, a_src: Optional[torch.Tensor],
               a_dst: torch.Tensor, *, negative_slope: float = 0.2,
               w_asrc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Density-split GAT attention, [N, HD] float32.  The tail (K3) and the
    dense blocks (K4) accumulate raw [num | den] under ONE shift bound (the
    global per-head max of a_src), so the combine is one add and divide.
    ``w_asrc`` [HD, H] replaces ``a_src`` when a_src is a linear map of h:
    the tail derives a_s in-kernel and msrc and the dense partial use the
    same-precision values.  The backward is ROADMAP.md Queue 2 #6-#9."""
    H = a_dst.shape[1]
    HD = h_src.shape[1]
    D = HD // H
    sv = _a_s_kernel(h_src, w_asrc) if w_asrc is not None else a_src
    msrc = sv.float().amax(0, keepdim=True)
    acc = _gat_forward(hyb.tiles, h_src,
                       None if w_asrc is not None else a_src, a_dst,
                       w_asrc=w_asrc, negative_slope=negative_slope,
                       normalize=False, msrc=msrc)
    if hyb.dense is not None:
        accd = gat_dense_partial(hyb.dense, h_src, sv, a_dst, msrc,
                                 negative_slope=negative_slope)
        acc = acc + accd[: acc.shape[0]]
    num, den = acc[:, :HD], acc[:, HD:]
    return num / torch.clamp(den, min=1e-20).repeat_interleave(D, dim=1)
