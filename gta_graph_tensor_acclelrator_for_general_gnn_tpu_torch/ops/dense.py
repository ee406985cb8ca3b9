"""Dense-adjacency-block kernels and the hybrid (density-split) wrappers.

Counterpart of the JAX package's ``ops/dense.py``.  Blocks whose nnz
passes a threshold are stored dense and aggregated block by block; the
sparse remainder runs on the edge-tile kernels; both produce partial sums
over the same rows, which add exactly.  The hybrid wrappers are autograd
Functions whose backward runs on kernels over the transposed graph's split.

Kernels: K2 ``csrc/spmm_dense_blocks.cu`` (replaces the TPU
``_spmm_dense_kernel`` / ``_spmm_dense_super_kernel``) behind
:func:`spmm_dense_blocks`; K4 ``csrc/gat_dense_blocks.cu`` (replaces
``_gat_dense_kernel_t`` / ``_gat_dense_kernel``) behind
:func:`gat_dense_blocks`; K15, the exp-panel mode of the same source
(replaces ``_gat_dense_kernel_t2``), behind :func:`gat_dense_panel_blocks`
when ``DENSE_EXP_PANEL`` is set; K7 ``csrc/gat_dense_bwd_dad.cu`` (replaces
``_gat_dense_bwd_dad_kernel``) behind :func:`gat_dense_bwd_dad`; K8
``csrc/gat_dense_bwd_src.cu`` (replaces ``_gat_dense_bwd_src_kernel``)
behind :func:`gat_dense_bwd_src`.  Each wrapper takes its plain PyTorch
version for a CPU tensor and launches its kernel for a CUDA tensor, or
raises.

The thresholds below are the JAX package's FLOP-balance rules, which were
fitted to the TPU; the port keeps them so both packages build the same
split, until the port's own measurements refit them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..compiler.schedule import (_dense_attention_smem, _dense_bwd_smem,
                                 _gat_wgmma_width, _spmm_dense_smem)
from ..graph import (DENSE_SEGMENT, DENSE_WIDE_SEGMENT, DenseBlockGraph,
                     GraphTensor, HybridGraph, TiledGraph, block_nnz)
from ..utils.spans import count, spanned
from . import _ext
from .gat import _edge_grad, _gat_forward, _leaky
from .primitives import exp_f64
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


def _aligned_rows(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it padded with zero features to a multiple of 8:
    the bf16 path of K2 copies 16-byte pieces of x rows."""
    F = x.shape[1]
    if F % 8 == 0 and x.data_ptr() % 16 == 0:
        return x
    xp = x.new_zeros((x.shape[0], -(-F // 8) * 8))
    xp[:, :F] = x
    return xp


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
    bf16 = x.dtype == torch.bfloat16
    if bf16 and C % (16 // values.element_size()):
        raise ValueError(f"K2's bf16 path copies 16-byte pieces of count "
                         f"rows: block_cols {C} must be a multiple of "
                         f"{16 // values.element_size()}")
    F = x.shape[1]
    n_rows = bg.n_row_blocks * R
    # segments add their partial stripes atomically: unvisited rows stay 0
    y = torch.zeros((n_rows, F), dtype=torch.float32, device=dev)
    segs, seg_cap = ((bg.wide_segments, DENSE_WIDE_SEGMENT) if bf16
                     else (bg.segments, DENSE_SEGMENT))
    _ext.require(segs, "segments", dev, (torch.int32,), 2)
    n_seg = int(segs.shape[0])
    if F == 0 or n_seg == 0:
        return y
    xk = _aligned_rows(x) if bf16 else x
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_spmm_dense_blocks(
            segs.data_ptr(), bg.row_blocks.data_ptr(),
            bg.blk_cb.data_ptr(), values.data_ptr(),
            _ext.DTYPE_CODE[values.dtype], xk.data_ptr(),
            _ext.DTYPE_CODE[x.dtype], y.data_ptr(), n_seg, seg_cap, R, C, F,
            xk.shape[1], x.shape[0], n_rows,
            _spmm_dense_smem(F, x.element_size(), values.element_size()),
            _ext.stream(x))
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


def sddmm_dense_blocks(bg: DenseBlockGraph, x_src: torch.Tensor,
                       x_dst: torch.Tensor) -> torch.Tensor:
    """Dense-block SDDMM: the logit matrix ``E_b = Xd_rb @ Xs_cb^T`` of
    every block, [B, R, C] in x_src's dtype (float32 sums, rounded once);
    ``bg.values != 0`` is the edge mask.  'rc' blocks only.  A batched
    product, which the JAX package leaves to XLA: plain torch here, no
    kernel of its own.  Operands of two dtypes multiply in float32."""
    if bg.values_layout != "rc":
        raise ValueError(f"sddmm_dense_blocks needs 'rc' blocks, got "
                         f"{bg.values_layout!r}")
    R, C, F = bg.block_rows, bg.block_cols, x_src.shape[1]
    xs, xd = x_src, x_dst
    if xs.dtype != xd.dtype:
        xs, xd = xs.float(), xd.float()
    src_p = _pad_rows(xs, bg.n_col_blocks * C).view(
        bg.n_col_blocks, C, F)[bg.blk_cb.long()]
    dst_p = _pad_rows(xd, bg.n_row_blocks * R).view(
        bg.n_row_blocks, R, F)[bg.blk_rb.long()]
    return torch.bmm(dst_p, src_p.transpose(1, 2)).to(x_src.dtype)


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
        p = cnt[..., None] * exp_f64(torch.clamp(e - bound, max=60.0))
        den = p.sum(dim=2)                                     # [b, R, H]
        pr = p.to(h.dtype).float() if h.dtype != torch.float32 else p
        hb = hp[cb].float().view(-1, C, H, D)
        num = torch.einsum("brch,bchd->brhd", pr, hb).reshape(-1, R, HD)
        acc.index_add_(0, rb, torch.cat([num, den], dim=2))
    return acc.view(RB * R, HD + H)


def _dense_attention_split(bg: DenseBlockGraph, h: torch.Tensor, H: int):
    """What K4's and K15's launches take besides their inputs: (the zeroed
    [n_rows, HD + H] output, the segments, their cap, the wgmma path's h
    panel scratch, its leading dimension); segments None when there is
    nothing to launch.  bf16 h at the wgmma head shapes (``_gat_wgmma_width``)
    runs on the wide segments with the panel, h transposed, each head's D
    features on N rows, every column block's columns (the kernel fills it);
    other shapes on the 8-block segments."""
    R, C = bg.block_rows, bg.block_cols
    HD = h.shape[1]
    # segments add their partials atomically: unvisited rows stay 0
    out = torch.zeros((bg.n_row_blocks * R, HD + H), dtype=torch.float32,
                      device=h.device)
    N = _gat_wgmma_width(H, HD // H) if h.dtype == torch.bfloat16 else 0
    if N and (R % 16 or C % 16):
        raise ValueError(f"the bf16 dense-attention path copies 16-byte "
                         f"pieces of count rows: block_rows {R} and "
                         f"block_cols {C} must be multiples of 16")
    segs, seg_cap = ((bg.wide_segments, DENSE_WIDE_SEGMENT) if N
                     else (bg.segments, DENSE_SEGMENT))
    _ext.require(segs, "segments", h.device, (torch.int32,), 2)
    if int(segs.shape[0]) == 0:
        return out, None, seg_cap, None, 0
    ld = -(-max(bg.n_col_blocks * C, h.shape[0]) // 8) * 8
    panel = (torch.empty((H * N, ld), dtype=h.dtype, device=h.device) if N
             else None)
    return out, segs, seg_cap, panel, ld


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
    out, segs, seg_cap, panel, ld = _dense_attention_split(bg, h, H)
    if segs is None:
        return out
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_gat_dense_blocks(
            segs.data_ptr(), bg.row_blocks.data_ptr(),
            bg.blk_cb.data_ptr(), values.data_ptr(),
            _ext.DTYPE_CODE[values.dtype], int(bg.values_layout == "cr"),
            h.data_ptr(), _ext.DTYPE_CODE[h.dtype],
            None if panel is None else panel.data_ptr(), ld,
            a_src.data_ptr(), a_dst.data_ptr(), msrc.data_ptr(),
            out.data_ptr(), int(segs.shape[0]), seg_cap, R, C, HD, H,
            h.shape[0], a_dst.shape[0], out.shape[0],
            _dense_attention_smem(HD, H, h.element_size(), False,
                                  values.element_size()),
            float(negative_slope), _ext.stream(h))
    _ext.check(rc, "gat_dense_blocks")
    gat_dense_blocks.launches += 1
    return out


gat_dense_blocks.launches = 0


# The JAX package's exp-panel variant of the 'cr' dense partial (its
# _gat_dense_kernel_t2, off by default there: measured slower on the TPU).
# When set, gat_dense_partial of 'cr' blocks runs K15 on per-node exp
# panels instead of K4's per-cell exp; read at call time, like JAX's flag.
DENSE_EXP_PANEL = False


def exp_panels(a_src: torch.Tensor, a_dst: torch.Tensor, msrc: torch.Tensor,
               n_cols: int, n_rows: int, negative_slope: float = 0.2):
    """The per-node panels of K15, float32, as the JAX package builds them:
    ``pan_s`` [n_cols, 2H] = [exp(a_s - msrc) | exp(slope (a_s - msrc))]
    and ``pan_d`` [n_rows, 3H] = [exp(msrc + a_d - bound) | exp(slope (msrc
    + a_d) - bound) | a_d] with bound = leaky(msrc + a_d).  Every exponent
    is <= 0 on real nodes; the pad entries are 0, not exp(-msrc), which
    for msrc < 0 could overflow and make inf * 0 = nan under the mask."""
    sl = float(negative_slope)
    a_s32, a_d32 = a_src.float(), a_dst.float()
    ms = msrc.float().reshape(1, -1)
    t = ms + a_d32
    bound = torch.where(t >= 0, t, sl * t)
    pans = torch.cat([exp_f64(a_s32 - ms), exp_f64(sl * (a_s32 - ms))],
                     dim=1)
    pand = torch.cat([exp_f64(t - bound), exp_f64(sl * t - bound), a_d32],
                     dim=1)
    return (_pad_rows(pans, max(n_cols, pans.shape[0])).contiguous(),
            _pad_rows(pand, max(n_rows, pand.shape[0])).contiguous())


def _gat_dense_panel_reference(bg: DenseBlockGraph, h: torch.Tensor,
                               values: torch.Tensor, a_src: torch.Tensor,
                               pan_s: torch.Tensor,
                               pan_d: torch.Tensor) -> torch.Tensor:
    """Plain version of K15: [n_rows, HD + H] float32 [num | den] partials
    with p = count * (a_s[c] + a_d[r] >= 0 ? E1s[c] E1d[r] : E2s[c] E2d[r]);
    p rounds to h's dtype before the num product, den sums unrounded p."""
    R, C = bg.block_rows, bg.block_cols
    H = a_src.shape[1]
    HD = h.shape[1]
    D = HD // H
    CB, RB = bg.n_col_blocks, bg.n_row_blocks
    hp = _pad_rows(h, CB * C).view(CB, C, HD)
    asp = _pad_rows(a_src.float(), CB * C).view(CB, C, H)
    psp = _pad_rows(pan_s.float()[: CB * C], CB * C).view(CB, C, 2 * H)
    pdp = _pad_rows(pan_d.float()[: RB * R], RB * R).view(RB, R, 3 * H)
    acc = torch.zeros((RB, R, HD + H), dtype=torch.float32, device=h.device)
    step = max(1, _PLAIN_CHUNK // (R * C * max(H, 1)))
    for b0 in range(0, bg.n_blocks, step):
        cb = bg.blk_cb[b0:b0 + step].long()
        rb = bg.blk_rb[b0:b0 + step].long()
        cnt = values[b0:b0 + step].float()
        if bg.values_layout == "cr":
            cnt = cnt.transpose(1, 2)                          # [b, R, C]
        ps, pd = psp[cb][:, None], pdp[rb][:, :, None]        # [b, 1|R, C|1, .]
        pos = asp[cb][:, None] + pd[..., 2 * H:] >= 0         # [b, R, C, H]
        p = cnt[..., None] * torch.where(pos, ps[..., :H] * pd[..., :H],
                                         ps[..., H:] * pd[..., H:2 * H])
        den = p.sum(dim=2)                                     # [b, R, H]
        pr = p.to(h.dtype).float() if h.dtype != torch.float32 else p
        hb = hp[cb].float().view(-1, C, H, D)
        num = torch.einsum("brch,bchd->brhd", pr, hb).reshape(-1, R, HD)
        acc.index_add_(0, rb, torch.cat([num, den], dim=2))
    return acc.view(RB * R, HD + H)


def gat_dense_panel_blocks(bg: DenseBlockGraph, h: torch.Tensor,
                           values: torch.Tensor, a_src: torch.Tensor,
                           pan_s: torch.Tensor,
                           pan_d: torch.Tensor) -> torch.Tensor:
    """K15 wrapper: K4's [num | den] partials [n_rows, HD + H] float32 from
    the exp panels of :func:`exp_panels` (``pan_s`` [n_cols, 2H], ``pan_d``
    [n_rows, 3H], float32); ``a_src`` [N, H] float32 still gives each cell's
    branch.  ``values`` holds int8 counts or is of h's dtype.  bf16 ``h`` at
    K4's wgmma head shapes runs on K4's tensor-core kernel in its panel mode
    over ``bg.wide_segments``; float32 and other shapes on the 8-block
    segments, as K4.  CPU tensors take the plain version; CUDA tensors
    launch or raise."""
    if h.device.type == "cpu":
        return _gat_dense_panel_reference(bg, h, values, a_src, pan_s, pan_d)
    dev = h.device
    H = a_src.shape[1]
    HD = h.shape[1]
    _ext.require(h, "h", dev, (torch.float32, torch.bfloat16), 2)
    _ext.require(values, "values", dev, (torch.int8, h.dtype), 3)
    for name, t in (("a_src", a_src), ("pan_s", pan_s), ("pan_d", pan_d)):
        _ext.require(t, name, dev, (torch.float32,), 2)
    _require_blocks(bg, dev)
    R, C = bg.block_rows, bg.block_cols
    shape = (bg.n_blocks, C, R) if bg.values_layout == "cr" else (
        bg.n_blocks, R, C)
    if tuple(values.shape) != shape:
        raise ValueError(f"values shape {tuple(values.shape)} != {shape}")
    if HD % H or pan_s.shape[1] != 2 * H or pan_d.shape[1] != 3 * H:
        raise ValueError(f"inconsistent heads: h {tuple(h.shape)}, a_src "
                         f"{tuple(a_src.shape)}, pan_s {tuple(pan_s.shape)}, "
                         f"pan_d {tuple(pan_d.shape)}")
    out, segs, seg_cap, panel, ld = _dense_attention_split(bg, h, H)
    if segs is None:
        return out
    lib = _ext.library()
    with torch.cuda.device(dev):
        rc = lib.gta_gat_dense_panel(
            segs.data_ptr(), bg.row_blocks.data_ptr(),
            bg.blk_cb.data_ptr(), values.data_ptr(),
            _ext.DTYPE_CODE[values.dtype], int(bg.values_layout == "cr"),
            h.data_ptr(), _ext.DTYPE_CODE[h.dtype],
            None if panel is None else panel.data_ptr(), ld,
            a_src.data_ptr(), pan_s.data_ptr(), pan_d.data_ptr(),
            out.data_ptr(), int(segs.shape[0]), seg_cap, R, C, HD, H,
            h.shape[0], a_src.shape[0], pan_s.shape[0], pan_d.shape[0],
            out.shape[0],
            _dense_attention_smem(HD, H, h.element_size(), True,
                                  values.element_size()),
            _ext.stream(h))
    _ext.check(rc, "gat_dense_panel")
    gat_dense_panel_blocks.launches += 1
    return out


gat_dense_panel_blocks.launches = 0


def _block_values(bg: DenseBlockGraph, dt: torch.dtype) -> torch.Tensor:
    """The blocks' values as the attention kernels read them: int8 counts
    as they are, float values rounded to h's dtype ``dt``."""
    return (bg.values if _is_int(bg.values) else bg.values.to(dt)
            ).contiguous()


def gat_dense_partial(bg: DenseBlockGraph, h_src: torch.Tensor,
                      a_src: torch.Tensor, a_dst: torch.Tensor,
                      msrc: torch.Tensor, *,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """[num | den] partial sums over the dense blocks, [n_rows, HD + H]
    float32.  ``msrc`` [1, H] must be the shift bound the edge-tile kernel
    uses so the partials add exactly.  Float blocks round to h's dtype.
    'cr' blocks run K15 on exp panels when ``DENSE_EXP_PANEL`` is set (the
    JAX package's ``gat_dense_partial_t`` branch), else K4."""
    H = a_dst.shape[1]
    vals = _block_values(bg, h_src.dtype)
    if DENSE_EXP_PANEL and bg.values_layout == "cr":
        pan_s, pan_d = exp_panels(a_src, a_dst, msrc,
                                  bg.n_col_blocks * bg.block_cols,
                                  bg.n_row_blocks * bg.block_rows,
                                  negative_slope)
        return gat_dense_panel_blocks(bg, h_src.contiguous(), vals,
                                      a_src.float().contiguous(), pan_s,
                                      pan_d)
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
# dense masked attention backward (K7, K8)
#
# Per head and cell (r, c) of a 'cr' count block, with alpha = p * count /
# den[r] under the forward's shift bound and s2[r] = <gbar_r, out_r>:
#   te = <gbar_r, h_c>,  dz = alpha (te - s2[r]) leaky'(a_s[c] + a_d[r])
#   dad[r] += sum_c dz                 K7 over the rb-major split bg
#   das[c] += sum_r dz, dh[c] += sum_r alpha gbar_r
#                                      K8 over the transposed graph's split
#                                      bg_t, whose rows are the senders c
# Side values stay float32 here; only alpha rounds to h's dtype before the
# dh product, as in the TPU kernels.
# ---------------------------------------------------------------------------


def _gat_dense_bwd_reference(bg: DenseBlockGraph, h: torch.Tensor,
                             gbar: torch.Tensor, values: torch.Tensor,
                             side: torch.Tensor, msrc: torch.Tensor, *,
                             src_mode: bool,
                             negative_slope: float = 0.2,
                             magnitude: bool = False) -> torch.Tensor:
    """Plain version of K7 (``src_mode=False``: dad [n, H] over ``bg``)
    and K8 (``src_mode=True``: [das | dh] [n, H + HD] over the transposed
    graph's split, rows = original senders).  ``side`` [N, 4H] float32 is
    [a_s | a_d | 1/den | s2].  ``magnitude`` sums the magnitudes of the
    elementary terms instead, as the tail's plain version does (the scale
    of a check: these sums cancel)."""
    R, C = bg.block_rows, bg.block_cols
    H = msrc.shape[1]
    HD = h.shape[1]
    D = HD // H
    n = h.shape[0]
    RB, CB = bg.n_row_blocks, bg.n_col_blocks
    width = H + (HD if src_mode else 0)
    npad = max(RB * R, CB * C, n)
    hp, gp, sp = (_pad_rows(t.float(), npad) for t in (h, gbar, side))
    ms = msrc.float().reshape(1, 1, 1, H)
    rdt = h.dtype
    acc = torch.zeros((RB, R, width), dtype=torch.float32, device=h.device)
    ar_r = torch.arange(R, device=h.device)
    ar_c = torch.arange(C, device=h.device)
    step = max(1, _PLAIN_CHUNK // (4 * R * C * max(H, 1)))
    for b0 in range(0, bg.n_blocks, step):
        rb = bg.blk_rb[b0:b0 + step].long()
        cnt = values[b0:b0 + step].float()
        if bg.values_layout == "cr":
            cnt = cnt.transpose(1, 2)                          # [b, R, C]
        rows = rb[:, None] * R + ar_r                          # [b, R]
        cols = bg.blk_cb[b0:b0 + step].long()[:, None] * C + ar_c
        s, d = (rows[:, :, None], cols[:, None, :]) if src_mode else (
            cols[:, None, :], rows[:, :, None])
        xr = (hp if src_mode else gp)[rows].view(-1, R, H, D)
        xc = (gp if src_mode else hp)[cols].view(-1, C, H, D)
        a_s = sp[s, :H]
        a_d, rden, s2 = (sp[d, k * H:(k + 1) * H] for k in (1, 2, 3))
        if magnitude:
            xr, xc, s2 = xr.abs(), xc.abs(), -s2.abs()
        te = torch.einsum("brhd,bchd->brch", xr, xc)           # [b, R, C, H]
        alpha, dz = _edge_grad(a_s, a_d, rden, s2, ms, cnt[..., None], te,
                               negative_slope)
        part = dz.sum(dim=2)                                   # [b, R, H]
        if src_mode:
            ar = alpha.to(rdt).float() if rdt != torch.float32 else alpha
            dh = torch.einsum("brch,bchd->brhd", ar, xc).reshape(-1, R, HD)
            part = torch.cat([part, dh], dim=2)
        acc.index_add_(0, rb, part)
    return acc.view(RB * R, width)[:n]


def _gat_dense_bwd(bg: DenseBlockGraph, h, gbar, values, side, msrc,
                   negative_slope, src_mode: bool, entry: str,
                   out: Optional[torch.Tensor]):
    from .gat import _bwd_out, _require_bwd
    dev = h.device
    _require_bwd(h, gbar, side, msrc, dev)
    _ext.require(values, "values", dev, (torch.int8, h.dtype), 3)
    _require_blocks(bg, dev)
    R, C = bg.block_rows, bg.block_cols
    if bg.values_layout != "cr" or tuple(values.shape) != (
            bg.n_blocks, C, R):
        raise ValueError(f"{entry} takes 'cr' values [B, C, R]; got "
                         f"{bg.values_layout!r} {tuple(values.shape)}")
    H = msrc.shape[1]
    HD = h.shape[1]
    n = h.shape[0]
    # segments add their rows atomically: unvisited stripes stay 0
    out = _bwd_out(out, (n, H + (HD if src_mode else 0)), dev)
    # K7's and K8's bf16 paths run on wgmma over the wide segments (K4's
    # shapes)
    N = _gat_wgmma_width(H, HD // H) if h.dtype == torch.bfloat16 else 0
    if N and (R % 16 or C % 16):
        raise ValueError(f"{entry}'s bf16 path copies 16-byte pieces of "
                         f"count columns: block_rows {R} and block_cols {C} "
                         "must be multiples of 16")
    segs, seg_cap = ((bg.wide_segments, DENSE_WIDE_SEGMENT) if N
                     else (bg.segments, DENSE_SEGMENT))
    _ext.require(segs, "segments", dev, (torch.int32,), 2)
    n_seg = int(segs.shape[0])
    if n_seg == 0 or n == 0:
        return out
    lib = _ext.library()
    # the wgmma path's scratch, which the kernel's entry point fills: the
    # column vectors transposed (K7: h, K8: gbar; each head's D features on
    # KT = D padded to 16 rows) and the columns' terms transposed (K7: a_s;
    # K8: [a_d | bound | 1/den | s2]), every column block's columns
    ld = -(-max(bg.n_col_blocks * C, n) // 8) * 8
    KT = -(-N // 16) * 16
    panel = (torch.empty((H * KT, ld), dtype=h.dtype, device=dev) if N
             else None)
    ct = (torch.empty(((4 if src_mode else 1) * H, ld), dtype=torch.float32,
                      device=dev) if N else None)
    args = [segs.data_ptr(), bg.row_blocks.data_ptr(), bg.blk_cb.data_ptr(),
            values.data_ptr(), _ext.DTYPE_CODE[values.dtype], h.data_ptr(),
            gbar.data_ptr(), _ext.DTYPE_CODE[h.dtype], side.data_ptr(),
            msrc.data_ptr(), out.data_ptr(), n_seg, seg_cap, R, C, HD, H, n,
            None if panel is None else panel.data_ptr(),
            None if ct is None else ct.data_ptr(), ld,
            _dense_bwd_smem(HD, H, h.element_size(), src_mode,
                            values.element_size())]
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, float(negative_slope),
                                 _ext.stream(h))
    _ext.check(rc, entry)
    return out


def gat_dense_bwd_dad(bg: DenseBlockGraph, h: torch.Tensor,
                      gbar: torch.Tensor, values: torch.Tensor,
                      side: torch.Tensor, msrc: torch.Tensor, *,
                      negative_slope: float = 0.2,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 wrapper: dad [n, H] float32 over the rb-major 'cr' dense split.
    ``h`` and ``gbar`` [N, HD] share a dtype, ``values`` holds int8 counts
    or is of that dtype, ``side`` [N, 4H] float32 is [a_s | a_d | 1/den |
    s2] and ``msrc`` [1, H] the forward's shift bound; ``out`` ([n, H]
    float32) takes the kernel's adds and is returned in place of a zeroed
    output of its own.  bf16 ``h`` at K4's wgmma shapes
    (``_gat_wgmma_width``) runs te per head on tensor cores over
    ``bg.wide_segments``; float32 and other shapes the dense walk over
    ``bg.segments``.  CPU tensors take the plain version; CUDA tensors
    launch or raise."""
    if h.device.type == "cpu":
        y = _gat_dense_bwd_reference(bg, h, gbar, values, side, msrc,
                                     src_mode=False,
                                     negative_slope=negative_slope)
        return y if out is None else out.add_(y)
    out = _gat_dense_bwd(bg, h, gbar, values, side, msrc, negative_slope,
                         False, "gta_gat_dense_bwd_dad", out)
    gat_dense_bwd_dad.launches += 1
    return out


gat_dense_bwd_dad.launches = 0


def gat_dense_bwd_src(bg_t: DenseBlockGraph, h: torch.Tensor,
                      gbar: torch.Tensor, values: torch.Tensor,
                      side: torch.Tensor, msrc: torch.Tensor, *,
                      negative_slope: float = 0.2,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8 wrapper: [das | dh] [n, H + HD] float32 over the TRANSPOSED
    graph's 'cr' dense split (rows = original senders); arguments as
    :func:`gat_dense_bwd_dad`, ``out`` [n, H + HD].  bf16 ``h`` at K4's
    wgmma shapes (``_gat_wgmma_width``) runs both products per head on
    tensor cores over ``bg_t.wide_segments``; float32 and other shapes the
    dense walk over ``bg_t.segments``.  CPU tensors take the plain version;
    CUDA tensors launch or raise."""
    if h.device.type == "cpu":
        y = _gat_dense_bwd_reference(bg_t, h, gbar, values, side, msrc,
                                     src_mode=True,
                                     negative_slope=negative_slope)
        return y if out is None else out.add_(y)
    out = _gat_dense_bwd(bg_t, h, gbar, values, side, msrc, negative_slope,
                         True, "gta_gat_dense_bwd_src", out)
    gat_dense_bwd_src.launches += 1
    return out


gat_dense_bwd_src.launches = 0


def gat_dense_bwd(bg: DenseBlockGraph, bg_t: DenseBlockGraph,
                  h_src: torch.Tensor, a_src: torch.Tensor,
                  a_dst: torch.Tensor, den: torch.Tensor, out: torch.Tensor,
                  gbar: torch.Tensor, *, negative_slope: float = 0.2):
    """Dense-block attention gradients (dh, das, dad), the dense edges'
    share of the full gradient.  ``den`` is the COMBINED forward
    denominator [N, H] and ``out`` the combined normalized output, so the
    tail's share (:func:`~.gat._gat_bwd_fused`) adds elementwise.  ``bg``
    is the rb-major 'cr' split, ``bg_t`` the split of the transposed graph
    on the same grid.  Either may be None (that split has no dense
    blocks): dad comes from ``bg`` alone and (dh, das) from ``bg_t``
    alone, so each is the share of the edges its own split sends dense."""
    from .gat import bwd_inputs
    for b in (bg, bg_t):
        if b is not None and b.values_layout != "cr":
            raise ValueError("gat_dense_bwd needs 'cr' blocks")
    dt = h_src.dtype
    hc, gc, side, msrc = bwd_inputs(h_src, a_src, a_dst, den, out, gbar)
    n, H, HD = hc.shape[0], a_dst.shape[1], hc.shape[1]
    dad = (gat_dense_bwd_dad(bg, hc, gc, _block_values(bg, dt), side, msrc,
                             negative_slope=negative_slope)
           if bg is not None else hc.new_zeros((n, H), dtype=torch.float32))
    sd = (gat_dense_bwd_src(bg_t, hc, gc, _block_values(bg_t, dt), side,
                            msrc, negative_slope=negative_slope)
          if bg_t is not None
          else hc.new_zeros((n, H + HD), dtype=torch.float32))
    return sd[:, H:].to(dt), sd[:, :H], dad


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
    p = torch.where(mask, exp_f64(e - m.index_select(0, dst)),
                    torch.zeros_like(e)) * w
    den = torch.zeros((n + 1, H), dtype=torch.float32,
                      device=h.device).index_add_(0, dst, p)
    num = torch.zeros((n + 1, HD), dtype=torch.float32,
                      device=h.device).index_add_(
        0, dst, p.repeat_interleave(D, dim=1) * hsx.index_select(0, src))
    out = num / torch.clamp(den, min=1e-20).repeat_interleave(D, dim=1)
    return out[:n]


def _spmm_hybrid_run(hyb: HybridGraph, x: torch.Tensor) -> torch.Tensor:
    y = spmm(hyb.tiles, x)
    if hyb.dense is not None:
        yd = spmm_dense(hyb.dense, x, row_scale=hyb.row_scale,
                        col_scale=hyb.col_scale)
        y = y + yd[: y.shape[0]]
    return y


class _SpmmHybrid(torch.autograd.Function):
    """y = A x on the hybrid kernels; dx = Aᵀ ȳ on the same kernels over
    the transposed graph's split ``hyb_t``, or without it autograd of the
    full-graph segment formulation (the JAX package's fallback)."""

    @staticmethod
    def forward(ctx, x, hyb, hyb_t, g, weighted):
        ctx.hyb_t, ctx.g, ctx.weighted = hyb_t, g, weighted
        ctx.save_for_backward(x)
        return _spmm_hybrid_run(hyb, x)

    @staticmethod
    @spanned("bwd.spmm_hybrid")
    def backward(ctx, gbar):
        (x,) = ctx.saved_tensors
        if ctx.hyb_t is not None:
            dx = _spmm_hybrid_run(ctx.hyb_t, gbar.to(x.dtype).contiguous())
            return dx[: x.shape[0]].to(x.dtype), None, None, None, None
        if ctx.g is None:
            raise ValueError("spmm_hybrid backward needs hyb_t or g")
        with torch.enable_grad():
            xv = x.detach().requires_grad_(True)
            y = _spmm_ref_g(ctx.g, xv, ctx.weighted)
            (dx,) = torch.autograd.grad(y, xv, gbar.float())
        return dx, None, None, None, None


def spmm_hybrid(hyb: HybridGraph, g: Optional[GraphTensor], x: torch.Tensor,
                *, weighted: bool = True,
                hyb_t: Optional[HybridGraph] = None) -> torch.Tensor:
    """Density-split SpMM, [N, F] float32: the edge tail on K1 (once per
    class of a MultiTiledGraph tail; K9 for a grouped tail) plus the dense
    blocks on K2 (with the separable scales when the blocks hold counts).
    Differentiable in ``x``: with ``hyb_t``, the split of the transposed
    graph built the same way, the gradient dx = Aᵀ ȳ runs the same kernels
    over it; without, autograd of the full-graph formulation over ``g``
    (``weighted`` edge weights), which holds [E, F] edge tensors."""
    return _SpmmHybrid.apply(x, hyb, hyb_t, g, weighted)


def _a_s_kernel(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a_src at the TPU kernels' precision (operands in h's dtype, f32
    sum): the one array that the tail (K3, or K10 for a grouped one), msrc,
    the dense partial and the backward read."""
    return h.float() @ w.to(h.dtype).float()


def _gat_hybrid_raw(hyb: HybridGraph, h, sw, d, wmode: bool, slope: float):
    """(raw [num | den], a_s): the tail (K3, or K10 for a grouped one) plus
    the dense blocks (K4) under one shift bound, all reading one a_s."""
    sv = _a_s_kernel(h, sw) if wmode else sw
    msrc = sv.float().amax(0, keepdim=True)
    acc = _gat_forward(hyb.tiles, h, None if wmode else sw, d,
                       w_asrc=sw if wmode else None,
                       a_s=sv if wmode else None,
                       negative_slope=slope, normalize=False, msrc=msrc)
    if hyb.dense is not None:
        accd = gat_dense_partial(hyb.dense, h, sv, d, msrc,
                                 negative_slope=slope)
        acc = acc + accd[: acc.shape[0]]
    return acc, sv


class _GatHybrid(torch.autograd.Function):
    """gat_hybrid with the kernel backward (:func:`_gat_hybrid_grads`): the
    tail's share on K5/K6 and the dense share on K7/K8, from the combined
    den and output and the forward's a_s, added into one float32 buffer
    per output.  Without a twin, or with grouped or class tails (the tail
    backward kernels read per-tile tilings; JAX's ``kernel_bwd`` rule),
    autograd of the full-graph formulation, unweighted as the attention
    kernels are."""

    @staticmethod
    def forward(ctx, h, sw, d, hyb, hyb_t, g, slope, wmode):
        acc, a_s = _gat_hybrid_raw(hyb, h, sw, d, wmode, slope)
        H = d.shape[1]
        HD = h.shape[1]
        num, den = acc[:, :HD], acc[:, HD:]
        y = num / torch.clamp(den, min=1e-20).repeat_interleave(HD // H,
                                                                dim=1)
        ctx.hyb, ctx.hyb_t, ctx.g = hyb, hyb_t, g
        ctx.slope, ctx.wmode = slope, wmode
        ctx.kernel_bwd = (hyb_t is not None and type(hyb.tiles) is TiledGraph
                          and type(hyb_t.tiles) is TiledGraph)
        if ctx.kernel_bwd:
            ctx.save_for_backward(h, sw, d, y, den, a_s)
        else:
            ctx.save_for_backward(h, sw, d)
        return y

    @staticmethod
    @spanned("bwd.gat_hybrid")
    def backward(ctx, gbar):
        none = (None,) * 5
        if not ctx.kernel_bwd:
            return _gat_hybrid_fallback_grads(ctx, gbar) + none
        h, sw, d, y, den, a_s = ctx.saved_tensors
        return _gat_hybrid_grads(ctx.hyb, ctx.hyb_t, h, sw, a_s, d, den, y,
                                 gbar, ctx.slope, ctx.wmode) + none


def _gat_hybrid_grads(hyb: HybridGraph, hyb_t: HybridGraph, h, sw, a_s, d,
                      den, y, gbar, slope: float, wmode: bool) -> tuple:
    """(dh, dsw, dad) of gat_hybrid on K5-K8, one backward over both
    shares: the kernels' inputs built once (the dense kernels read the
    float32 side panel, the tail kernels it rounded to h's dtype), K5 and
    K7 adding dad into one float32 buffer and K6 and K8 [das | dh] into
    another (each split covers every edge once, so the forward split gives
    dad and the twin (dh, das), whichever of them has dense blocks); in
    derive mode the chain rule through a_s = h w adds into dh's float32
    columns; dh rounds to h's dtype once."""
    from .gat import (bwd_inputs, gat_bwd_tiles_dad, gat_bwd_tiles_src,
                      pack_side)
    dt = h.dtype
    hc, gc, side, msrc = bwd_inputs(h, a_s, d, den, y, gbar)
    side_t = side.to(dt).float()
    packed = None if h.device.type == "cpu" else pack_side(side_t)
    tg, tg_t = hyb.tiles, hyb_t.tiles
    n, H, HD = hc.shape[0], d.shape[1], hc.shape[1]
    rows = max(n, tg.n_node, tg_t.n_node)
    dad = torch.zeros((rows, H), dtype=torch.float32, device=h.device)
    sd = torch.zeros((rows, H + HD), dtype=torch.float32, device=h.device)
    kw = dict(negative_slope=slope)
    gat_bwd_tiles_dad(tg, hc, gc, side_t, msrc, packed=packed,
                      out=dad[: tg.n_node], **kw)
    gat_bwd_tiles_src(tg_t, hc, gc, side_t, msrc, packed=packed,
                      out=sd[: tg_t.n_node], **kw)
    if hyb.dense is not None:
        gat_dense_bwd_dad(hyb.dense, hc, gc, _block_values(hyb.dense, dt),
                          side, msrc, out=dad[:n], **kw)
    if hyb_t.dense is not None:
        gat_dense_bwd_src(hyb_t.dense, hc, gc,
                          _block_values(hyb_t.dense, dt), side, msrc,
                          out=sd[:n], **kw)
    count("gat_bwd.shared", 1)
    das, dh, dad = sd[:n, :H], sd[:n, H:], dad[:n]
    if wmode:
        # the chain rule through a_s = h w, in float32
        dh.addmm_(das, sw.float().T)
        dw = (h.float().T @ das).to(sw.dtype)
        return dh.to(dt), dw, dad.to(d.dtype)
    return dh.to(dt), das.to(sw.dtype), dad.to(d.dtype)


def _gat_hybrid_fallback_grads(ctx, gbar):
    """(dh, dsw, dad) by autograd of the full-graph formulation over
    ``ctx.g``, for a call without a twin or with grouped tails: unweighted,
    since hybrid
    attention graphs are built unit-weight, so a symmetric-norm ``g``
    still gets the gradient of the function the kernels compute."""
    if ctx.g is None:
        raise ValueError("gat_hybrid backward needs hyb_t or g")
    h, sw, d = ctx.saved_tensors
    with torch.enable_grad():
        hv, sv, dv = (t.detach().requires_grad_(True) for t in (h, sw, d))
        a_s = hv.float() @ sv.float() if ctx.wmode else sv
        y = _gat_reference_g(ctx.g, hv, a_s, dv, ctx.slope, weighted=False)
        return torch.autograd.grad(y, (hv, sv, dv), gbar.float())


def gat_hybrid(hyb: HybridGraph, g: Optional[GraphTensor],
               h_src: torch.Tensor, a_src: Optional[torch.Tensor],
               a_dst: torch.Tensor, *, negative_slope: float = 0.2,
               w_asrc: Optional[torch.Tensor] = None,
               hyb_t: Optional[HybridGraph] = None) -> torch.Tensor:
    """Density-split GAT attention, [N, HD] float32.  The tail (K3, once
    per class of a MultiTiledGraph tail, or K10 for a grouped tail, which
    needs ``w_asrc``) and the dense blocks (K4)
    accumulate raw [num | den] under ONE shift bound (the global per-head
    max of a_src), so the combine is one add and divide.  ``w_asrc`` [HD,
    H] replaces ``a_src`` when a_src is a linear map of h: the tail derives
    a_s in-kernel and msrc, the dense partial and the backward use the
    same-precision values, and the gradient is (dh, dw, dad).  ``hyb_t``,
    the split of the transposed graph on the same grid, runs the backward
    on kernels K5-K8 when both tails are per-tile; otherwise the backward
    differentiates the full-graph formulation over ``g``."""
    wmode = w_asrc is not None
    return _GatHybrid.apply(h_src, w_asrc if wmode else a_src, a_dst, hyb,
                            hyb_t, g, negative_slope, wmode)


def auto_hybrid_plan(hg, *, kind: str = "spmm", feat_width: int = 128,
                     heads: int = 4, head_dim: int = 32, values_dtype=None,
                     dense_budget: int = 5 << 30, dense_block: int = 256,
                     tail_geometries=None) -> dict:
    """The knobs :func:`auto_hybrid` picks for the host graph ``hg``, by the
    JAX package's cost models (its ``ops.dense.auto_hybrid``): ``min_nnz``,
    the dense threshold (the balance rule per kind, ``spmm``: count blocks
    at fudge 0.5 when the values take one byte; ``gat``: the transposed
    'cr' rule; raised until the dense values fit ``dense_budget`` bytes),
    and the tail geometry (``sparse_block_rows``, ``sparse_block_cols``)
    and ``tile_edges``: the argmin of :func:`~..graph.tile_time_model_ns`
    at :func:`~..graph.best_tile_capacity` over ``tail_geometries``."""
    from ..graph import best_tile_capacity, tile_time_model_ns
    if kind not in ("spmm", "gat"):
        raise ValueError(f"auto_hybrid kind {kind!r}: spmm or gat")
    if values_dtype is None:
        values_dtype = np.int8
    vb = (2 if values_dtype is torch.bfloat16
          else np.dtype(values_dtype).itemsize)
    rb = cb = dense_block
    bn = block_nnz(hg, rb, cb).reshape(-1)
    bn_sorted = np.sort(bn)[::-1]
    max_blocks = max(dense_budget // (rb * cb * vb), 1)
    if kind == "spmm":
        thr = spmm_dense_threshold(rb, cb, fudge=0.5 if vb == 1 else 1.0)
    else:
        thr = gat_dense_threshold_t(rb, cb, heads, head_dim)
    if len(bn_sorted) > max_blocks:
        thr = max(thr, int(bn_sorted[max_blocks - 1]) + 1)

    if tail_geometries is None:
        # the transposed attention kernels' tail rows are multiples of 128
        tail_geometries = (((1024, 1024), (2048, 1024), (1024, 512),
                            (2048, 512)) if kind == "spmm" else
                           ((512, 1024), (1024, 1024), (2048, 1024)))
    ncb = int(np.ceil(hg.n_node / cb))
    key = ((hg.receivers[: hg.n_edge] // rb).astype(np.int64) * ncb
           + hg.senders[: hg.n_edge] // cb)
    m = bn[key] < thr
    st = hg.senders[: hg.n_edge][m]
    rt = hg.receivers[: hg.n_edge][m]
    best = None
    for tr, tc in tail_geometries:
        tcn = int(np.ceil(hg.n_node / tc))
        nnz = np.bincount((rt // tr).astype(np.int64) * tcn + (st // tc))
        nnz = nnz[nnz > 0]
        if not len(nnz):
            best = (0.0, tail_geometries[0][0], tail_geometries[0][1], 512)
            break
        et = best_tile_capacity(nnz, tr, tc, feat_width=feat_width)
        t = tile_time_model_ns(nnz, et, tr, tc, feat_width=feat_width)
        if best is None or t < best[0]:
            best = (t, tr, tc, et)
    _, sr, sc, et = best
    return dict(min_nnz=thr, sparse_block_rows=sr, sparse_block_cols=sc,
                tile_edges=et)


def auto_hybrid(
    hg,
    *,
    kind: str = "spmm",
    feat_width: int = 128,
    heads: int = 4,
    head_dim: int = 32,
    values_dtype=None,
    dense_budget: int = 5 << 30,
    dense_block: int = 256,
    supergroup: int = 16,
    tail_geometries=None,
    tile_classes=None,
    device=None,
) -> HybridGraph:
    """A :class:`~..graph.HybridGraph` of the host graph ``hg`` on
    ``device`` (default the CUDA card) with every knob chosen by
    :func:`auto_hybrid_plan`.  ``values_dtype``: int8 counts by default,
    np.float32 or ``torch.bfloat16`` values.  ``kind="gat"`` builds
    unit-weight 'cr' blocks (pair with :func:`gat_hybrid`); ``kind="spmm"``
    pairs with :func:`spmm_hybrid` (int8 counts need the separable
    scales).  ``tile_classes`` tiles the tail as a MultiTiledGraph."""
    from ..graph import hybrid_graph
    plan = auto_hybrid_plan(hg, kind=kind, feat_width=feat_width,
                            heads=heads, head_dim=head_dim,
                            values_dtype=values_dtype,
                            dense_budget=dense_budget,
                            dense_block=dense_block,
                            tail_geometries=tail_geometries)
    return hybrid_graph(
        hg, block_rows=dense_block, block_cols=dense_block,
        unit_weight=(kind == "gat"),
        block_layout=("cr" if kind == "gat" else "rc"),
        supergroup=(supergroup if kind == "spmm" else 0),
        values_dtype=np.int8 if values_dtype is None else values_dtype,
        tile_classes=tile_classes, device=device, **plan)
