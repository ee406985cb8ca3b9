"""A small graph that reaches every edge case of the kernels, and the
kernel-against-plain-version cases run on it.

Shared by the CPU parity tests, the card's kernel tests
(``tests/test_torch_cuda.py``) and the on-card checks of ``chip_smoke.py``.  Nodes 0..511 form four 128-node communities (dense
diagonal blocks at a 128 grid); one pair repeats past the int8 count
maximum; the last row block has no dense block and most of its rows no
in-edge; its last row draws only from two sources whose a_src the caller
may push far below the rest, past the shift-bound gap.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np

N_NODE = 600
HOT_PAIR = (5, 7)          # sender, receiver
HOT_COPIES = 200           # > 127: int8 counts saturate
GAP_ROW = 599
GAP_SOURCES = (597, 598)   # the only senders into GAP_ROW

# Bound on |kernel - plain| in each row, relative to the row's scale
# (kernel_error).  Kernel and plain version round at the same points, so
# they differ in two ways only.  (1) f32 summation order (atomics,
# tensor-core accumulation): reordering a sum of n terms moves it by about
# sqrt(n) u of its size (u = 2^-24, the probabilistic bound of Higham), so
# a row that sums n terms is allowed SUM_ORDER sqrt(n) u where that exceeds
# the dtype's tolerance, i.e. rows of more than 1,759 terms: the hubs.
# (2) In bfloat16, flips of one rounded product or p by one bf16 ulp where
# an f32 input differs in its last bit (derive mode sums a_s in another
# order).  A flip moves one term by at most 2^-7 (7.8e-3) of itself, and no
# term exceeds its row's scale: the bf16 tolerance covers one flip per row.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SUM_ORDER = 4.0
# rows whose scale is below this share of their group's largest take it
ROW_FLOOR = 1e-6


class KernelCase(NamedTuple):
    """One kernel-against-plain comparison.  ``split``: the num width of a
    raw [num | den] output; ``terms``: the terms each output row sums
    (:func:`row_terms`)."""
    kernel: str
    case: str
    dtype_name: str
    out: Any
    ref: Any
    split: Optional[int] = None
    terms: Any = None


def row_terms(graph):
    """Terms each output row of a kernel sums, float32: the live slots of a
    ``TiledGraph`` per node, or the nonzero cells of a ``DenseBlockGraph``'s
    blocks per padded row."""
    import torch

    from ..graph import DenseBlockGraph
    R = graph.block_rows
    if isinstance(graph, DenseBlockGraph):
        nz = (graph.values != 0).sum(
            dim=1 if graph.values_layout == "cr" else 2)       # [B, R]
        acc = torch.zeros((graph.n_row_blocks, R), device=nz.device)
        return acc.index_add_(0, graph.blk_rb.long(), nz.float()).view(-1)
    C = graph.block_cols
    cb = graph.tile_cb.long()[:, None]
    sl, dl = graph.src_local.long(), graph.dst_local.long()
    valid = (cb >= 0) & (sl < C) & (dl < R)
    dst = (graph.tile_rb.long()[:, None] * R + dl)[valid]
    return torch.bincount(dst, minlength=graph.n_row_blocks * R)[
        : graph.n_node].float()


def kernel_error(c: KernelCase) -> Tuple[float, float]:
    """(max |out - ref|, largest share of its bound that a row's error
    takes; the case passes at or below 1).

    A row's bound is its scale times max(KERNEL_TOL, SUM_ORDER sqrt(terms)
    u).  The scale is max |ref| over the row's column group: the whole row,
    or with ``split`` the num columns and the den columns apart, since den
    runs orders of magnitude above num.  A scale below ``ROW_FLOOR`` of the
    group's largest (or of 1) is raised to it, so an all-zero row must come
    out zero."""
    import torch
    if c.out.numel() == 0:
        return 0.0, 0.0
    err = (c.out.float() - c.ref.float()).abs()
    mag = c.ref.float().abs()
    tol = torch.full((mag.shape[0],), KERNEL_TOL[c.dtype_name],
                     device=mag.device)
    if c.terms is not None:
        tol = torch.maximum(tol, SUM_ORDER * 2.0 ** -24
                            * c.terms.float().to(mag.device).sqrt())
    groups = ([slice(None)] if c.split is None
              else [slice(0, c.split), slice(c.split, None)])
    share = 0.0
    for cols in groups:
        row_scale = mag[:, cols].amax(dim=1)
        floor = ROW_FLOOR * max(1.0, float(row_scale.max()))
        bound = row_scale.clamp(min=floor) * tol
        share = max(share, float((err[:, cols].amax(dim=1) / bound).max()))
    return float(err.max()), share


def check_kernel(c: KernelCase) -> Tuple[float, float]:
    """Raise AssertionError unless ``c.out`` has ``c.ref``'s shape, is
    finite and lies within its bound by :func:`kernel_error`; returns
    (max abs error, share of the bound)."""
    import torch
    what = f"{c.kernel} {c.case} {c.dtype_name}"
    if c.out.shape != c.ref.shape:
        raise AssertionError(f"{what}: shape {tuple(c.out.shape)} != "
                             f"{tuple(c.ref.shape)}")
    if not bool(torch.isfinite(c.out).all()):
        raise AssertionError(f"{what}: non-finite output")
    err, share = kernel_error(c)
    if not share <= 1.0:
        raise AssertionError(f"{what}: max abs error {err:.3e}; a row's "
                             f"error is {share:.3f} of its bound")
    return err, share


def edge_case_graph(seed: int = 0, n_edge: int = 4000
                    ) -> Tuple[np.ndarray, np.ndarray, int, Dict]:
    """(senders, receivers, n_node, meta) as int32 COO arrays."""
    rng = np.random.default_rng(seed)
    com = rng.integers(0, 4, size=n_edge)
    intra = rng.random(n_edge) < 0.7
    r = com * 128 + rng.integers(0, 128, size=n_edge)
    s = np.where(intra, com * 128 + rng.integers(0, 128, size=n_edge),
                 rng.integers(0, 512, size=n_edge))
    keep = s != r
    s, r = s[keep], r[keep]
    s = np.concatenate([s, np.full(HOT_COPIES, HOT_PAIR[0]),
                        np.asarray(GAP_SOURCES)])
    r = np.concatenate([r, np.full(HOT_COPIES, HOT_PAIR[1]),
                        np.full(len(GAP_SOURCES), GAP_ROW)])
    meta = dict(gap_row=GAP_ROW, empty_row_block_start=512)
    return s.astype(np.int32), r.astype(np.int32), N_NODE, meta


def gap_a_src(rng: np.random.Generator, n_node: int, heads: int,
              drop: float = 1000.0) -> np.ndarray:
    """Source logits [n_node, heads] with the gap row's sources ``drop``
    below the rest.  leaky_relu scales negative logits by its slope, so the
    drop must exceed ~85 / slope for that row's attention to underflow to
    zero under the global shift bound, as it does in the TPU kernels."""
    a = rng.normal(size=(n_node, heads)).astype(np.float32)
    a[list(GAP_SOURCES)] -= drop
    return a


def kernel_cases(device, seed: int = 0) -> Iterator[KernelCase]:
    """K1-K4 on the edge-case graph, in float32 and bfloat16: yields
    :class:`KernelCase` items (no row here sums enough terms for
    ``terms`` to matter).  On a CPU device both sides are the plain
    version.  Cases: a dead tile (cb = -1)
    whose slots look live; int8 counts in supergroup order with a row block
    that no dense block visits (its stripe must read 0); more than 127
    copies of one pair (count 127 dense plus a merged tail slot); a row past
    the shift-bound gap; both dense layouts; derive and values modes; raw
    and normalized output.  Each at two widths: 16-byte-aligned rows (F =
    48; 4 heads of 32) and the unaligned, partial-tile width of a last
    layer (F = 41; 1 head of 41), which take separate code in the
    kernels."""
    import dataclasses

    import torch

    from .. import graph as G
    from ..ops import dense as D
    from ..ops import gat as A
    from ..ops import spmm as SP

    s, r, n, meta = edge_case_graph(seed=seed)
    hg = G.build_host_graph(s, r, n, symmetric_norm=True,
                            edge_pad_multiple=128)
    hg_u = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    tg = G.tile_graph(hg, block_rows=128, block_cols=128, tile_edges=128,
                      device=device)
    cb = tg.tile_cb.clone()
    cb[1] = -1
    tg = dataclasses.replace(tg, tile_cb=cb)
    bg = G.hybrid_graph(hg, block_rows=128, block_cols=128, tile_edges=128,
                        min_nnz=64, supergroup=16, values_dtype=np.int8,
                        device=device).dense
    hys = {layout: G.hybrid_graph(hg_u, block_rows=128, block_cols=128,
                                  tile_edges=128, min_nnz=64,
                                  unit_weight=True, values_dtype=np.int8,
                                  block_layout=layout, device=device)
           for layout in ("cr", "rc")}
    if float(hys["cr"].tiles.weight.float().max()) <= 1.0:
        raise AssertionError("fixture lost its merged multi-edge slot")
    rng = np.random.default_rng(seed)
    K = KernelCase
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for F in (48, 41):
            x = torch.tensor(rng.standard_normal((n, F)), dtype=dt,
                             device=device)
            yield K("spmm_tiles", f"dead tile F={F}", name,
                    SP.spmm_tiles(tg, x, tg.weight),
                    SP._spmm_reference(tg, x))
            y = D.spmm_dense_blocks(bg, x, bg.values)
            yield K("spmm_dense_blocks", f"int8 sg16 F={F}", name, y,
                    D._spmm_dense_reference(bg, x, bg.values))
            stripe = y[meta["empty_row_block_start"]:]
            yield K("spmm_dense_blocks", f"unvisited stripe is 0 F={F}",
                    name, stripe, torch.zeros_like(stripe))
        for H, HD in ((4, 128), (1, 41)):
            h = torch.tensor(rng.standard_normal((n, HD)), dtype=dt,
                             device=device)
            a_s = torch.tensor(gap_a_src(rng, n, H), device=device)
            a_d = torch.tensor(rng.standard_normal((n, H)), dtype=dt,
                               device=device).float()
            w = torch.tensor(rng.standard_normal((HD, H)) / np.sqrt(HD),
                             dtype=dt, device=device)
            ms = a_s.amax(0, keepdim=True)
            ms_w = (h.float() @ w.float()).amax(0, keepdim=True)
            a_sv = a_s.to(dt).contiguous()
            for layout, hy in hys.items():
                tt, bd = hy.tiles, hy.dense
                tag = f"{layout} H={H} HD={HD}"
                for norm in (False, True):
                    yield K("gat_tiles", f"values gap {tag} norm={norm}", name,
                            A.gat_tiles(tt, h, tt.weight, a_d, ms, a_src=a_sv,
                                        normalize=norm),
                            A._gat_tiles_reference(tt, h, tt.weight, a_d, ms,
                                                   a_src=a_sv, normalize=norm),
                            None if norm else HD)
                yield K("gat_tiles", f"derive raw {tag}", name,
                        A.gat_tiles(tt, h, tt.weight, a_d, ms_w, w_asrc=w,
                                    normalize=False),
                        A._gat_tiles_reference(tt, h, tt.weight, a_d, ms_w,
                                               w_asrc=w, normalize=False), HD)
                yield K("gat_dense_blocks", f"int8 {tag}", name,
                        D.gat_dense_blocks(bd, h, bd.values, a_s, a_d, ms),
                        D._gat_dense_reference(bd, h, bd.values, a_s, a_d,
                                               ms), HD)
