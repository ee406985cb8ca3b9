"""The least time an H100 could take for a kernel call: its bound.

A call's bound is the larger of two times: the bytes the function must
move (each input read once, each output written once) over the card's
memory rate, and the operations it does on these inputs over the card's
peak rate for their type.  Where the work depends on the data, this counts
what the data needs: the live slots of a tiling (pad slots and dead tiles
excluded) and the nonzero cells of dense blocks, not the padded shapes the
kernels walk.  An operation is a multiply, an add, a comparison or an
exponential of one element.

Rates (NVIDIA's data sheet, H100 SXM, dense, at the full 700 W power
limit): 3.35 TB/s of HBM3; 989 TFLOP/s bf16 on the tensor cores; 67
TFLOP/s float32 outside them.  The ops of a call with bfloat16 inputs are
held to the bf16 rate, of one with float32 inputs to the float32 rate.
"""
from __future__ import annotations

import dataclasses

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float
    ops: float
    ops_per_s: float

    @property
    def bytes_ms(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e3

    @property
    def ops_ms(self) -> float:
        return self.ops / self.ops_per_s * 1e3

    @property
    def bound_ms(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


def bound_of(works) -> tuple:
    """(bound_ms, bound_by) of several calls: the sum of their bounds, and
    the side (bytes or operations) that sets the larger share of it."""
    works = list(works)
    total = sum(w.bound_ms for w in works)
    by_bytes = sum(w.bound_ms for w in works if w.bound_by == "bytes")
    return total, "bytes" if 2 * by_bytes >= total else "operations"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rate(dtype) -> float:
    return PEAK_OPS_PER_S[torch.bfloat16 if dtype == torch.bfloat16
                          else torch.float32]


def live_slots(tg) -> int:
    """Slots of a TiledGraph or GroupedTiledGraph that hold an edge."""
    live = (tg.src_local < tg.block_cols) & (tg.dst_local < tg.block_rows)
    if hasattr(tg, "tile_cb"):
        live &= (tg.tile_cb >= 0)[:, None]
    return int(live.sum())


def nonzero_cells(bg) -> int:
    return int((bg.values != 0).sum())


def spmm_tail(tg, x: torch.Tensor, weight_bytes: int) -> Work:
    """K1 / K9: per live slot its two int16 indices and its weight
    (``weight_bytes``, 0 when the kernel reads no weight stream), one
    multiply and one add per feature; x read once, y [n_node, F] float32
    written once."""
    live, F = live_slots(tg), x.shape[1]
    units = tg.tile_rb if hasattr(tg, "tile_rb") else tg.chunk_grp
    return Work(bytes=live * (4 + weight_bytes) + 8 * units.numel()
                + _nbytes(x) + 4 * tg.n_node * F,
                ops=2.0 * live * F, ops_per_s=_rate(x.dtype))


def spmm_dense(bg, x: torch.Tensor) -> Work:
    """K2: the block values and x read once, the [n_rows, F] float32
    partial written once; a multiply and an add per nonzero cell and
    feature."""
    F = x.shape[1]
    return Work(bytes=_nbytes(bg.values) + 8 * bg.n_blocks + _nbytes(x)
                + 4 * bg.n_row_blocks * bg.block_rows * F,
                ops=2.0 * nonzero_cells(bg) * F, ops_per_s=_rate(x.dtype))


def _gat_edge_ops(HD: int, H: int) -> int:
    """Per edge of the forward: p per head (add, two leaky, subtract, min,
    exp, multiply, ~9), num and den (a multiply and an add per feature, an
    add per head)."""
    return 9 * H + 2 * HD + H


def gat_tail(tg, h: torch.Tensor, H: int, mult_bytes: int,
             derive: bool = True) -> Work:
    """K3 / K10: per live slot its indices and multiplicity; h, a_dst and
    (unless ``derive``) the float32 a_s read once; [num | den] float32
    written once.  Derive mode forms a_s from h and w_asrc instead, once a
    node (2 HD H operations): the least work, whether a kernel derives it
    per node (K3) or per edge (K10)."""
    live, n, HD = live_slots(tg), h.shape[0], h.shape[1]
    side = 4 * n * H * (1 if derive else 2)
    return Work(bytes=live * (4 + mult_bytes) + _nbytes(h) + side
                + 4 * tg.n_node * (HD + H),
                ops=float(live * _gat_edge_ops(HD, H)
                          + (2 * n * HD * H if derive else 0)),
                ops_per_s=_rate(h.dtype))


def gat_dense(bg, h: torch.Tensor, H: int) -> Work:
    """K4: block values, h, a_src and a_dst read once, the [n_rows, HD + H]
    partial written once; the forward's per-edge work per nonzero cell."""
    n, HD = h.shape
    return Work(bytes=_nbytes(bg.values) + 8 * bg.n_blocks + _nbytes(h)
                + 8 * n * H + 4 * bg.n_row_blocks * bg.block_rows * (HD + H),
                ops=float(nonzero_cells(bg) * _gat_edge_ops(HD, H)),
                ops_per_s=_rate(h.dtype))


# the per-cell floor of a dense-cell design (K4's kernels form p for every
# cell of a dense block, zero or not): 132 SMs at the H100 SXM's 1.98 GHz
# boost clock, 16 exponentials per clock per SM (the special-function
# units), and ~10 float32 operations per cell-head at the non-FMA half of
# the 67 TFLOP/s float32 rate
SMS, SM_CLOCK_HZ, EXP_PER_CLOCK_SM, CELL_OPS = 132, 1.98e9, 16, 10


def dense_cell_floor_ms(cell_heads: int, ops: int = CELL_OPS) -> float:
    """The least time a kernel that forms p for every one of
    ``cell_heads`` (cells times heads) could take on the card: the exps at
    the special-function units' rate plus the rest of the chain (``ops``
    float32 operations per cell-head) at the float32 rate.  ``gat_dense``
    counts nonzero cells only; this is the floor of a design that walks
    every cell."""
    exp_s = cell_heads / (SMS * SM_CLOCK_HZ * EXP_PER_CLOCK_SM)
    ops_s = ops * cell_heads / (PEAK_OPS_PER_S[torch.float32] / 2)
    return (exp_s + ops_s) * 1e3


# the backward chain per cell-head besides its exp: the logit's add, two
# leaky relus, the bound's subtract, the min, the count and 1/den
# products, te - s2, the two products of dz, leaky' and the das add
BWD_CELL_OPS = 12


def dense_bwd_cell_floor_ms(cell_heads: int) -> float:
    """K8's dense-cell floor: the least time a kernel that runs the
    backward chain for every one of ``cell_heads`` (the cells of every
    dense block times the heads, zero or not, as K8's bf16 path and the TPU
    kernel do) could take on the card; its two products per head go to the
    tensor cores, far below their rate.  ``gat_dense_bwd`` counts nonzero
    cells only, which a dense design cannot reach."""
    return dense_cell_floor_ms(cell_heads, BWD_CELL_OPS)


def gat_dense_panel(bg, h: torch.Tensor, H: int) -> Work:
    """K15: K4's bytes with the exp panels ([n_cols, 2H] and [n_rows, 3H]
    float32) in place of a_dst; per nonzero cell and head a compare, an
    add, a select and two multiplies instead of the exp chain, then num and
    den as K4."""
    n, HD = h.shape
    rows = bg.n_row_blocks * bg.block_rows
    cols = bg.n_col_blocks * bg.block_cols
    return Work(bytes=_nbytes(bg.values) + 8 * bg.n_blocks + _nbytes(h)
                + 4 * n * H + 4 * (2 * cols + 3 * rows) * H
                + 4 * rows * (HD + H),
                ops=float(nonzero_cells(bg) * (5 * H + 2 * HD + H)),
                ops_per_s=_rate(h.dtype))


def gat_layer(tg, x: torch.Tensor, HD: int, H: int) -> Work:
    """K14, the whole layer: x, W [F, HD], wa_s and wa_d read once, per
    live slot its two int16 indices, the [n, HD] float32 output written
    once (hq, a_s, a_d and [num | den] are the kernel's own scratch).
    Operations: the projection x W (2 n F HD) and a_s | a_d (4 n HD H);
    per live slot the static-shift logit and exp (~7 per head) and the num
    and den adds (2 HD + H); the epilogue's divide and activation (2 n
    HD)."""
    n, F = x.shape
    live, es = live_slots(tg), x.element_size()
    return Work(bytes=_nbytes(x) + es * (F * HD + 2 * HD * H)
                + live * 4 + 8 * tg.n_tiles + 4 * n * HD,
                ops=2.0 * n * F * HD + 4.0 * n * HD * H
                + live * (7 * H + 2 * HD + H) + 2.0 * n * HD,
                ops_per_s=_rate(x.dtype))


def gat_layer_projection(x: torch.Tensor, HD: int, H: int) -> Work:
    """K14's projection stage alone: x and the three weights read once,
    hq [n, HD] and a_s | a_d [n, 2H] written once; 2 n F HD + 4 n HD H
    operations."""
    n, F = x.shape
    es = x.element_size()
    return Work(bytes=_nbytes(x) + es * (F * HD + 2 * HD * H)
                + es * n * (HD + H) + 4 * n * H,
                ops=2.0 * n * F * HD + 4.0 * n * HD * H,
                ops_per_s=_rate(x.dtype))


def _bwd_edge_ops(HD: int, H: int, src_mode: bool) -> int:
    """Per edge of the backward: te (a multiply-add per feature), alpha and
    dz (~10 per head), the dad add; with ``src_mode`` also das and dh
    (a multiply-add per feature)."""
    return 2 * HD + 11 * H + (2 * HD + H if src_mode else 0)


def _bwd_bytes(h: torch.Tensor, H: int, n_out: int, src_mode: bool) -> int:
    n, HD = h.shape
    return 2 * _nbytes(h) + 16 * n * H + 4 * n_out * (H + (HD if src_mode
                                                          else 0))


def gat_bwd_tail(tg, h: torch.Tensor, H: int, mult_bytes: int,
                 src_mode: bool) -> Work:
    """K5 (dad) / K6 (das, dh over the transposed tiling): per live slot
    its indices and multiplicity; h, gbar and the [N, 4H] side panel read
    once, the output written once."""
    live, HD = live_slots(tg), h.shape[1]
    return Work(bytes=live * (4 + mult_bytes)
                + _bwd_bytes(h, H, tg.n_node, src_mode),
                ops=float(live * _bwd_edge_ops(HD, H, src_mode)),
                ops_per_s=_rate(h.dtype))


def gat_dense_bwd(bg, h: torch.Tensor, H: int, src_mode: bool) -> Work:
    """K7 / K8: the blocks' counts, h, gbar and the side panel read once,
    the output written once; the backward's per-edge work per nonzero
    cell."""
    HD = h.shape[1]
    return Work(bytes=_nbytes(bg.values) + 8 * bg.n_blocks
                + _bwd_bytes(h, H, h.shape[0], src_mode),
                ops=float(nonzero_cells(bg) * _bwd_edge_ops(HD, H, src_mode)),
                ops_per_s=_rate(h.dtype))


def sddmm_tail(tg, x_src: torch.Tensor, x_dst: torch.Tensor,
               heads: int) -> Work:
    """K11 / K12: per live slot its two int16 indices and a multiply and an
    add per feature (2F operations); x_src and x_dst read once; the
    returned [heads, slots] float32 written once, over every slot of the
    layout (pad slots hold zeros the function must write too)."""
    live, F = live_slots(tg), x_src.shape[1]
    units = tg.tile_rb if hasattr(tg, "tile_rb") else tg.chunk_grp
    return Work(bytes=live * 4 + 8 * units.numel() + _nbytes(x_src)
                + _nbytes(x_dst) + 4 * heads * tg.src_local.numel(),
                ops=2.0 * live * F, ops_per_s=_rate(x_src.dtype))


def pair_agg(tg, u: torch.Tensor, want_max: bool) -> Work:
    """K13: per live slot its two int16 indices and about four operations
    per feature (add, sf, the sum's add, the max; three without the max);
    u and v (u's shape and dtype) read once; the [N, D] float32 sum, the max
    with ``want_max``, and the [N, 1] count written once."""
    live, (n, D) = live_slots(tg), u.shape
    return Work(bytes=live * 4 + 8 * tg.n_tiles + 2 * _nbytes(u)
                + 4 * n * D * (2 if want_max else 1) + 4 * n,
                ops=float(live * D * (4 if want_max else 3)),
                ops_per_s=_rate(u.dtype))


def csr_of(graph, dtype, n_cols: int) -> torch.Tensor:
    """The same edges as one sparse CSR matrix [rows, n_cols] of ``dtype``
    (values: the slot weights of a tiling, the counts of dense blocks), the
    input of the library call ``torch.sparse.mm`` that computes K1's, K2's
    and K9's function."""
    from ..graph import DenseBlockGraph
    from ..ops.spmm import _live_slots, _unit_steps
    if isinstance(graph, DenseBlockGraph):
        R, C = graph.block_rows, graph.block_cols
        b, i, j = torch.nonzero(graph.values, as_tuple=True)
        rows = graph.blk_rb.long()[b] * R + i
        cols = graph.blk_cb.long()[b] * C + j
        vals = graph.values[b, i, j]
        n_rows = graph.n_row_blocks * R
    else:
        parts = []
        for u0, u1 in _unit_steps(graph, 8):
            mask, src, dst = _live_slots(graph, u0, u1)
            parts.append((dst, src, graph.weight[u0:u1][mask]))
        rows, cols, vals = (torch.cat(p) for p in zip(*parts))
        n_rows = graph.n_node
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals.to(dtype),
                                  (n_rows, n_cols))
    return coo.coalesce().to_sparse_csr()
