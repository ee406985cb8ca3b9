"""Host-side graph builders and device containers for the PyTorch port.

Counterpart of the JAX package's ``graph.py``.  Every builder runs on the
host in numpy and emits the SAME arrays as its JAX twin (the parity tests
hold them equal); the containers then hold torch tensors on an explicit
``device``.

* :class:`HostGraph` — numpy COO, edges sorted by receiver, padded with
  index ``n_node``.
* :class:`GraphTensor` — the same arrays as torch tensors on a device.
* :class:`TiledGraph` — block-sparse edge tiles: the input of the edge-tile
  SpMM and GAT kernels.
* :class:`GroupedTiledGraph` — the stripe-group chunked tiling of the
  sparse tail: the input of the grouped SpMM and GAT kernels.
* :class:`DenseBlockGraph` / :class:`HybridGraph` — the density split:
  dense adjacency blocks plus the sparse remainder as edge tiles.

The JAX builders may call a native C++ helper; the port uses the numpy
formulations, which give identical arrays.

Every entry point that places tensors takes ``device=None``, which means
the CUDA card (:func:`resolve_device`); the CPU is used only when asked
for.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device``, or the CUDA card when
    it is None.  Raises when a CUDA device is meant and none is present:
    nothing falls back to the CPU unless the caller passes ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default is the CUDA card) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HostGraph:
    """Host-side (numpy) twin of :class:`GraphTensor`.  All preprocessing
    (tiling, density split, reordering) reads this, never device tensors."""

    senders: np.ndarray
    receivers: np.ndarray
    edge_mask: np.ndarray
    edge_weight: np.ndarray
    n_node: int
    n_edge: int

    @property
    def e_pad(self) -> int:
        return int(self.senders.shape[0])

    def to_device(self, device=None) -> "GraphTensor":
        device = resolve_device(device)
        return GraphTensor(
            senders=torch.as_tensor(self.senders.astype(np.int64),
                                    device=device),
            receivers=torch.as_tensor(self.receivers.astype(np.int64),
                                      device=device),
            edge_mask=torch.as_tensor(self.edge_mask, device=device),
            edge_weight=torch.as_tensor(self.edge_weight, device=device),
            n_node=self.n_node,
            n_edge=self.n_edge,
        )


@dataclasses.dataclass(frozen=True)
class GraphTensor:
    """A statically padded graph on a device.

    Attributes:
      senders:    int64[E_pad]  source node of each edge (padded with n_node).
      receivers:  int64[E_pad]  destination node, sorted ascending.
      edge_mask:  bool[E_pad]   True for real edges.
      edge_weight: float32[E_pad] per-edge scalar weight; 0 on padding.
      n_node / n_edge: real counts, before padding.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    edge_mask: torch.Tensor
    edge_weight: torch.Tensor
    n_node: int
    n_edge: int

    @property
    def e_pad(self) -> int:
        return int(self.senders.shape[0])


def build_host_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_node: int,
    edge_weight: Optional[np.ndarray] = None,
    *,
    add_self_loops: bool = False,
    symmetric_norm: bool = False,
    edge_pad_multiple: int = 512,
) -> HostGraph:
    """Build a sorted, padded :class:`HostGraph` from COO arrays."""
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    if add_self_loops:
        loop = np.arange(n_node, dtype=np.int32)
        senders = np.concatenate([senders, loop])
        receivers = np.concatenate([receivers, loop])
        edge_weight = None if edge_weight is None else np.concatenate(
            [np.asarray(edge_weight, np.float32), np.ones(n_node, np.float32)]
        )
    n_edge = int(senders.shape[0])

    order = np.argsort(receivers, kind="stable")
    senders, receivers = senders[order], receivers[order]
    if edge_weight is not None:
        edge_weight = np.asarray(edge_weight, np.float32)[order]

    if symmetric_norm:
        deg = np.bincount(receivers, minlength=n_node).astype(np.float64)
        out_deg = np.bincount(senders, minlength=n_node).astype(np.float64)
        inv = 1.0 / np.sqrt(np.maximum(deg[receivers] * out_deg[senders], 1.0))
        edge_weight = inv.astype(np.float32)
    if edge_weight is None:
        edge_weight = np.ones(n_edge, np.float32)

    e_pad = max(_round_up(n_edge, edge_pad_multiple), edge_pad_multiple)
    pad = e_pad - n_edge
    senders = np.concatenate([senders, np.full(pad, n_node, np.int32)])
    receivers = np.concatenate([receivers, np.full(pad, n_node, np.int32)])
    mask = np.concatenate([np.ones(n_edge, bool), np.zeros(pad, bool)])
    edge_weight = np.concatenate([edge_weight, np.zeros(pad, np.float32)])

    return HostGraph(senders=senders, receivers=receivers, edge_mask=mask,
                     edge_weight=edge_weight, n_node=n_node, n_edge=n_edge)


# dense blocks per unit of dense-kernel work (see DenseBlockGraph.segments)
DENSE_SEGMENT = 8
# dense blocks per unit of K2's bf16 work (see DenseBlockGraph.wide_segments)
DENSE_WIDE_SEGMENT = 16


def _block_segments(rb_sorted: torch.Tensor, n_row_blocks: int,
                    seg_len: int) -> torch.Tensor:
    """int32[S, 3] (row block, first, end): each row block's run of
    ``rb_sorted`` (row blocks, ascending) cut into pieces of at most
    ``seg_len``; row blocks without an entry get none."""
    dev = rb_sorted.device
    bounds = torch.arange(n_row_blocks + 1, device=dev)
    ptr = torch.searchsorted(rb_sorted.contiguous(), bounds)
    count = ptr[1:] - ptr[:-1]
    n_seg = (count + seg_len - 1) // seg_len
    seg_rb = torch.repeat_interleave(torch.arange(n_row_blocks, device=dev),
                                     n_seg)
    first_seg = torch.cumsum(n_seg, 0) - n_seg
    j = torch.arange(int(n_seg.sum()), device=dev) - first_seg[seg_rb]
    k0 = ptr[seg_rb] + seg_len * j
    k1 = torch.minimum(k0 + seg_len, ptr[seg_rb + 1])
    return torch.stack([seg_rb, k0, k1], 1).to(torch.int32).contiguous()


@dataclasses.dataclass(frozen=True)
class TiledGraph:
    """Block-sparse edge tiling (see the JAX ``graph.TiledGraph``).

    Attributes (T = number of tiles, ET = ``tile_edges``):
      tile_rb:  int32[T]  row-block index of each tile, ascending.
      tile_cb:  int32[T]  col-block index; -1 marks a dead tile.
      src_local: int16[T, ET]  sender - cb*block_cols (pad: block_cols)
      dst_local: int16[T, ET]  receiver - rb*block_rows (pad: block_rows)
      edge_id:  int32[T, ET]  index into the edge arrays (pad: e_pad - 1)
      weight:   float32 or bfloat16 [T, ET]  per-edge weight, 0 on padding
      row_first_tile: int32[RB+1]  first tile of each row block.
    """

    tile_rb: torch.Tensor
    tile_cb: torch.Tensor
    src_local: torch.Tensor
    dst_local: torch.Tensor
    edge_id: torch.Tensor
    weight: torch.Tensor
    row_first_tile: torch.Tensor
    block_rows: int
    block_cols: int
    tile_edges: int
    n_node: int
    n_row_blocks: int
    n_col_blocks: int

    @property
    def n_tiles(self) -> int:
        return int(self.tile_rb.shape[0])


def _tile_arrays(g: HostGraph, block_rows: int, block_cols: int,
                 tile_edges: int, unit_weight: bool):
    """numpy tile arrays, exactly as the JAX builder emits them."""
    senders = g.senders[: g.n_edge]
    receivers = g.receivers[: g.n_edge]
    weight = (np.ones(g.n_edge, np.float32) if unit_weight
              else g.edge_weight[: g.n_edge])
    n = g.n_node
    rb = receivers // block_rows
    cb = senders // block_cols
    n_row_blocks = max(_round_up(n, block_rows) // block_rows, 1)
    n_col_blocks = max(_round_up(n, block_cols) // block_cols, 1)

    # sort edges by (row block, col block); each edge's tile and slot follow
    # from its offset within its (rb, cb) run
    key = rb.astype(np.int64) * n_col_blocks + cb
    order = np.argsort(key, kind="stable")
    senders, receivers, weight, key = (
        senders[order], receivers[order], weight[order], key[order])
    edge_ids = np.arange(g.n_edge, dtype=np.int32)[order]
    ne = len(key)
    if ne:
        starts = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
        run_len = np.diff(np.concatenate([starts, [ne]]))
        run_keys = key[starts]
        tiles_per_run = -(-run_len // tile_edges)
        tile_base = np.concatenate([[0], np.cumsum(tiles_per_run)[:-1]])
        run_of_edge = np.searchsorted(starts, np.arange(ne), side="right") - 1
        offset = np.arange(ne) - starts[run_of_edge]
        tile_of_edge = tile_base[run_of_edge] + offset // tile_edges
        slot = (offset % tile_edges).astype(np.int64)
        T_data = int(tiles_per_run.sum())
        data_rb = np.repeat((run_keys // n_col_blocks).astype(np.int32),
                            tiles_per_run)
        data_cb = np.repeat((run_keys % n_col_blocks).astype(np.int32),
                            tiles_per_run)
    else:
        T_data = 0
        tile_of_edge = slot = np.zeros(0, np.int64)
        data_rb = data_cb = np.zeros(0, np.int32)

    pad_eid = max(g.e_pad - 1, 0)
    src_l = np.full((T_data, tile_edges), block_cols, np.int32)
    dst_l = np.full((T_data, tile_edges), block_rows, np.int32)
    eid = np.full((T_data, tile_edges), pad_eid, np.int32)
    w = np.zeros((T_data, tile_edges), np.float32)
    if ne:
        src_l[tile_of_edge, slot] = senders - data_cb[tile_of_edge] * block_cols
        dst_l[tile_of_edge, slot] = receivers - data_rb[tile_of_edge] * block_rows
        eid[tile_of_edge, slot] = edge_ids
        w[tile_of_edge, slot] = weight

    # every row block owns >= 1 tile, so kernels write every output stripe
    missing = np.setdiff1d(np.arange(n_row_blocks, dtype=np.int32),
                           np.unique(data_rb))
    tile_rb, tile_cb = data_rb, data_cb
    if len(missing):
        m = len(missing)
        src_l = np.concatenate(
            [src_l, np.full((m, tile_edges), block_cols, np.int32)])
        dst_l = np.concatenate(
            [dst_l, np.full((m, tile_edges), block_rows, np.int32)])
        eid = np.concatenate([eid, np.full((m, tile_edges), pad_eid, np.int32)])
        w = np.concatenate([w, np.zeros((m, tile_edges), np.float32)])
        tile_rb = np.concatenate([data_rb, missing])
        tile_cb = np.concatenate([data_cb, np.zeros(m, np.int32)])
        torder = np.argsort(tile_rb, kind="stable")
        tile_rb, tile_cb = tile_rb[torder], tile_cb[torder]
        src_l, dst_l, eid, w = src_l[torder], dst_l[torder], eid[torder], w[torder]
    row_first = np.searchsorted(tile_rb, np.arange(n_row_blocks + 1)
                                ).astype(np.int32)
    return dict(tile_rb=tile_rb, tile_cb=tile_cb, src_local=src_l,
                dst_local=dst_l, edge_id=eid, weight=w,
                row_first_tile=row_first, n_row_blocks=n_row_blocks,
                n_col_blocks=n_col_blocks)


def tile_graph(
    g: HostGraph,
    *,
    block_rows: int = 256,
    block_cols: int = 256,
    tile_edges: int = 512,
    unit_weight: bool = False,
    device=None,
) -> TiledGraph:
    """Host-side tiling of a :class:`HostGraph` into block-sparse edge tiles
    on ``device``.  Local offsets are int16 (blocks below 32k rows/cols);
    ``unit_weight`` tilings store their 0/1 weights in bfloat16, as the JAX
    builder does (both values are exact)."""
    device = resolve_device(device)
    a = _tile_arrays(g, block_rows, block_cols, tile_edges, unit_weight)
    idt = torch.int16 if max(block_rows, block_cols) < 32000 else torch.int32

    def dev(v, dtype=None):
        return torch.as_tensor(v, device=device, dtype=dtype)

    return TiledGraph(
        tile_rb=dev(a["tile_rb"]),
        tile_cb=dev(a["tile_cb"]),
        src_local=dev(a["src_local"]).to(idt),
        dst_local=dev(a["dst_local"]).to(idt),
        edge_id=dev(a["edge_id"]),
        weight=dev(a["weight"]).to(torch.bfloat16 if unit_weight
                                   else torch.float32),
        row_first_tile=dev(a["row_first_tile"]),
        block_rows=block_rows,
        block_cols=block_cols,
        tile_edges=tile_edges,
        n_node=g.n_node,
        n_row_blocks=a["n_row_blocks"],
        n_col_blocks=a["n_col_blocks"],
    )


@dataclasses.dataclass(frozen=True)
class GroupedTiledGraph:
    """Stripe-group chunked edge tiling (see the JAX
    ``graph.GroupedTiledGraph``), the sparse tail of the bench's Reddit
    recipes.

    Row blocks form stripe groups of ``group`` consecutive row blocks.  A
    chunk is ``group`` sub-tiles sharing one (stripe group, col block):
    sub-tile j holds edges of row block ``grp * group + j``.  A block with
    more than ``tile_edges`` edges spills into level-k chunks of the same
    (grp, cb); every chunk carries the deepest level of its group, so
    skewed blocks pad their neighbours.  Within a sub-tile the live slots
    are a prefix (slot = offset of the edge in its block, mod ET).

    Attributes (NC = number of chunks, G = group, ET = tile_edges):
      chunk_grp: int32[NC]  stripe group, ascending
      chunk_cb:  int32[NC]  col block
      src_local: int16[NC, G, ET]  sender - cb*C   (pad: block_cols)
      dst_local: int16[NC, G, ET]  receiver - rb*R (pad: block_rows)
      edge_id:   int32[NC, G, ET]  index into the edge arrays (pad: e_pad-1)
      weight:    float32[NC, G, ET]  per-edge weight, 0 on padding
      grp_first_chunk: first chunk of each stripe group, [n_groups + 1]
      weight_all_unit: every REAL edge weighs exactly 1.0 (taken from the
        edges, not the slots, whose padding is 0), so kernels may skip the
        weight stream.
      live_sub: int32[n_live] flat indices ``c * G + j`` of the sub-tiles
        that hold an edge, ascending, derived once at construction from
        each sub-tile's slot 0 (its live slots are a prefix): K9's work
        list, so no warp is spent on an empty sub-tile.
    """

    chunk_grp: torch.Tensor
    chunk_cb: torch.Tensor
    src_local: torch.Tensor
    dst_local: torch.Tensor
    edge_id: torch.Tensor
    weight: torch.Tensor
    block_rows: int
    block_cols: int
    tile_edges: int
    group: int
    n_node: int
    n_groups: int
    n_col_blocks: int
    grp_first_chunk: Tuple[int, ...]
    weight_all_unit: bool = False
    live_sub: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        s0 = self.src_local[:, :, 0]
        d0 = self.dst_local[:, :, 0]
        real = ((s0 >= 0) & (s0 < self.block_cols) & (d0 >= 0)
                & (d0 < self.block_rows))
        object.__setattr__(self, "live_sub", torch.nonzero(
            real.reshape(-1)).reshape(-1).to(torch.int32))

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_grp.shape[0])

    @property
    def n_tiles(self) -> int:
        return self.n_chunks * self.group

    @property
    def total_slots(self) -> int:
        return self.n_tiles * self.tile_edges


def tile_graph_grouped(
    g: HostGraph,
    *,
    block_rows: int = 512,
    block_cols: int = 512,
    tile_edges: int = 128,
    group: int = 8,
    unit_weight: bool = False,
    device=None,
) -> GroupedTiledGraph:
    """Host-side grouped tiling on ``device``, the arrays of the JAX
    ``tile_graph_grouped``: edges keyed by (stripe group, col block, row
    block); each (rb, cb) run cut into level-k tiles of ``tile_edges``;
    the level-k tiles of one (grp, cb) form chunk (grp, cb, k) at sub-tile
    ``rb % group``; chunks in (grp, cb, level) order; a chunk of padding
    for every stripe group that has no edge."""
    device = resolve_device(device)
    ne = g.n_edge
    s = g.senders[:ne]
    r = g.receivers[:ne]
    w = np.ones(ne, np.float32) if unit_weight else g.edge_weight[:ne]
    nrb = max(_round_up(g.n_node, block_rows) // block_rows, 1)
    ncb = max(_round_up(g.n_node, block_cols) // block_cols, 1)
    n_groups = max(-(-nrb // group), 1)
    ET, G = tile_edges, group

    rb = (r // block_rows).astype(np.int64)
    cb = (s // block_cols).astype(np.int64)
    key = ((rb // G) * ncb + cb) * G + rb % G
    order = np.argsort(key, kind="stable")
    ks = key[order]
    if ne:
        starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
        run_len = np.diff(np.concatenate([starts, [ne]]))
        run_key = ks[starts]
        run_grpcb = run_key // G
        run_levels = -(-run_len // ET)
        gc_start = np.flatnonzero(np.concatenate(
            [[True], run_grpcb[1:] != run_grpcb[:-1]]))
        gc_of_run = np.searchsorted(gc_start, np.arange(len(run_key)),
                                    side="right") - 1
        gc_levels = np.maximum.reduceat(run_levels, gc_start)
        chunk_base = np.concatenate([[0], np.cumsum(gc_levels)[:-1]])
        nc_data = int(gc_levels.sum())
        gc_key = run_grpcb[gc_start]
        chunk_grp = np.repeat((gc_key // ncb).astype(np.int32), gc_levels)
        chunk_cb = np.repeat((gc_key % ncb).astype(np.int32), gc_levels)
        run_of_edge = np.searchsorted(starts, np.arange(ne),
                                      side="right") - 1
        offset = np.arange(ne) - starts[run_of_edge]
        chunk_of_edge = chunk_base[gc_of_run[run_of_edge]] + offset // ET
        j_of_edge = run_key[run_of_edge] % G
        slot = offset % ET
    else:
        nc_data = 0
        chunk_grp = chunk_cb = np.zeros(0, np.int32)

    missing = np.setdiff1d(np.arange(n_groups, dtype=np.int32),
                           np.unique(chunk_grp))
    nc = nc_data + len(missing)
    src_l = np.full((nc, G, ET), block_cols, np.int32)
    dst_l = np.full((nc, G, ET), block_rows, np.int32)
    eid = np.full((nc, G, ET), max(g.e_pad - 1, 0), np.int32)
    wv = np.zeros((nc, G, ET), np.float32)
    if ne:
        at = (chunk_of_edge, j_of_edge, slot)
        src_l[at] = s[order] - chunk_cb[chunk_of_edge].astype(np.int64) \
            * block_cols
        dst_l[at] = r[order] % block_rows
        eid[at] = np.arange(ne, dtype=np.int32)[order]
        wv[at] = w[order]
    if len(missing):
        chunk_grp = np.concatenate([chunk_grp, missing])
        chunk_cb = np.concatenate([chunk_cb, np.zeros(len(missing), np.int32)])
        corder = np.argsort(chunk_grp, kind="stable")
        chunk_grp, chunk_cb = chunk_grp[corder], chunk_cb[corder]
        src_l, dst_l, eid, wv = (src_l[corder], dst_l[corder], eid[corder],
                                 wv[corder])
    grp_first = np.searchsorted(chunk_grp, np.arange(n_groups + 1))
    idt = torch.int16 if max(block_rows, block_cols) < 32000 else torch.int32

    def dev(v, dtype=None):
        return torch.as_tensor(np.asarray(v, dtype), device=device)

    return GroupedTiledGraph(
        chunk_grp=dev(chunk_grp), chunk_cb=dev(chunk_cb),
        src_local=dev(src_l, np.int16 if idt == torch.int16 else np.int32),
        dst_local=dev(dst_l, np.int16 if idt == torch.int16 else np.int32),
        edge_id=dev(eid), weight=dev(wv),
        block_rows=block_rows, block_cols=block_cols, tile_edges=ET,
        group=G, n_node=g.n_node, n_groups=n_groups, n_col_blocks=ncb,
        grp_first_chunk=tuple(int(v) for v in grp_first),
        weight_all_unit=bool(ne == 0 or np.all(w == 1.0)))


@dataclasses.dataclass(frozen=True)
class DenseBlockGraph:
    """Dense adjacency blocks of the density split (see the JAX
    ``graph.DenseBlockGraph``).

    Attributes (B = number of dense blocks):
      blk_rb, blk_cb: int32[B]  block coordinates
      values: int8, float32 or bfloat16 [B, R, C] ('rc') or [B, C, R] ('cr')
      row_mask: bool[n_row_blocks]  True where any dense block writes
      supergroup: 0 = rb-major order; G > 0 = (rb//G, cb, rb) order.
      row_blocks: int32[B]  block ids sorted by row block (stable), derived
        once at construction, so the dense kernels accept any block order.
      segments: int32[S, 3] (row block, first, end) into ``row_blocks``:
        each row block's blocks cut into runs of at most ``DENSE_SEGMENT``,
        one CUDA block's work, so hub row blocks with hundreds of dense
        blocks spread over the card.
      wide_segments: the same cut into runs of at most
        ``DENSE_WIDE_SEGMENT``: the work of K2's bf16 path, whose CUDA
        block owns a whole 256-row stripe and adds it into the output once
        per run.
    """

    blk_rb: torch.Tensor
    blk_cb: torch.Tensor
    values: torch.Tensor
    row_mask: torch.Tensor
    block_rows: int
    block_cols: int
    n_node: int
    n_row_blocks: int
    n_col_blocks: int
    supergroup: int = 0
    values_layout: str = "rc"
    row_blocks: torch.Tensor = dataclasses.field(init=False, repr=False)
    segments: torch.Tensor = dataclasses.field(init=False, repr=False)
    wide_segments: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        rb = self.blk_rb.to(torch.int64)
        order = torch.argsort(rb, stable=True)
        object.__setattr__(self, "row_blocks", order.to(torch.int32))
        for name, seg_len in (("segments", DENSE_SEGMENT),
                              ("wide_segments", DENSE_WIDE_SEGMENT)):
            object.__setattr__(self, name, _block_segments(
                rb[order], self.n_row_blocks, seg_len))

    @property
    def n_blocks(self) -> int:
        return int(self.blk_rb.shape[0])


@dataclasses.dataclass(frozen=True)
class HybridGraph:
    """Density-split graph: dense blocks plus the sparse remainder as edge
    tiles (per-tile or grouped).  ``dense`` is None when no block passes
    the threshold.  ``row_scale`` / ``col_scale`` recover separable edge
    weights for integral (count) dense blocks: w_e = row_scale[r] *
    col_scale[s]."""

    dense: Optional[DenseBlockGraph]
    tiles: Union[TiledGraph, GroupedTiledGraph]
    n_dense_edges: int
    n_sparse_edges: int
    row_scale: Optional[torch.Tensor] = None
    col_scale: Optional[torch.Tensor] = None


def block_nnz(g: HostGraph, block_rows: int, block_cols: int) -> np.ndarray:
    """nnz per (row_block, col_block) adjacency block, shape [RB, CB]."""
    s = g.senders[: g.n_edge]
    r = g.receivers[: g.n_edge]
    rbn = max(_round_up(g.n_node, block_rows) // block_rows, 1)
    cbn = max(_round_up(g.n_node, block_cols) // block_cols, 1)
    key = (r // block_rows).astype(np.int64) * cbn + (s // block_cols)
    return np.bincount(key, minlength=rbn * cbn).reshape(rbn, cbn)


def hybrid_graph(
    g: HostGraph,
    *,
    block_rows: int = 256,
    block_cols: int = 256,
    tile_edges: int = 512,
    min_nnz: int,
    unit_weight: bool = False,
    supergroup: int = 0,
    values_dtype=np.float32,
    sparse_block_rows: Optional[int] = None,
    sparse_block_cols: Optional[int] = None,
    block_layout: str = "rc",
    tile_classes: Optional[Sequence[int]] = None,
    tail_format: str = "tiles",
    tail_group: int = 16,
    device=None,
) -> HybridGraph:
    """Split the adjacency by per-block density (see the JAX
    ``graph.hybrid_graph``): blocks with ``nnz >= min_nnz`` become dense
    value matrices, the rest stays edge-tiled.  ``values_dtype`` is
    ``np.float32`` (summed weights) or an integer type (edge counts; copies
    of one pair beyond the type's maximum merge into one tail slot whose
    weight is their summed weight).  ``tail_format="grouped"`` tiles the
    remainder as a :class:`GroupedTiledGraph` of ``tail_group`` sub-tiles
    per chunk; tile classes (``MultiTiledGraph``) are not ported and
    raise."""
    if tail_format not in ("tiles", "grouped"):
        raise ValueError(f"bad tail_format {tail_format!r}")
    if tile_classes and tail_format != "grouped":
        raise NotImplementedError(
            "tile classes (MultiTiledGraph) are not ported yet "
            "(ROADMAP.md Queue 1 item 9)")
    if block_layout not in ("rc", "cr"):
        raise ValueError(f"bad block_layout {block_layout!r}")
    vdt = np.dtype(values_dtype)
    integral_vals = np.issubdtype(vdt, np.integer)
    if not integral_vals and vdt != np.float32:
        raise NotImplementedError(
            f"dense values dtype {vdt}: the port stores float32 or integer "
            "counts")
    s = g.senders[: g.n_edge]
    r = g.receivers[: g.n_edge]
    w = (np.ones(g.n_edge, np.float32) if unit_weight
         else g.edge_weight[: g.n_edge])
    wd = np.ones(g.n_edge, np.float32) if integral_vals else w

    device = resolve_device(device)
    sbr = sparse_block_rows or block_rows
    sbc = sparse_block_cols or block_cols

    def tail(hg: HostGraph, unit: bool):
        if tail_format == "grouped":
            return tile_graph_grouped(
                hg, block_rows=sbr, block_cols=sbc, tile_edges=tile_edges,
                group=tail_group, unit_weight=unit, device=device)
        return tile_graph(hg, block_rows=sbr, block_cols=sbc,
                          tile_edges=tile_edges, unit_weight=unit,
                          device=device)

    nnz = block_nnz(g, block_rows, block_cols)
    rbn, cbn = nnz.shape
    dense_mask2d = (nnz >= max(min_nnz, 1) if min_nnz > 0
                    else np.zeros_like(nnz, bool))
    dense_ids = np.flatnonzero(dense_mask2d.reshape(-1))      # rb-major

    if len(dense_ids) == 0:
        tiles = tail(g, unit_weight)
        return HybridGraph(dense=None, tiles=tiles, n_dense_edges=0,
                           n_sparse_edges=g.n_edge)

    d_rb = (dense_ids // cbn).astype(np.int64)
    d_cb = (dense_ids % cbn).astype(np.int64)
    if supergroup > 0:
        order = np.lexsort((d_rb, d_cb, d_rb // supergroup))
        dense_ids, d_rb, d_cb = dense_ids[order], d_rb[order], d_cb[order]

    key = (r // block_rows).astype(np.int64) * cbn + (s // block_cols)
    slot_of = np.full(rbn * cbn, -1, np.int64)
    slot_of[dense_ids] = np.arange(len(dense_ids))
    e_slot = slot_of[key]
    in_dense = e_slot >= 0

    rest_extra_drop = None
    w_rest = w
    if integral_vals and in_dense.any():
        # saturation guard: a count cell holds at most the dtype max; the
        # excess copies of a pair leave the dense block and merge into ONE
        # tail edge carrying their summed weight (both SpMM and attention
        # are linear in per-pair multiplicity)
        cap = int(np.iinfo(vdt).max)
        keys = r[in_dense].astype(np.int64) * (g.n_node + 1) + s[in_dense]
        korder = np.argsort(keys, kind="stable")
        ks = keys[korder]
        new_grp = np.concatenate([[True], ks[1:] != ks[:-1]])
        grp_start = np.flatnonzero(new_grp)
        sizes = np.diff(np.concatenate([grp_start, [len(ks)]]))
        if sizes.max(initial=0) > cap:
            occ = np.arange(len(ks)) - np.repeat(grp_start, sizes)
            idx_dense = np.flatnonzero(in_dense)
            evict_local = korder[occ >= cap]
            in_dense[idx_dense[evict_local]] = False
            e_slot = np.where(in_dense, e_slot, -1)
            over = np.flatnonzero(sizes > cap)
            lens = sizes[over] - cap
            starts = grp_start[over] + cap
            pos = (np.repeat(starts, lens) + np.arange(int(lens.sum()))
                   - np.repeat(np.cumsum(lens) - lens, lens))
            eids = idx_dense[korder[pos]]
            gidx = np.repeat(np.arange(len(over)), lens)
            wsum = np.bincount(gidx, weights=w[eids].astype(np.float64))
            resid = idx_dense[korder[starts]]
            w_rest = w.copy()
            w_rest[resid] = wsum.astype(np.float32)
            drop = np.zeros(g.n_edge, bool)
            drop[eids] = True
            drop[resid] = False
            rest_extra_drop = drop

    blk_shape = ((block_rows, block_cols) if block_layout == "rc"
                 else (block_cols, block_rows))
    i_r = r[in_dense] % block_rows
    i_c = s[in_dense] % block_cols
    if block_layout == "cr":
        i_r, i_c = i_c, i_r
    B = len(dense_ids)
    if vdt == np.float32:
        values = np.zeros((B,) + blk_shape, np.float32)
        np.add.at(values, (e_slot[in_dense], i_r, i_c), wd[in_dense])
    else:
        # accumulate f32 in chunks of blocks, cast per chunk
        values = np.zeros((B,) + blk_shape, vdt)
        es, rs, cs, ws = e_slot[in_dense], i_r, i_c, wd[in_dense]
        eorder = np.argsort(es, kind="stable")
        es, rs, cs, ws = es[eorder], rs[eorder], cs[eorder], ws[eorder]
        CH = max(1, (256 * 2**20) // (block_rows * block_cols * 4))
        starts = np.searchsorted(es, np.arange(0, B + CH, CH))
        for i, b0 in enumerate(range(0, B, CH)):
            nb = min(CH, B - b0)
            buf = np.zeros((nb,) + blk_shape, np.float32)
            lo, hi = starts[i], starts[i + 1]
            np.add.at(buf, (es[lo:hi] - b0, rs[lo:hi], cs[lo:hi]), ws[lo:hi])
            values[b0:b0 + nb] = buf.astype(vdt)

    row_mask = np.zeros(rbn, bool)
    row_mask[d_rb] = True
    dense = DenseBlockGraph(
        blk_rb=torch.as_tensor(d_rb.astype(np.int32), device=device),
        blk_cb=torch.as_tensor(d_cb.astype(np.int32), device=device),
        values=torch.as_tensor(values, device=device),
        row_mask=torch.as_tensor(row_mask, device=device),
        block_rows=block_rows,
        block_cols=block_cols,
        n_node=g.n_node,
        n_row_blocks=rbn,
        n_col_blocks=cbn,
        supergroup=int(supergroup),
        values_layout=block_layout,
    )

    rest_keep = ~in_dense
    if rest_extra_drop is not None:
        rest_keep &= ~rest_extra_drop
    n_rest = int(rest_keep.sum())
    pad = g.e_pad - n_rest
    rest = HostGraph(
        senders=np.concatenate([s[rest_keep],
                                np.full(pad, g.n_node, np.int32)]),
        receivers=np.concatenate([r[rest_keep],
                                  np.full(pad, g.n_node, np.int32)]),
        edge_mask=np.concatenate([np.ones(n_rest, bool), np.zeros(pad, bool)]),
        edge_weight=np.concatenate([w_rest[rest_keep],
                                    np.zeros(pad, np.float32)]),
        n_node=g.n_node,
        n_edge=n_rest,
    )
    # rest.edge_weight already carries the requested weights, and merged
    # multi-edge slots their copy counts
    tiles = tail(rest, False)
    return HybridGraph(dense=dense, tiles=tiles,
                       n_dense_edges=int(in_dense.sum()),
                       n_sparse_edges=g.n_edge - int(in_dense.sum()))


def transpose_host_graph(g: HostGraph) -> Tuple[HostGraph, np.ndarray]:
    """The transposed graph Aᵀ (senders and receivers swapped, weights
    kept, edges sorted by their new receiver) and ``perm``: edge i of the
    transposed graph is edge ``perm[i]`` of ``g`` (pad edges map to the
    last pad slot).  The backward of y = A x is dx = Aᵀ ȳ, the same
    kernels over the transposed graph's tilings."""
    ne = g.n_edge
    pad = g.e_pad - ne
    order = np.argsort(g.senders[:ne], kind="stable")
    gt = HostGraph(
        senders=np.concatenate([g.receivers[:ne][order],
                                np.full(pad, g.n_node, np.int32)]),
        receivers=np.concatenate([g.senders[:ne][order],
                                  np.full(pad, g.n_node, np.int32)]),
        edge_mask=np.concatenate([np.ones(ne, bool), np.zeros(pad, bool)]),
        edge_weight=np.concatenate([g.edge_weight[:ne][order],
                                    np.zeros(pad, np.float32)]),
        n_node=g.n_node,
        n_edge=ne,
    )
    perm = np.concatenate([order.astype(np.int64),
                           np.full(pad, max(g.e_pad - 1, 0), np.int64)])
    return gt, perm


def separable_weight_scales(g: HostGraph
                            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(row_scale, col_scale) with ``w_e == row_scale[r] * col_scale[s]``
    when the edge weights are the symmetric normalisation, else None."""
    ne = g.n_edge
    if ne == 0:
        return None
    s = g.senders[:ne]
    r = g.receivers[:ne]
    w = g.edge_weight[:ne]
    deg_in = np.bincount(r, minlength=g.n_node)[: g.n_node]
    deg_out = np.bincount(s, minlength=g.n_node)[: g.n_node]
    rs = (1.0 / np.sqrt(np.maximum(deg_in, 1))).astype(np.float32)
    cs = (1.0 / np.sqrt(np.maximum(deg_out, 1))).astype(np.float32)
    if np.allclose(w, rs[r] * cs[s], rtol=1e-5, atol=1e-7):
        return rs, cs
    return None


def reorder_nodes(g: HostGraph, method: str = "degree", labels=None,
                  perm=None):
    """Relabel nodes to densify adjacency blocks; returns (HostGraph, perm)
    with perm[new_id] = old_id (apply ``x[perm]`` to node features).

    ``degree``: degree-descending.  ``labels``: grouped by cluster label,
    degree-descending within.  ``hubs+labels``: the top 2% by degree first,
    then label-grouped.  ``none`` and ``perm`` (caller-supplied) too; the
    label-propagation ``cluster`` method is not ported yet."""
    s = g.senders[: g.n_edge]
    r = g.receivers[: g.n_edge]
    deg = np.bincount(r, minlength=g.n_node) + np.bincount(
        s, minlength=g.n_node)
    if method == "degree":
        perm = np.argsort(-deg, kind="stable").astype(np.int64)
    elif method in ("labels", "hubs+labels"):
        if labels is None or len(labels) != g.n_node:
            raise ValueError(f"{method!r} needs one label per node")
        key_group = np.asarray(labels)
        if method == "hubs+labels":
            k = max(int(g.n_node * 0.02), 1)
            cut = np.sort(deg)[::-1][k - 1]
            key_group = np.where(deg >= max(cut, 1), -1, key_group)
        perm = np.lexsort((-deg, key_group)).astype(np.int64)
    elif method == "none":
        perm = np.arange(g.n_node, dtype=np.int64)
    elif method == "perm":
        if perm is None or len(perm) != g.n_node:
            raise ValueError("'perm' needs a permutation of the nodes")
        perm = np.asarray(perm, np.int64)
    elif method == "cluster":
        raise NotImplementedError(
            "label-propagation clustering is not ported yet "
            "(ROADMAP.md Queue 1 item 2)")
    else:
        raise ValueError(f"unknown reorder method {method!r}")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(g.n_node)
    out = build_host_graph(
        inv[s].astype(np.int32), inv[r].astype(np.int32), g.n_node,
        edge_weight=g.edge_weight[: g.n_edge],
        edge_pad_multiple=g.e_pad,
    )
    return out, perm
