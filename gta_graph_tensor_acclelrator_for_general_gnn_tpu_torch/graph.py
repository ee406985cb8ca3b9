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
* :class:`MultiTiledGraph` — per-run tile capacity classes: one
  :class:`TiledGraph` per class, whose kernel partials add.
* :class:`DenseBlockGraph` / :class:`HybridGraph` — the density split:
  dense adjacency blocks plus the sparse remainder as edge tiles.
* :func:`dense_adjacency` — the full dense adjacency of a graph of at most
  ``DENSEFULL_MAX_N`` nodes (the densefull path's operand).

Where the native host library builds (``native/``), the receiver sort
and degrees of :func:`build_host_graph`, the tiling of :func:`tile_graph`
and the label propagation of :func:`cluster_labels` run in C++, exactly
where the JAX builders call it; the numpy formulations remain as the
fallback and give identical arrays (label propagation excepted: the
native sweeps are asynchronous, the numpy ones synchronous).

Every entry point that places tensors takes ``device=None``, which means
the CUDA card (:func:`resolve_device`); the CPU is used only when asked
for.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .utils.spans import spanned


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

    @spanned("graph.to_device")
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


def _as_host(g) -> HostGraph:
    """:class:`HostGraph` view of either graph type: a host graph as it is,
    a :class:`GraphTensor` read back from its device (int32 indices, as
    :func:`build_host_graph` makes them)."""
    if isinstance(g, HostGraph):
        return g
    return HostGraph(
        senders=g.senders.cpu().numpy().astype(np.int32),
        receivers=g.receivers.cpu().numpy().astype(np.int32),
        edge_mask=g.edge_mask.cpu().numpy(),
        edge_weight=g.edge_weight.cpu().numpy(),
        n_node=g.n_node,
        n_edge=g.n_edge,
    )


@spanned("graph.build_host_graph")
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

    from . import native
    order = (native.sort_by_receiver_native(receivers, n_node)
             if native.HAVE_NATIVE else None)
    if order is None:
        order = np.argsort(receivers, kind="stable")
    senders, receivers = senders[order], receivers[order]
    if edge_weight is not None:
        edge_weight = np.asarray(edge_weight, np.float32)[order]

    if symmetric_norm:
        degs = (native.degrees_native(senders, receivers, n_node)
                if native.HAVE_NATIVE else None)
        if degs is not None:
            out_deg, deg = degs
        else:
            deg = np.bincount(receivers, minlength=n_node).astype(np.float64)
            out_deg = np.bincount(senders, minlength=n_node).astype(
                np.float64)
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


def build_graph(*args, device=None, **kwargs) -> GraphTensor:
    """Device variant of :func:`build_host_graph` (same arguments), on
    ``device`` (default the CUDA card)."""
    return build_host_graph(*args, **kwargs).to_device(device)


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
      work_lists: work lists derived from the tiling on first use, by
        key (``ops.pairagg.pair_work``: K13's receiver chunks), so a
        tiling no kernel walks that way never builds one.
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
    work_lists: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)

    @property
    def n_tiles(self) -> int:
        return int(self.tile_rb.shape[0])

    @property
    def total_slots(self) -> int:
        return self.n_tiles * self.tile_edges


def _tile_arrays(g: HostGraph, block_rows: int, block_cols: int,
                 tile_edges: int, unit_weight: bool):
    """The tile arrays (numpy), exactly as the JAX builder emits them:
    the data tiles from the native tiler or its numpy formulation, then
    one empty tile for each row block without an edge."""
    senders = g.senders[: g.n_edge]
    receivers = g.receivers[: g.n_edge]
    weight = (np.ones(g.n_edge, np.float32) if unit_weight
              else g.edge_weight[: g.n_edge])
    n = g.n_node
    rb = receivers // block_rows
    cb = senders // block_cols
    n_row_blocks = max(_round_up(n, block_rows) // block_rows, 1)
    n_col_blocks = max(_round_up(n, block_cols) // block_cols, 1)

    from . import native
    nat = native.tile_edges_native(
        senders, receivers, weight, n_row_blocks, n_col_blocks,
        block_rows, block_cols, tile_edges, g.e_pad) \
        if native.HAVE_NATIVE else None
    if nat is not None:
        data_rb, data_cb, src_l, dst_l, eid, w = nat
    else:
        data_rb, data_cb, src_l, dst_l, eid, w = _tile_arrays_numpy(
            senders, receivers, weight, rb, cb, n_col_blocks, block_rows,
            block_cols, tile_edges, g.e_pad)

    # every row block owns >= 1 tile, so kernels write every output stripe
    missing = np.setdiff1d(np.arange(n_row_blocks, dtype=np.int32),
                           np.unique(data_rb))
    tile_rb, tile_cb = data_rb, data_cb
    pad_eid = max(g.e_pad - 1, 0)
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


def _tile_arrays_numpy(senders, receivers, weight, rb, cb, n_col_blocks,
                       block_rows, block_cols, tile_edges, e_pad):
    """The data tiles (row-block sorted) in numpy: what
    ``native.tile_edges_native`` returns, array for array."""
    # sort edges by (row block, col block); each edge's tile and slot follow
    # from its offset within its (rb, cb) run
    key = rb.astype(np.int64) * n_col_blocks + cb
    order = np.argsort(key, kind="stable")
    senders, receivers, weight, key = (
        senders[order], receivers[order], weight[order], key[order])
    edge_ids = np.arange(len(key), dtype=np.int32)[order]
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

    src_l = np.full((T_data, tile_edges), block_cols, np.int32)
    dst_l = np.full((T_data, tile_edges), block_rows, np.int32)
    eid = np.full((T_data, tile_edges), max(e_pad - 1, 0), np.int32)
    w = np.zeros((T_data, tile_edges), np.float32)
    if ne:
        src_l[tile_of_edge, slot] = senders - data_cb[tile_of_edge] * block_cols
        dst_l[tile_of_edge, slot] = receivers - data_rb[tile_of_edge] * block_rows
        eid[tile_of_edge, slot] = edge_ids
        w[tile_of_edge, slot] = weight
    return data_rb, data_cb, src_l, dst_l, eid, w


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
class MultiTiledGraph:
    """Edge tiling with per-run capacity classes (see the JAX
    ``graph.MultiTiledGraph``): each (rb, cb) run is packed at the tile
    capacity that minimises its modelled kernel time, and the runs of one
    class share one :class:`TiledGraph` (``parts``, one per class that won
    a run, ascending capacity).  All parts share the block geometry and
    ``n_node``; their ``edge_id`` index the parent graph's edges, so
    per-class kernel outputs add and per-edge values reach every part."""

    parts: Tuple[TiledGraph, ...]

    @property
    def n_node(self) -> int:
        return self.parts[0].n_node

    @property
    def n_tiles(self) -> int:
        return sum(p.n_tiles for p in self.parts)

    @property
    def total_slots(self) -> int:
        return sum(p.n_tiles * p.tile_edges for p in self.parts)


# The tile-time model below is the JAX package's, and its defaults are the
# JAX package's constants, fitted to its TPU kernels: with them both
# packages pick the same geometry and capacities.  Its constants are
# keywords, so that ``compiler/latency.py`` prices the port's kernels with
# the card's own fit (``compiler/latency_fit.py``).


def grid_ramp_ns(n_runs: int, n_tiles: float, feat_width: int = 128, *,
                 run_ns: float = 700.0, tile_ns: float = 120.0,
                 call_ns: float = 0.0) -> float:
    """Short-grid ramp of :func:`tile_time_model_ns`: a per-call cost per
    run (``run_ns``, scaled by the feature width up to 128) and per tile
    (``tile_ns``) that fades hyperbolically with the tile count, so large
    grids keep the per-tile constant, plus ``call_ns`` once.  A per-call
    cost: chains of passes must not scale it."""
    per_run = run_ns * min(max(feat_width, 1), 128) / 128.0
    return ((n_runs * per_run + n_tiles * tile_ns) / (1.0 + n_tiles / 1024.0)
            + call_ns)


def tile_time_model_ns(run_nnz: np.ndarray, tile_edges: int,
                       block_rows: int, block_cols: int,
                       *, feat_width: int = 128, x_bytes: int = 2,
                       grid_const_ns: float = 314.0,
                       slot_ns: float = 2.77,
                       panel_gbps: float = 819.0,
                       surcharge_ns: float = 200.0,
                       edge_ns: float = 0.0,
                       edge_byte_ns: float = 0.0,
                       ramp_run_ns: float = 700.0,
                       ramp_tile_ns: float = 120.0,
                       call_ns: float = 0.0,
                       include_ramp: bool = True) -> float:
    """Modelled edge-tile kernel time for packing the (rb, cb) run-size
    distribution ``run_nnz`` at one tile capacity:

        time = runs * panel + tiles * (grid_const + max(0, compute - panel))
               + edges * (edge_ns + edge_byte_ns * F * x_bytes)
        panel = C * F * x_bytes / panel_gbps   (x column panel, once a run)
        compute = ET * slot_ns * (R + C) / 2048 * F / 128

    plus ``surcharge_ns`` per tile past 65,536 tiles and the short-grid
    ramp (:func:`grid_ramp_ns`).  ``edges`` are the live edges,
    ``run_nnz.sum()``: the port's kernels walk each tile's edge prefix, so
    the card's fit prices edges where the TPU's prices slots.  With the
    defaults (``edge_ns`` and ``edge_byte_ns`` 0) it chooses a capacity and
    a geometry as the JAX package does, and is not a time on the card."""
    panel = block_cols * feat_width * x_bytes / panel_gbps
    compute = tile_edges * slot_ns * (block_rows + block_cols) / 2048.0
    compute *= feat_width / 128.0
    tiles = np.ceil(run_nnz / tile_edges)
    per_tile = grid_const_ns + max(0.0, compute - panel)
    n_tiles = float(tiles.sum())
    if n_tiles > 65536:
        per_tile += surcharge_ns
    ramp = (grid_ramp_ns(len(run_nnz), n_tiles, feat_width,
                         run_ns=ramp_run_ns, tile_ns=ramp_tile_ns,
                         call_ns=call_ns)
            if include_ramp else 0.0)
    edges = float(run_nnz.sum()) * (edge_ns
                                     + edge_byte_ns * feat_width * x_bytes)
    return float(len(run_nnz) * panel + n_tiles * per_tile + ramp) + edges


def best_tile_capacity(run_nnz: np.ndarray, block_rows: int, block_cols: int,
                       *, candidates: Sequence[int] = tuple(
                           range(128, 1025, 128)),
                       feat_width: int = 128, x_bytes: int = 2) -> int:
    """The tile capacity among ``candidates`` that minimises
    :func:`tile_time_model_ns` for a run-size distribution (ties: the
    smaller)."""
    return min(candidates,
               key=lambda et: (tile_time_model_ns(
                   run_nnz, et, block_rows, block_cols,
                   feat_width=feat_width, x_bytes=x_bytes), et))


def run_nnz_hist(g: HostGraph, block_rows: int,
                 block_cols: int) -> np.ndarray:
    """nnz of each nonzero (rb, cb) adjacency block: the run-size
    distribution the capacity model reads."""
    ncb = max(_round_up(g.n_node, block_cols) // block_cols, 1)
    key = ((g.receivers[: g.n_edge] // block_rows).astype(np.int64) * ncb
           + g.senders[: g.n_edge] // block_cols)
    cnt = np.bincount(key)
    return cnt[cnt > 0]


def tile_graph_classes(
    g: HostGraph,
    *,
    block_rows: int = 1024,
    block_cols: int = 1024,
    tile_classes: Sequence[int] = (64, 128, 256, 512, 1024),
    unit_weight: bool = False,
    fixed_slots: int = 80,
    device=None,
) -> MultiTiledGraph:
    """Multi-capacity tiling on ``device`` (the arrays of the JAX
    ``tile_graph_classes``): each (rb, cb) run takes the class ET that
    minimises ``ceil(len / ET) * (ET * (R + C) / 2048 + fixed_slots)``
    (``fixed_slots``: the per-tile fixed cost in slots, the JAX package's
    fitted value); each class that wins a run tiles its edges as a
    :class:`TiledGraph` whose ``edge_id`` is remapped into the parent's
    edge space on the device (pad slots alias ``e_pad - 1``).  An edge-less
    graph keeps one empty part at the largest class.  ``unit_weight``
    parts store their weights in bfloat16, as a one-class unit-weight
    tiling does (both values exact)."""
    device = resolve_device(device)
    ne = g.n_edge
    s = g.senders[:ne]
    r = g.receivers[:ne]
    w = np.ones(ne, np.float32) if unit_weight else g.edge_weight[:ne]
    tile_classes = sorted(set(int(c) for c in tile_classes))
    ncb = max(_round_up(g.n_node, block_cols) // block_cols, 1)

    key = (r // block_rows).astype(np.int64) * ncb + (s // block_cols)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = (np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
              if ne else np.zeros(0, np.int64))
    run_len = np.diff(np.concatenate([starts, [ne]]))
    scale = (block_rows + block_cols) / 2048.0
    cost = np.stack([np.ceil(run_len / et) * (et * scale + fixed_slots)
                     for et in tile_classes], axis=0)
    choice = cost.argmin(axis=0) if ne else np.zeros(0, np.int64)
    edge_class = np.repeat(choice, run_len)        # aligned with `order`
    geo = dict(block_rows=block_rows, block_cols=block_cols,
               unit_weight=unit_weight, device=device)

    parts = []
    for ci, et in enumerate(tile_classes):
        eidx = order[edge_class == ci]             # parent edge ids
        k = len(eidx)
        if k == 0:
            continue
        sub_ep = max(_round_up(k, 128), 128)
        pad = sub_ep - k
        sub = HostGraph(
            senders=np.concatenate([s[eidx], np.full(pad, g.n_node,
                                                     np.int32)]),
            receivers=np.concatenate([r[eidx], np.full(pad, g.n_node,
                                                       np.int32)]),
            edge_mask=np.concatenate([np.ones(k, bool), np.zeros(pad, bool)]),
            edge_weight=np.concatenate([w[eidx], np.zeros(pad, np.float32)]),
            n_node=g.n_node, n_edge=k)
        tg = tile_graph(sub, tile_edges=et, **geo)
        remap = torch.as_tensor(np.concatenate(
            [eidx.astype(np.int32),
             np.full(pad, max(g.e_pad - 1, 0), np.int32)]), device=device)
        parts.append(dataclasses.replace(
            tg, edge_id=remap[tg.edge_id.long()].contiguous()))
    if not parts:
        parts = [tile_graph(g, tile_edges=tile_classes[-1], **geo)]
    return MultiTiledGraph(parts=tuple(parts))


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
    tiles: Union[TiledGraph, GroupedTiledGraph, MultiTiledGraph]
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
    ``np.float32`` (summed weights), ``torch.bfloat16`` (the same sums in
    float32, rounded once to bf16: half the bytes) or an integer type
    (edge counts; copies of one pair beyond the type's maximum merge into
    one tail slot whose weight is their summed weight).
    ``tail_format="grouped"`` tiles the remainder as a
    :class:`GroupedTiledGraph` of ``tail_group`` sub-tiles per chunk and
    takes precedence over ``tile_classes``, which tile it as a
    :class:`MultiTiledGraph` of those capacities."""
    if tail_format not in ("tiles", "grouped"):
        raise ValueError(f"bad tail_format {tail_format!r}")
    if block_layout not in ("rc", "cr"):
        raise ValueError(f"bad block_layout {block_layout!r}")
    bf16_vals = values_dtype is torch.bfloat16
    vdt = np.dtype(np.float32 if bf16_vals else values_dtype)
    integral_vals = np.issubdtype(vdt, np.integer)
    if not integral_vals and vdt != np.float32:
        raise NotImplementedError(
            f"dense values dtype {vdt}: the port stores float32, bfloat16 "
            "or integer counts")
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
        if tile_classes:
            return tile_graph_classes(
                hg, block_rows=sbr, block_cols=sbc,
                tile_classes=tile_classes, unit_weight=unit, device=device)
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
    if vdt == np.float32 and not bf16_vals:
        values = np.zeros((B,) + blk_shape, np.float32)
        np.add.at(values, (e_slot[in_dense], i_r, i_c), wd[in_dense])
    else:
        # accumulate f32 in chunks of blocks, cast per chunk
        values = (torch.zeros((B,) + blk_shape, dtype=torch.bfloat16)
                  if bf16_vals else np.zeros((B,) + blk_shape, vdt))
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
            values[b0:b0 + nb] = (torch.from_numpy(buf) if bf16_vals
                                  else buf.astype(vdt))

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


# full-densification cap (the JAX package's value): above this node count
# the densefull block runs op by op and the blocked paths take over
DENSEFULL_MAX_N = 65536
# rows of the dense adjacency held in float32 at a time (its build; the
# densefull product in float32 and its backward)
DENSE_ROWS = 8192


def dense_adjacency(g: HostGraph, *, weighted: bool = True,
                    pad_multiple: int = 256, dtype=torch.bfloat16,
                    device=None) -> torch.Tensor:
    """The full dense adjacency [N_pad, N_pad] (rows = receivers, cols =
    senders; summed edge weights, or multi-edge counts when unweighted) in
    ``dtype`` (bf16, as the JAX package's) on ``device`` (default the CUDA
    card): the medium-N regime's aggregation operand, one ``A @ x``.

    Built ``DENSE_ROWS`` rows at a time: each block's edges are summed into
    a float32 block on the device, in edge order (the JAX package's
    ``np.add.at``; on the CUDA card the adds of one cell's multi-edges
    reorder), and rounded once into the output.  The JAX package fills a
    float32 [N_pad, N_pad] host buffer first."""
    if g.n_node > DENSEFULL_MAX_N:
        raise ValueError(
            f"dense_adjacency at n={g.n_node} would need "
            f"{(g.n_node / 1024) ** 2 * 2 / 1024:.1f} GB (cap "
            f"DENSEFULL_MAX_N = {DENSEFULL_MAX_N}): use the hybrid path")
    device = resolve_device(device)
    n_pad = _round_up(g.n_node, pad_multiple)
    ne = g.n_edge
    r = g.receivers[:ne]
    order = np.argsort(r, kind="stable")
    r = r[order]
    s = g.senders[:ne][order]
    w = (g.edge_weight[:ne][order] if weighted
         else np.ones(ne, np.float32))
    a = torch.empty((n_pad, n_pad), dtype=dtype, device=device)
    for i0 in range(0, n_pad, DENSE_ROWS):
        i1 = min(i0 + DENSE_ROWS, n_pad)
        e0, e1 = np.searchsorted(r, [i0, i1])
        blk = torch.zeros((i1 - i0, n_pad), dtype=torch.float32,
                          device=device)
        idx = (torch.as_tensor(r[e0:e1].astype(np.int64) - i0, device=device),
               torch.as_tensor(s[e0:e1].astype(np.int64), device=device))
        blk.index_put_(idx, torch.as_tensor(w[e0:e1], device=device),
                       accumulate=True)
        a[i0:i1] = blk
    return a


def batch_host_graph(g: HostGraph, batch: int, *,
                     copy_stride: Optional[int] = None) -> HostGraph:
    """Block-diagonal batching of ``batch`` copies of one graph (the serving
    shape; the JAX ``graph.batch_host_graph``), each copy's node range
    padded to ``copy_stride`` (default: the next multiple of 1024).  With
    the stride a multiple of the block, no adjacency block straddles two
    copies, so the batched tiling keeps the one-copy tiling's fill.
    Features go in the padded layout of :func:`pad_batch_features`."""
    stride = copy_stride or _round_up(g.n_node, 1024)
    ne = g.n_edge
    off = np.arange(batch, dtype=np.int64)[:, None] * stride
    s = (g.senders[:ne][None, :] + off).reshape(-1)
    r = (g.receivers[:ne][None, :] + off).reshape(-1)
    w = np.tile(g.edge_weight[:ne], batch)
    n_tot = batch * stride
    e_tot = batch * ne
    e_pad = _round_up(e_tot, 512)
    return HostGraph(
        senders=np.concatenate(
            [s, np.full(e_pad - e_tot, n_tot, np.int64)]).astype(np.int32),
        receivers=np.concatenate(
            [r, np.full(e_pad - e_tot, n_tot, np.int64)]).astype(np.int32),
        edge_mask=np.concatenate(
            [np.ones(e_tot, bool), np.zeros(e_pad - e_tot, bool)]),
        edge_weight=np.concatenate(
            [w, np.zeros(e_pad - e_tot, np.float32)]).astype(np.float32),
        n_node=n_tot,
        n_edge=e_tot,
    )


def pad_batch_features(x: np.ndarray, batch: int, n_node: int,
                       copy_stride: Optional[int] = None) -> np.ndarray:
    """[batch, n_node, F] (or [batch * n_node, F]) features in the padded
    [batch * stride, F] layout that :func:`batch_host_graph` numbers."""
    stride = copy_stride or _round_up(n_node, 1024)
    x = np.asarray(x).reshape(batch, n_node, -1)
    out = np.zeros((batch, stride, x.shape[-1]), x.dtype)
    out[:, :n_node] = x
    return out.reshape(batch * stride, -1)


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


def _label_prop_numpy(row_ptr: np.ndarray, nbrs: np.ndarray, n: int,
                      max_iter: int) -> np.ndarray:
    """Vectorised label propagation, the numpy fallback of
    :func:`cluster_labels` (the JAX package's, step for step).

    Per sweep the winning neighbour label is computed for every node at
    once, but applied in two parity half-steps (even ids, then odd): the
    two-colour schedule breaks the synchronous-update oscillations that
    plain parallel LPA is prone to (label-swapping node pairs)."""
    labels = np.arange(n, dtype=np.int64)
    owner = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))

    def winners(lab):
        key = owner * n + lab[nbrs]
        uniq, cnt = np.unique(key, return_counts=True)
        own_u, lab_u = uniq // n, uniq % n
        # max count per owner, ties toward the smaller label id
        sel = np.lexsort((lab_u, -cnt, own_u))
        own_s = own_u[sel]
        first = np.concatenate([[True], own_s[1:] != own_s[:-1]])
        win = lab.copy()
        win[own_s[first]] = lab_u[sel][first]
        return win

    for _ in range(max_iter):
        changed = 0
        for parity in (0, 1):
            win = winners(labels)
            mask = (np.arange(n) % 2) == parity
            upd = mask & (win != labels)
            labels = np.where(upd, win, labels)
            changed += int(upd.sum())
        if changed * 1000 < n:
            break
    return labels


def cluster_labels(g: HostGraph, max_iter: int = 20, seed: int = 0
                   ) -> np.ndarray:
    """Community assignment by label propagation, from the graph alone (no
    ground-truth labels): the clustering pass a real graph takes before
    the hybrid density split, which earns its dense blocks from community
    locality.

    Native asynchronous sweeps (``native/cluster.cpp``: seeded visit
    order, deterministic) where the library builds, else the synchronous
    numpy sweeps of :func:`_label_prop_numpy`; the two give different
    labellings.  Returns compact int32 community ids in [0, k)."""
    from . import native

    s = g.senders[: g.n_edge].astype(np.int64)
    r = g.receivers[: g.n_edge].astype(np.int64)
    n = g.n_node
    keep = s != r  # self loops carry no community information
    u = np.concatenate([s[keep], r[keep]]).astype(np.int32)
    v = np.concatenate([r[keep], s[keep]]).astype(np.int32)
    lab = None
    if native.HAVE_NATIVE:
        order = native.sort_by_receiver_native(u, n)  # O(E) counting sort
    else:
        order = np.argsort(u, kind="stable")
    nbrs = v[order]
    deg = np.bincount(u, minlength=n)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    if native.HAVE_NATIVE:
        lab = native.label_prop_native(row_ptr, nbrs, n,
                                       max_iter=max_iter, seed=seed)
    if lab is None:
        lab = _label_prop_numpy(row_ptr, nbrs, n, max_iter)
    _, compact = np.unique(lab, return_inverse=True)
    return compact.astype(np.int32)


@spanned("graph.reorder_nodes")
def reorder_nodes(g: HostGraph, method: str = "degree", labels=None,
                  perm=None):
    """Relabel nodes to densify adjacency blocks; returns (HostGraph, perm)
    with perm[new_id] = old_id (apply ``x[perm]`` to node features).

    ``degree``: degree-descending.  ``labels``: grouped by cluster label,
    degree-descending within.  ``hubs+labels``: the top 2% by degree first,
    then label-grouped.  ``cluster``: ``hubs+labels`` over the communities
    that :func:`cluster_labels` finds (the label-free path of a real
    graph).  ``none`` and ``perm`` (caller-supplied) too."""
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
        return reorder_nodes(g, "hubs+labels", labels=cluster_labels(g))
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


def nnz_histogram(g: HostGraph, tile_rows: int) -> np.ndarray:
    """nnz per ``tile_rows``-row stripe of the adjacency (int64), the
    autotuner feature of the JAX package's preprocessing."""
    receivers = g.receivers[: g.n_edge]
    n_stripes = _round_up(g.n_node, tile_rows) // tile_rows
    return np.bincount(receivers // tile_rows,
                       minlength=n_stripes).astype(np.int64)
