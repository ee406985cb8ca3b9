"""Graph partition with a static halo-exchange plan (host side, numpy).

Counterpart of the JAX package's ``parallel/partition.py``; the arrays
equal its arrays value for value.  The scheme is the 1-D vertex
partition with halo (ghost) vertices over D ranks of a process group:

  * the node space is padded to D * n_local; rank d owns
    [d*n_local, (d+1)*n_local);
  * every edge lives on the rank that owns its receiver, so a gather is a
    local segment reduction;
  * edges split into a local set (sender owned by the same rank) and a
    remote set: local-edge work reads only x_local, so it runs while the
    halo collectives are in flight;
  * hub senders (the largest rank-spread, at most hub_cap per rank) are
    replicated by one all-gather instead of a slot in every destination's
    halo;
  * the other remote senders of each (p -> q) pair form the halo, padded
    to one width H, so the exchange is one equal-split all-to-all of
    [D, H, F];
  * remote sender ids index the combined table
    ``concat([halo (D*H rows), hubs (D*hub_cap rows), zero dump row])``.

:meth:`PartitionedGraph.shard` puts one rank's ``[1, ...]`` slice of every
array on a device as torch tensors, the per-rank view that
``parallel/dist.py`` reads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph import _as_host, _round_up


def _shard_of(part, d: int, device):
    """``part`` with every array field replaced by its ``[d:d+1]`` slice as
    a torch tensor on ``device`` (int32 ids widen to int64).  The local
    and remote edge arrays keep only rank d's edges, a prefix of each
    row: the padding up to the widest shard (JAX's one program for every
    device) would add nothing but send every padding edge to the dump
    row, where its atomics collide."""
    live = {"el_": int(part.el_mask[d].sum()),
            "er_": int(part.er_mask[d].sum())}
    out = {}
    for f in dataclasses.fields(part):
        v = getattr(part, f.name)
        if isinstance(v, np.ndarray):
            v = v[d:d + 1]
            if f.name[:3] in live:
                v = v[:, :live[f.name[:3]]]
            # a copy: ``part`` may map its arrays from files, read-only
            a = np.array(v, dtype=np.int64 if v.dtype == np.int32
                         else v.dtype)
            v = torch.as_tensor(a, device=device)
        out[f.name] = v
    return dataclasses.replace(part, **out)


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Static per-rank graph arrays, leading axis D (the group's size).
    ``shard(d, device)`` is rank d's view: the same fields as [1, ...]
    torch tensors."""

    send_idx: np.ndarray    # int32[D, D, H]   local rows p ships to q
    send_mask: np.ndarray   # bool [D, D, H]
    hub_idx: np.ndarray     # int32[D, Kh]     local rows p contributes to
    hub_mask: np.ndarray    # bool [D, Kh]     the all-gathered hub table
    el_src: np.ndarray      # int32[D, EL]  LOCAL edges: local sender row
    el_dst: np.ndarray      # int32[D, EL]  local receiver (n_local = dump)
    el_w: np.ndarray        # f32  [D, EL]
    el_mask: np.ndarray     # bool [D, EL]
    er_src: np.ndarray      # int32[D, ER]  REMOTE edges: combined-table row
    er_dst: np.ndarray      # int32[D, ER]
    er_w: np.ndarray        # f32  [D, ER]
    er_mask: np.ndarray     # bool [D, ER]
    n_local: int
    halo: int
    hub_cap: int
    n_shards: int
    n_node: int
    n_edge: int
    n_local_edges: int = 0

    @property
    def e_local(self) -> int:
        return int(self.el_src.shape[1])

    @property
    def e_remote(self) -> int:
        return int(self.er_src.shape[1])

    @property
    def n_pad(self) -> int:
        return self.n_local * self.n_shards

    def comm_report(self, feat_width: int, dtype_bytes: int = 2) -> dict:
        """Per-layer exchange volume of this plan (bytes on the wire)."""
        D, H, Kh = self.n_shards, self.halo, self.hub_cap
        return dict(
            halo_bytes=D * D * H * feat_width * dtype_bytes,
            hub_bytes=D * Kh * (D - 1) * feat_width * dtype_bytes,
            halo_width=H,
            hub_cap=Kh,
            local_edges_frac=(self.n_local_edges / self.n_edge
                              if self.n_edge else 0.0),
        )

    def shard(self, d: int, device) -> "PartitionedGraph":
        """Rank ``d``'s ``[1, ...]`` slice of every array, as torch tensors
        on ``device``."""
        return _shard_of(self, d, device)


def _hubs(senders, owner_r, remote, n_node: int, D: int, hub_frac: float):
    """Hub senders: the largest shard-spread among remote senders (at
    least two destination shards), at most ``n_node * hub_frac``."""
    if hub_frac > 0 and remote.any():
        pair = np.unique(senders[remote].astype(np.int64) * D
                         + owner_r[remote])
        spread = np.bincount((pair // D).astype(np.int64), minlength=n_node)
        n_hub = max(int(n_node * hub_frac), 1)
        cand = np.argsort(-spread, kind="stable")[:n_hub]
        return cand[spread[cand] >= 2]
    return np.zeros(0, np.int64)


def _hub_bucket(hubs, n_node: int, n_local: int, D: int,
                halo_pad_multiple: int):
    """(Kh, hub_idx, hub_mask, hub_row): each shard's hub rows in the
    all-gathered bucket and each hub's row of it."""
    hub_owner = (hubs // n_local).astype(np.int64)
    Kh = int(np.bincount(hub_owner, minlength=D).max()) if len(hubs) else 0
    Kh = _round_up(max(Kh, 1), halo_pad_multiple) if len(hubs) else 0
    hub_idx = np.zeros((D, max(Kh, 1)), np.int32)
    hub_mask = np.zeros((D, max(Kh, 1)), bool)
    hub_row = np.full(n_node, -1, np.int64)   # global sender -> bucket row
    if len(hubs):
        horder = np.argsort(hub_owner, kind="stable")
        hsort, hown = hubs[horder], hub_owner[horder]
        starts = np.searchsorted(hown, np.arange(D))
        slot = np.arange(len(hsort)) - starts[hown]
        hub_idx[hown, slot] = (hsort - hown * n_local).astype(np.int32)
        hub_mask[hown, slot] = True
        hub_row[hsort] = hown * Kh + slot
    return Kh, hub_idx, hub_mask, hub_row


def _slots(keys):
    """(slot within its group, widest group) of sorted ``keys`` grouped by
    equal value."""
    if not len(keys):
        return np.zeros(0, np.int64), 1
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    lens = np.diff(np.concatenate([starts, [len(keys)]]))
    grp = np.searchsorted(starts, np.arange(len(keys)), side="right") - 1
    return np.arange(len(keys)) - starts[grp], int(lens.max())


def _edge_arrays(senders, receivers, weight, owner_r, sel, rows, n_local,
                 D, E, pad_src):
    """[D, E] (src, dst, w, mask) of the selected edges, each on its
    receiver's shard in edge order; ``rows`` are the selected edges'
    source rows."""
    ro, wo, oo = receivers[sel], weight[sel], owner_r[sel]
    eorder = np.argsort(oo, kind="stable")
    ro, wo, oo = ro[eorder], wo[eorder], oo[eorder]
    rows = rows[eorder]
    shard_start = np.searchsorted(oo, np.arange(D))
    slot = np.arange(len(oo)) - shard_start[oo]
    e_src = np.full((D, E), pad_src, np.int32)
    e_dst = np.full((D, E), n_local, np.int32)
    e_w = np.zeros((D, E), np.float32)
    e_mask = np.zeros((D, E), bool)
    e_src[oo, slot] = rows.astype(np.int32)
    e_dst[oo, slot] = (ro - oo * n_local).astype(np.int32)
    e_w[oo, slot] = wo
    e_mask[oo, slot] = True
    return e_src, e_dst, e_w, e_mask


def _edge_widths(owner_r, local, remote, D: int, edge_pad_multiple: int):
    counts_l = np.bincount(owner_r[local], minlength=D)
    counts_r = np.bincount(owner_r[remote], minlength=D)
    EL = max(_round_up(int(counts_l.max()) if local.any() else 1,
                       edge_pad_multiple), edge_pad_multiple)
    ER = max(_round_up(int(counts_r.max()) if remote.any() else 1,
                       edge_pad_multiple), edge_pad_multiple)
    return EL, ER


def partition_graph(
    g,
    n_shards: int,
    *,
    edge_pad_multiple: int = 128,
    halo_pad_multiple: int = 8,
    hub_frac: float = 1 / 256,
) -> PartitionedGraph:
    """Host-side partition of a HostGraph (or a GraphTensor, read back)
    into ``n_shards`` halo shards.  ``hub_frac``: senders in the top
    ``hub_frac`` of remote spread are replicated through the all-gathered
    hub bucket (0 disables)."""
    g = _as_host(g)
    senders = g.senders[: g.n_edge]
    receivers = g.receivers[: g.n_edge]
    weight = g.edge_weight[: g.n_edge]
    D = n_shards
    n_local = _round_up(g.n_node, D * 8) // D

    owner_s = (senders // n_local).astype(np.int64)
    owner_r = (receivers // n_local).astype(np.int64)
    local = owner_s == owner_r
    remote = ~local

    hubs = _hubs(senders, owner_r, remote, g.n_node, D, hub_frac)
    is_hub = np.zeros(g.n_node, bool)
    is_hub[hubs] = True
    Kh, hub_idx, hub_mask, hub_row = _hub_bucket(
        hubs, g.n_node, n_local, D, halo_pad_multiple)

    # halo plan: unique non-hub remote senders per (p, q) pair
    halo_e = remote & ~is_hub[senders]
    pair_key = owner_s[halo_e] * D + owner_r[halo_e]
    uniq = np.unique(pair_key * (n_local * D) + senders[halo_e])
    u_pair = uniq // (n_local * D)
    u_node = (uniq % (n_local * D)).astype(np.int64)
    u_slot, H = _slots(u_pair)
    H = _round_up(H, halo_pad_multiple)

    send_idx = np.zeros((D, D, H), np.int32)
    send_mask = np.zeros((D, D, H), bool)
    u_p = (u_pair // D).astype(np.int64)
    u_q = (u_pair % D).astype(np.int64)
    send_idx[u_p, u_q, u_slot] = (u_node - u_p * n_local).astype(np.int32)
    send_mask[u_p, u_q, u_slot] = True

    # combined remote table: [halo (D*H) | hubs (D*Kh) | dump]
    dump_row = D * H + D * max(Kh, 1)
    halo_row = np.full((D, g.n_node), dump_row, np.int64)
    halo_row[u_q, u_node] = u_p * H + u_slot
    if len(hubs):
        halo_row[:, hubs] = (D * H + hub_row[hubs])[None, :]

    src_local_rows = (senders - owner_s * n_local).astype(np.int64)
    EL, ER = _edge_widths(owner_r, local, remote, D, edge_pad_multiple)
    el = _edge_arrays(senders, receivers, weight, owner_r, local,
                      src_local_rows[local], n_local, D, EL, n_local)
    er = _edge_arrays(senders, receivers, weight, owner_r, remote,
                      halo_row[owner_r[remote], senders[remote]], n_local,
                      D, ER, dump_row)

    return PartitionedGraph(
        send_idx=send_idx, send_mask=send_mask,
        hub_idx=hub_idx, hub_mask=hub_mask,
        el_src=el[0], el_dst=el[1], el_w=el[2], el_mask=el[3],
        er_src=er[0], er_dst=er[1], er_w=er[2], er_mask=er[3],
        n_local=n_local, halo=H, hub_cap=max(Kh, 1), n_shards=D,
        n_node=g.n_node, n_edge=g.n_edge, n_local_edges=int(local.sum()))


def community_partition_order(g, labels, n_shards: int, *,
                              balance: str = "edges"):
    """Node permutation (perm[new_id] = old_id) that makes contiguous-range
    shards community shards: whole communities (``labels``) packed
    greedily, heaviest first, onto the least-loaded shard under the
    n_local node capacity (``balance="edges"`` loads shards by receiver
    edge count, ``"nodes"`` by node count); shards over their target then
    shed their lowest-degree nodes to the under-full ones.  Within a
    shard, the degree head first, then label groups, each degree-
    descending.  Returns ``(perm, shard_of_community)``."""
    g = _as_host(g)
    labels = np.asarray(labels)
    if len(labels) != g.n_node:
        raise ValueError(f"{len(labels)} labels for {g.n_node} nodes")
    D = n_shards
    n_local = _round_up(g.n_node, D * 8) // D

    r = g.receivers[: g.n_edge]
    s = g.senders[: g.n_edge]
    deg = np.bincount(r, minlength=g.n_node) + np.bincount(
        s, minlength=g.n_node)

    k = int(labels.max()) + 1
    com_nodes = np.bincount(labels, minlength=k)
    com_load = (np.bincount(labels[r], minlength=k).astype(np.float64)
                if balance == "edges" else com_nodes.astype(np.float64))

    order = np.argsort(-com_load, kind="stable")
    shard_load = np.zeros(D, np.float64)
    shard_room = np.full(D, n_local, np.int64)
    shard_of = np.full(k, -1, np.int64)
    for c in order:
        if com_nodes[c] == 0:
            shard_of[c] = 0
            continue
        fits = shard_room >= com_nodes[c]
        if not fits.any():
            # capacity forces a split: the roomiest shard takes it and its
            # overflow spills in the repair below
            d = int(np.argmax(shard_room))
        else:
            d = int(np.argmin(np.where(fits, shard_load, np.inf)))
        shard_of[c] = d
        shard_room[d] -= com_nodes[c]
        shard_load[d] += com_load[c]

    # contiguous-range ownership forces every shard but the last to hold
    # exactly n_local nodes
    node_shard = shard_of[labels]
    target = np.full(D, n_local, np.int64)
    target[D - 1] = g.n_node - (D - 1) * n_local
    if target[D - 1] < 0:
        raise ValueError(f"{g.n_node} nodes leave shard {D - 1} empty")
    counts = np.bincount(node_shard, minlength=D)
    pool = []
    for d in np.where(counts > target)[0]:
        excess = int(counts[d] - target[d])
        members = np.flatnonzero(node_shard == d)
        pool.append(members[np.argsort(deg[members], kind="stable")[:excess]])
        counts[d] = target[d]
    if pool:
        pool = np.concatenate(pool)
        fill = np.repeat(np.arange(D), np.maximum(target - counts, 0))
        node_shard[pool] = fill

    kk = max(int(g.n_node * 0.02), 1)
    cut = np.sort(deg)[::-1][kk - 1]
    group = np.where(deg >= max(cut, 1), -1, labels)
    perm = np.lexsort((-deg, group, node_shard)).astype(np.int64)
    return perm, shard_of


def pad_nodes(arr: np.ndarray, part) -> np.ndarray:
    """Pad a [n_node, ...] host array to the partitioned node space
    [D*n_local, ...]."""
    pad = part.n_pad - arr.shape[0]
    if pad < 0:
        raise ValueError("array longer than padded node space")
    return np.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1))
