"""Hierarchical (hosts x cards) partition with per-axis collectives.

Counterpart of the JAX package's ``parallel/mesh2d.py``; the arrays equal
its arrays value for value.  On several hosts the 1-D plan ships a
boundary row once per destination rank, across the slow inter-node
network whenever the pair crosses hosts.  The hierarchical plan
deduplicates the cross-host traffic at host granularity:

  * intra-host halo: per same-host (p -> q) pair, unique senders: one
    all-to-all over the card axis (NVLink);
  * inter-host halo: per (rank -> destination host) unique senders: a row
    needed by several cards of host j crosses the network once: one
    all-to-all over the host axis (card c of host i with card c of host
    j), then one all-gather over the card axis inside the destination
    host;
  * hubs: one all-gather over every rank.

Rank (host i, card c) = i * d_chip + c.  Its remote-source table is

    [ intra (Dc*Hin) | inter (Dc*Dh*Hout, sender-card-major) |
      hubs (D*Kh) | zero dump row ]

and ``er_src`` indexes it, so ``parallel/dist.py``'s compute is the 1-D
one; only :func:`~.dist.remote_table` dispatches on the partition type.
The axes are process subgroups (:class:`Mesh2D`, from ``dist.new_group``)
where JAX names mesh axes.

With ``quantize=True`` the int8 payload and its per-row scales travel
through both hops of the inter-host path and are dequantized once (the
JAX package quantizes the rows again before the card-axis all-gather).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph import _as_host, _round_up
from .partition import (_edge_arrays, _edge_widths, _hub_bucket, _hubs,
                        _shard_of, _slots)

HOST_AXIS = "host"
CHIP_AXIS = "chip"


@dataclasses.dataclass(frozen=True)
class PartitionedGraph2D:
    """Static per-rank arrays of the hierarchical plan, leading axis D =
    Dh*Dc (host-major rank order)."""

    send_in_idx: np.ndarray    # int32[D, Dc, Hin]  intra-host halo sends
    send_in_mask: np.ndarray   # bool [D, Dc, Hin]
    send_out_idx: np.ndarray   # int32[D, Dh, Hout] deduped per-host sends
    send_out_mask: np.ndarray  # bool [D, Dh, Hout]
    hub_idx: np.ndarray        # int32[D, Kh]
    hub_mask: np.ndarray       # bool [D, Kh]
    el_src: np.ndarray         # int32[D, EL]
    el_dst: np.ndarray
    el_w: np.ndarray
    el_mask: np.ndarray
    er_src: np.ndarray         # int32[D, ER] rows of the 2-D table
    er_dst: np.ndarray
    er_w: np.ndarray
    er_mask: np.ndarray
    n_local: int
    d_host: int
    d_chip: int
    halo_in: int
    halo_out: int
    hub_cap: int
    n_node: int
    n_edge: int
    n_local_edges: int = 0

    @property
    def n_shards(self) -> int:
        return self.d_host * self.d_chip

    @property
    def n_pad(self) -> int:
        return self.n_local * self.n_shards

    def comm_report(self, feat_width: int, dtype_bytes: int = 2) -> dict:
        """Exchange bytes per layer by network: ``ici_bytes`` inside the
        hosts (the intra-host all-to-all, the card-axis redistribution and
        the hubs' intra-host legs), ``dcn_bytes`` across them (the
        host-axis all-to-all and the hubs' cross-host legs); the key names
        are the JAX package's."""
        Dh, Dc, D = self.d_host, self.d_chip, self.n_shards
        f = feat_width * dtype_bytes
        ici = (D * Dc * self.halo_in * f
               + D * Dh * self.halo_out * (Dc - 1) * f
               + D * self.hub_cap * (Dc - 1) * f)
        dcn = (D * (Dh - 1) * self.halo_out * f
               + D * self.hub_cap * (D - Dc) * f)
        return dict(
            ici_bytes=int(ici), dcn_bytes=int(dcn),
            halo_in=self.halo_in, halo_out=self.halo_out,
            hub_cap=self.hub_cap,
            local_edges_frac=(self.n_local_edges / self.n_edge
                              if self.n_edge else 0.0),
        )

    def shard(self, d: int, device) -> "PartitionedGraph2D":
        """Rank ``d``'s ``[1, ...]`` slice of every array, as torch tensors
        on ``device``."""
        return _shard_of(self, d, device)


def partition_graph_2d(
    g,
    d_host: int,
    d_chip: int,
    *,
    edge_pad_multiple: int = 128,
    halo_pad_multiple: int = 8,
    hub_frac: float = 1 / 256,
) -> PartitionedGraph2D:
    """Host-side hierarchical partition into ``d_host * d_chip`` shards
    (host-major: shard = host * d_chip + chip)."""
    g = _as_host(g)
    senders = g.senders[: g.n_edge]
    receivers = g.receivers[: g.n_edge]
    weight = g.edge_weight[: g.n_edge]
    Dh, Dc = d_host, d_chip
    D = Dh * Dc
    n_local = _round_up(g.n_node, D * 8) // D

    owner_s = (senders // n_local).astype(np.int64)
    owner_r = (receivers // n_local).astype(np.int64)
    host_s = owner_s // Dc
    host_r = owner_r // Dc
    local = owner_s == owner_r
    remote = ~local

    hubs = _hubs(senders, owner_r, remote, g.n_node, D, hub_frac)
    is_hub = np.zeros(g.n_node, bool)
    is_hub[hubs] = True
    Kh, hub_idx, hub_mask, hub_row = _hub_bucket(
        hubs, g.n_node, n_local, D, halo_pad_multiple)

    halo_e = remote & ~is_hub[senders]
    same_host = host_s == host_r

    # intra-host halo: unique senders per same-host (p -> q)
    sel_in = halo_e & same_host
    key_in = np.unique((owner_s[sel_in] * D + owner_r[sel_in])
                       * (n_local * np.int64(D)) + senders[sel_in])
    in_pair = key_in // (n_local * D)
    in_node = (key_in % (n_local * D)).astype(np.int64)
    in_slot, Hin = _slots(in_pair)
    Hin = _round_up(Hin, halo_pad_multiple)
    send_in_idx = np.zeros((D, Dc, Hin), np.int32)
    send_in_mask = np.zeros((D, Dc, Hin), bool)
    in_p = (in_pair // D).astype(np.int64)
    in_q = (in_pair % D).astype(np.int64)
    send_in_idx[in_p, in_q % Dc, in_slot] = (
        in_node - in_p * n_local).astype(np.int32)
    send_in_mask[in_p, in_q % Dc, in_slot] = True

    # inter-host halo: unique senders per (shard -> destination host)
    sel_out = halo_e & ~same_host
    key_out = np.unique((owner_s[sel_out] * Dh + host_r[sel_out])
                        * (n_local * np.int64(D)) + senders[sel_out])
    out_pair = key_out // (n_local * D)
    out_node = (key_out % (n_local * D)).astype(np.int64)
    out_slot, Hout = _slots(out_pair)
    Hout = _round_up(Hout, halo_pad_multiple)
    send_out_idx = np.zeros((D, Dh, Hout), np.int32)
    send_out_mask = np.zeros((D, Dh, Hout), bool)
    out_p = (out_pair // Dh).astype(np.int64)
    out_j = (out_pair % Dh).astype(np.int64)
    send_out_idx[out_p, out_j, out_slot] = (
        out_node - out_p * n_local).astype(np.int32)
    send_out_mask[out_p, out_j, out_slot] = True

    # table rows per (receiver shard, sender node)
    inter_base = Dc * Hin
    hub_base = inter_base + Dc * Dh * Hout
    dump_row = hub_base + D * max(Kh, 1)
    table_row = np.full((D, g.n_node), dump_row, np.int64)
    table_row[in_q, in_node] = (in_p % Dc) * Hin + in_slot
    if len(key_out):
        # every card of the destination host: sender (i, cp) slot k ->
        # inter_base + cp*(Dh*Hout) + i*Hout + k (card-major all-gather)
        row = (inter_base + (out_p % Dc) * (Dh * Hout)
               + (out_p // Dc) * Hout + out_slot)
        for cq in range(Dc):
            table_row[out_j * Dc + cq, out_node] = row
    if len(hubs):
        table_row[:, hubs] = hub_base + hub_row[hubs][None, :]

    src_local_rows = (senders - owner_s * n_local).astype(np.int64)
    EL, ER = _edge_widths(owner_r, local, remote, D, edge_pad_multiple)
    el = _edge_arrays(senders, receivers, weight, owner_r, local,
                      src_local_rows[local], n_local, D, EL, n_local)
    er = _edge_arrays(senders, receivers, weight, owner_r, remote,
                      table_row[owner_r[remote], senders[remote]], n_local,
                      D, ER, dump_row)

    return PartitionedGraph2D(
        send_in_idx=send_in_idx, send_in_mask=send_in_mask,
        send_out_idx=send_out_idx, send_out_mask=send_out_mask,
        hub_idx=hub_idx, hub_mask=hub_mask,
        el_src=el[0], el_dst=el[1], el_w=el[2], el_mask=el[3],
        er_src=er[0], er_dst=er[1], er_w=er[2], er_mask=er[3],
        n_local=n_local, d_host=Dh, d_chip=Dc, halo_in=Hin, halo_out=Hout,
        hub_cap=max(Kh, 1), n_node=g.n_node, n_edge=g.n_edge,
        n_local_edges=int(local.sum()))


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """The calling rank's process subgroups of a (d_host x d_chip) mesh
    over the world (host-major ranks): ``chip`` holds the ranks of its
    host, ``host`` the ranks of its card index on every host, ``all`` the
    world.  Build with :func:`make_mesh2d` on every rank."""

    d_host: int
    d_chip: int
    all: object
    chip: object
    host: object


def make_mesh2d(d_host: int, d_chip: int) -> Mesh2D:
    """Create the chip-axis and host-axis subgroups of the world; every
    rank calls this with the same arguments, since ``dist.new_group`` is
    collective."""
    import torch.distributed as dist
    D = dist.get_world_size()
    if D != d_host * d_chip:
        raise ValueError(f"a {d_host} x {d_chip} mesh needs {d_host * d_chip}"
                         f" ranks; the world has {D}")
    me = dist.get_rank()
    backend = dist.get_backend()
    chip = host = None
    for i in range(d_host):
        g = dist.new_group([i * d_chip + c for c in range(d_chip)],
                           backend=backend)
        if me // d_chip == i:
            chip = g
    for c in range(d_chip):
        g = dist.new_group([i * d_chip + c for i in range(d_host)],
                           backend=backend)
        if me % d_chip == c:
            host = g
    return Mesh2D(d_host, d_chip, dist.group.WORLD, chip, host)


def remote_table_2d(x_local: torch.Tensor, sh: PartitionedGraph2D,
                    mesh: Mesh2D, quantize: bool = False) -> torch.Tensor:
    """The hierarchical exchange: intra-host all-to-all, host-axis
    all-to-all then card-axis all-gather (one network crossing per row),
    hub all-gather; differentiable in ``x_local``."""
    from .dist import remote_table
    return remote_table(x_local, sh, mesh, quantize=quantize)
